"""``python -m solex_ser_recon_en_torch``: the ``shg-torch`` CLI
(cli/main.py), as ``python -m solex_ser_recon_en_torch.cli``."""

from .cli.main import main

raise SystemExit(main())
