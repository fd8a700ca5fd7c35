"""``python -m solex_ser_recon_en_torch.cli``."""

import sys

from .main import main

sys.exit(main())
