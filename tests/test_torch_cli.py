"""The PyTorch port's command line refuses the JAX CLI's unported long
options, and any unknown ``--name``, with exit code 2 (CPU).

Before, such a token fell into the packed single-letter flag parser:
``--mesh 8`` reached the ``h`` of "mesh" and exited 0 with nothing done,
``--feed host`` set ``-f``/``-d``.  Each case here runs a real scan that
would otherwise be processed, and checks that nothing is written.
"""

import pytest

from solex_ser_recon_en_torch.cli.flags import UNPORTED_LONG_OPTS
from solex_ser_recon_en_torch.cli.main import main as cli_main

VALUES = {"--mesh": "frame=8", "--feed": "host", "--input-dir": "scans",
          "--num-processes": "2", "--process-id": "1"}

CASES = (
    [(name, [name, value]) for name, value in VALUES.items()]
    + [(name, [f"{name}={value}"]) for name, value in VALUES.items()]
    + [("--profile", ["--profile"]), ("--profile", ["--profile=prof"]),
       ("--frobnicate", ["--frobnicate"]),
       ("--frobnicate", ["--frobnicate=3"])]
)


def test_every_jax_long_option_is_named():
    assert set(VALUES) | {"--profile"} == set(UNPORTED_LONG_OPTS)


@pytest.mark.parametrize("name,tokens", CASES,
                         ids=[" ".join(tok) for _, tok in CASES])
def test_unported_long_option_exits_2(basic_scan, tmp_path, capsys, name,
                                      tokens):
    out = tmp_path / "out"
    rc = cli_main([*tokens, "-cw0", basic_scan["path"], "--device", "cpu",
                   "--output-dir", str(out)])
    assert rc == 2
    said = capsys.readouterr().out
    assert "ERROR: " in said and name in said
    if name in UNPORTED_LONG_OPTS:
        assert "not ported" in said
    else:
        assert "unknown option" in said
    assert not out.exists() or not any(out.iterdir())
