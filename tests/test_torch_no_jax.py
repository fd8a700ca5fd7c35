"""The PyTorch port never imports jax: a fresh interpreter runs the ``-c``
slice on a tiny scan through the CLI on the CPU, the fused step
(``models.shg_forward``) and the resident-path benchmark
(``bench_device``), then checks sys.modules."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import torch
import solex_ser_recon_en_torch.bench_device as bench_device
import solex_ser_recon_en_torch.cli.main as cli
from solex_ser_recon_en_torch.models import example_inputs, shg_forward
from solex_ser_recon_en_tpu.io.synthetic import SyntheticScan

SyntheticScan(ih=128, iw=48, frames=100, depth=8, squash_y=1.1,
              line_poly=(24.0, 0.01, 0.0, 0.0), noise=0.002,
              seed=3).write("tiny.ser", transpose_to_wide=True)
rc = cli.main(["-cw0", "tiny.ser", "--device", "cpu"])
assert rc == 0, rc
out = shg_forward(*(torch.from_numpy(a) for a in example_inputs(F=8)))
assert out[2].shape == (2, 256, 8), out[2].shape
rc = bench_device.main(["tiny.ser", "--device", "cpu", "--output-dir", "dec"])
assert rc == 0, rc
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not leaked, leaked
print("NO_JAX_OK")
"""


def test_port_runs_without_importing_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SOLEX_NO_COMPILE_CACHE", None)  # the port must set it itself
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout
    assert (tmp_path / "tiny_shift=0_clahe.png").exists()
    assert (tmp_path / "dec" / "decomp_shift=0_clahe.png").exists()


def test_port_sources_have_no_jax_import():
    pkg = os.path.join(ROOT, "solex_ser_recon_en_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    s = line.strip()
                    assert not (s.startswith("import jax")
                                or s.startswith("from jax")), (name, s)
