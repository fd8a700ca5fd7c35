"""The PyTorch port imports neither jax nor the JAX package.

A fresh interpreter makes a tiny scan with the port's own synthetic-scan
generator, runs the ``-c`` slice through the CLI on the CPU, the fused step
(``models.shg_forward``, and ``shg_fused(..., mxu=True)``), the
resident-path benchmark (``bench_device``), the feed measurements
(``bench_feed``, which build and load the native host library) and the
kernel shoot-out (``bench_kernels``), then checks sys.modules.  The sources of the port, of
``chip_smoke.py``, ``chip_profile.py``, ``chip_ring_probe.py`` and of the
card tests (which run on a machine without jax) are checked for import
statements.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import torch
import solex_ser_recon_en_torch.bench_device as bench_device
import solex_ser_recon_en_torch.bench_feed as bench_feed
import solex_ser_recon_en_torch.bench_kernels as bench_kernels
import solex_ser_recon_en_torch.cli.main as cli
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.models import example_inputs, shg_forward
from solex_ser_recon_en_torch.ops.fused_cuda import shg_fused

SyntheticScan(ih=128, iw=48, frames=100, depth=8, squash_y=1.1,
              line_poly=(24.0, 0.01, 0.0, 0.0), noise=0.002,
              seed=3).write("tiny.ser", transpose_to_wide=True)
rc = cli.main(["-cw0", "tiny.ser", "--device", "cpu"])
assert rc == 0, rc
step = [torch.from_numpy(a) for a in example_inputs(F=8)]
out = shg_forward(*step)
assert out[2].shape == (2, 256, 8), out[2].shape
out = shg_fused(*step, mxu=True)
assert out[2].shape == (2, 256, 8), out[2].shape
rc = bench_device.main(["tiny.ser", "--device", "cpu", "--output-dir", "dec"])
assert rc == 0, rc
rc = bench_feed.main(["tiny.ser", "--device", "cpu"])
assert rc == 0, rc
rc = bench_kernels.main(["--device", "cpu", "--frames", "16", "--ih", "24",
                         "--iw", "16", "--reps", "1"])
assert rc == 0, rc
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "solex_ser_recon_en_tpu"))
assert not leaked, leaked
print("NO_JAX_OK")
"""


def _port_sources():
    pkg = os.path.join(ROOT, "solex_ser_recon_en_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


CHECKED_FILES = ["chip_smoke.py", "chip_profile.py", "chip_ring_probe.py",
                 os.path.join("tests", "test_torch_cuda_kernels.py")]


def _imported_roots(path):
    """Top-level package of every import statement in the file (at any
    depth: function bodies included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_runs_without_importing_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SOLEX_NO_COMPILE_CACHE", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout
    assert (tmp_path / "tiny_shift=0_clahe.png").exists()
    assert (tmp_path / "dec" / "decomp_shift=0_clahe.png").exists()


def test_port_sources_have_no_jax_import():
    for path in list(_port_sources()) + [os.path.join(ROOT, f)
                                         for f in CHECKED_FILES]:
        for root, line in _imported_roots(path):
            assert root not in ("jax", "jaxlib"), (path, line)


@pytest.mark.parametrize("rel", ["solex_ser_recon_en_torch"] + CHECKED_FILES)
def test_no_import_of_the_jax_package(rel):
    """Not even a jax-free module of the JAX package: the port keeps its
    own copies."""
    path = os.path.join(ROOT, rel)
    paths = list(_port_sources()) if os.path.isdir(path) else [path]
    for p in paths:
        for root, line in _imported_roots(p):
            assert root != "solex_ser_recon_en_tpu", (p, line)


def test_package_init_sets_no_environment():
    with open(os.path.join(ROOT, "solex_ser_recon_en_torch",
                           "__init__.py")) as f:
        src = f.read()
    assert "SOLEX_NO_COMPILE_CACHE" not in src and "environ" not in src
