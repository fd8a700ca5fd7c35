"""The PyTorch port imports neither jax nor the JAX package.

A fresh interpreter makes a tiny scan with the port's own synthetic-scan
generator, runs the ``-c`` slice through the CLI on the CPU, a folder of
it as an 8-bit SER and a Y800 AVI (``chip_smoke.write_y800_avi``) with
``--input-dir`` and ``--profile``, then every
product mode that writes no figure (``-f``, the crops, a sweep,
``protus_only``, stubborn, de-vignette), the ``band`` and ``host``
feeds, ``--mesh frame=4`` and the mesh's library functions, ``python -m
solex_ser_recon_en_torch``, the CLAHE tool on a
product PNG, the spectral analyser, ``-cd`` with a recording display and
the GUI's file mode under the tests' FreeSimpleGUI stub (none of cv2, PIL
or matplotlib may be loaded by then) and the default mode (which loads matplotlib, in
pipeline/plots.py alone), the fused step
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
import os, shutil
from chip_smoke import write_y800_avi
from solex_ser_recon_en_torch.io.ser import SerReader
os.makedirs("folder")
shutil.copy("tiny.ser", "folder/a.ser")
write_y800_avi("folder/b.avi", SerReader("tiny.ser").raw_frames())
rc = cli.main(["-c", "--input-dir", "folder", "--device", "cpu",
               "--output-dir", "session", "--profile=prof"])
assert rc == 0, rc
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.pipeline.run import process_file
for flags in ("-cfw-2:2:2", "-csw0", "-cfr151"):
    rc = cli.main([flags, "tiny.ser", "--device", "cpu", "--output-dir", "modes"])
    assert rc == 0, (flags, rc)
for kw in (dict(protus_only=True, save_fit=True),
           dict(clahe_only=True, stubborn_transversalium=True),
           dict(clahe_only=True, de_vignette=True, save_fit=True)):
    process_file("tiny.ser", Options(shift=[0], output_dir="modes", **kw),
                 torch.device("cpu"))
for feed in ("band", "host"):
    rc = cli.main(["-cw0", "tiny.ser", "--device", "cpu", "--feed", feed,
                   "--output-dir", "feed_" + feed])
    assert rc == 0, (feed, rc)
rc = cli.main(["-cw0", "tiny.ser", "--device", "cpu", "--mesh", "frame=4",
               "--output-dir", "mesh"])
assert rc == 0, rc
import numpy as np
from solex_ser_recon_en_torch.parallel import (
    device_pipeline_step, make_mesh, shard_scan_recon)
from solex_ser_recon_en_torch.parallel.distributed import initialize
frames = np.zeros((2, 8, 16, 12), np.uint16)
ind = np.zeros((2, 1, 16), np.int32)
w = np.ones((2, 16), np.float32)
mesh = make_mesh({"batch": 2, "frame": 2}, [torch.device("cpu")] * 4)
assert shard_scan_recon(frames[0], ind[0], w[0], mesh).shape == (1, 16, 8)
out = device_pipeline_step(frames, ind, w, np.stack([np.eye(3)] * 2),
                           w, mesh=mesh)
assert out["circular"].shape == (2, 1, 16, 8)
import runpy
import solex_ser_recon_en_torch.cli.analyse as analyse
import solex_ser_recon_en_torch.cli.clahe_tool as clahe_tool
sys.argv = ["solex_ser_recon_en_torch", "-cw0", "tiny.ser", "--device", "cpu",
            "--output-dir", "main_m"]
try:
    runpy.run_module("solex_ser_recon_en_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
rc = clahe_tool.main(["tiny_shift=0_clahe.png", "--stretch", "--device", "cpu"])
assert rc == 0, rc
rc = analyse.main(["tiny.ser", "--device", "cpu", "--save", "an"])
assert rc == 0, rc
import importlib.util
import chip_smoke
from solex_ser_recon_en_torch.utils import display
display.BACKEND = display.Recorder()
rc = cli.main(["-cdw0", "tiny.ser", "--device", "cpu", "--output-dir", "disp"])
assert rc == 0 and display.BACKEND.images("Sun images"), rc
spec = importlib.util.spec_from_file_location(
    "FreeSimpleGUI", os.path.join(os.path.dirname(chip_smoke.__file__),
                                  "tests", "stub_freesimplegui.py"))
stub = importlib.util.module_from_spec(spec)
spec.loader.exec_module(stub)
sys.modules["FreeSimpleGUI"] = stub
from solex_ser_recon_en_torch.gui import main_window
os.makedirs("gui")
stub.script([("OK", {"-FILE-": "tiny.ser", "_pixel_offset": "0",
                     "Save clahe.png only": True, "output_dir": "gui"})])
assert main_window.run_app("cpu") == 0
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("cv2", "PIL", "matplotlib"))
assert not heavy, heavy
rc = cli.main(["tiny.ser", "--device", "cpu", "--output-dir", "default"])
assert rc == 0, rc
assert "matplotlib" in sys.modules and "cv2" not in sys.modules
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
    assert (tmp_path / "main_m" / "tiny_shift=0_clahe.png").read_bytes() == \
        (tmp_path / "tiny_shift=0_clahe.png").read_bytes()
    assert (tmp_path / "tiny_shift=0_clahe_clahe.png").exists()
    assert (tmp_path / "clahe_config.txt").exists()
    for name in ("an_clahe.png", "an_protus.png"):
        assert (tmp_path / name).exists(), name
    session = tmp_path / "session"
    assert (session / "a_shift=0_clahe.png").read_bytes() == \
        (session / "b_shift=0_clahe.png").read_bytes()
    assert len(list((tmp_path / "prof").iterdir())) == 1
    assert (tmp_path / "dec" / "decomp_shift=0_clahe.png").exists()
    for feed in ("band", "host"):
        assert (tmp_path / f"feed_{feed}" / "tiny_shift=0_clahe.png").exists()
    assert (tmp_path / "mesh" / "tiny_shift=0_clahe.png").read_bytes() == \
        (tmp_path / "tiny_shift=0_clahe.png").read_bytes()
    for d in ("disp", "gui"):
        assert (tmp_path / d / "tiny_shift=0_clahe.png").read_bytes() == \
            (tmp_path / "tiny_shift=0_clahe.png").read_bytes(), d
    modes = sorted(p.name for p in (tmp_path / "modes").iterdir())
    for name in ("tiny_shift=-2_clahe.fits", "tiny_shift=2_raw.fits",
                 "tiny_mean.fits", "tiny_shift=0_protus.png",
                 "tiny_shift=0_detransversaliumed.fits"):
        assert name in modes, (name, modes)
    default = sorted(p.name for p in (tmp_path / "default").iterdir())
    assert default == [
        "tiny_log.txt", "tiny_shift=0_clahe.png",
        "tiny_shift=0_high_contrast.png", "tiny_shift=0_protus.png",
        "tiny_shift=0_transversalium_correction.png",
        "tiny_shift=0_uncontrasted.png", "tiny_shift=10_ellipse_fit.png",
        "tiny_spectral_line_data.png"]


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


def test_port_sources_import_no_cv2_no_pil_and_matplotlib_in_plots_only():
    """The card's machine has none of the three; matplotlib is imported by
    pipeline/plots.py (loaded only when a run wants figures), to ask
    whether it is there, by pipeline/run.py:check_supported, by the
    analyser's window for its canvas (gui/analyser_window.py, when the
    window opens), and by the reference replica (utils/cpu_reference.py:
    _new_figure) inside the function that draws the reference's
    diagnostic figures, only for a replica run that saves them (its ``-c``
    leg needs none; where matplotlib is absent such a run raises)."""
    plots = os.path.join("pipeline", "plots.py")
    run = os.path.join("pipeline", "run.py")
    window = os.path.join("gui", "analyser_window.py")
    replica = os.path.join("utils", "cpu_reference.py")
    for path in list(_port_sources()) + [os.path.join(ROOT, f)
                                         for f in CHECKED_FILES]:
        for root, line in _imported_roots(path):
            assert root not in ("cv2", "PIL"), (path, line)
            if root == "matplotlib":
                assert path.endswith((plots, run, window, replica)), (
                    path, line)
        # OpenCV decodes compressed AVIs, OpenCV or PIL non-PNG images for
        # the CLAHE tool, and OpenCV draws -d's windows, loaded by name on
        # demand
        with open(path) as f:
            if 'import_module("cv2")' in f.read():
                assert path.endswith((os.path.join("io", "video.py"),
                                      os.path.join("io", "png.py"),
                                      os.path.join("utils", "display.py"))
                                     ), path
    assert any(root == "matplotlib" for root, _ in _imported_roots(
        os.path.join(ROOT, "solex_ser_recon_en_torch", plots)))


def test_importing_the_port_imports_no_matplotlib(tmp_path):
    """Every module of the port but pipeline/plots.py, imported in a fresh
    interpreter: no jax, cv2, PIL or matplotlib comes with them."""
    mods = []
    pkg = os.path.join(ROOT, "solex_ser_recon_en_torch")
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[: -len(".__init__")]
        if not rel.endswith(("pipeline.plots", "__main__")):
            mods.append(rel)
    assert "solex_ser_recon_en_torch.io.fits" in mods
    assert "solex_ser_recon_en_torch.pipeline.vignette" in mods
    assert "solex_ser_recon_en_torch.ops.filters" in mods
    assert "solex_ser_recon_en_torch.gui.analyser_window" in mods
    assert "solex_ser_recon_en_torch.utils.display" in mods
    assert "solex_ser_recon_en_torch.utils.cpu_reference" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'solex_ser_recon_en_tpu', 'cv2', 'PIL', "
            "'matplotlib'))\nassert not bad, bad\nprint('CLEAN')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "CLEAN" in res.stdout, \
        res.stdout + res.stderr
    assert os.path.isdir(pkg)


def test_package_init_sets_no_environment():
    with open(os.path.join(ROOT, "solex_ser_recon_en_torch",
                           "__init__.py")) as f:
        src = f.read()
    assert "SOLEX_NO_COMPILE_CACHE" not in src and "environ" not in src
