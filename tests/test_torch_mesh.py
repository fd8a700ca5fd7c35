"""The port's device mesh (parallel/mesh.py, ``--mesh``) on the CPU.

A mesh here is the CPU repeated (``Options.mesh`` under ``--device cpu``,
or ``make_mesh`` over ``[cpu] * n``), the counterpart of the JAX tests'
eight virtual CPU devices (tests/conftest.py): every sharded path runs,
its shards one after another.

Tolerances.  A frame mesh against one device: byte-identical products and
equal arrays (pass A's integer sums and maxima, and B3's per-column lerp,
do not depend on the split).  The port's mesh run against the JAX mesh
run: the bounds tests/test_torch_pipeline.py states for the port against
JAX on one device (disks within 1 LSB on < 0.1% of pixels, ROADMAP C2;
``_clahe.png`` within three CLAHE LUT steps times the stretch slope + 1
LSB, C4).  The library functions against their JAX functions: u16 outputs
within 1 LSB on < 0.5% of entries (C2: XLA:CPU contracts the lerp into an
FMA), the float circular output within 65536 x (2e-7 + 3e-5) (ROADMAP's
warp bound plus C2's coordinate ulp on a [0, 1) image), and each equal to
its own unsharded run.
"""

import ast
import inspect
import math
import os

import jax
import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.config import Options as JaxOptions
from solex_ser_recon_en_tpu.io.png import read_image
from solex_ser_recon_en_tpu.ops.recon import (
    build_shift_indices as jax_build_shift_indices,
)
from solex_ser_recon_en_tpu.ops.warp_fast import unit_y_row, window_for
from solex_ser_recon_en_tpu.parallel import mesh as jax_mesh
from solex_ser_recon_en_tpu.pipeline import run as jax_run
from solex_ser_recon_en_torch.cli.flags import parse_cli
from solex_ser_recon_en_torch.cli.main import main as cli_main
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.io.fits import read_fits
from solex_ser_recon_en_torch.io.png import read_png
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.ops import fused
from solex_ser_recon_en_torch.parallel import mesh as port_mesh
from solex_ser_recon_en_torch.parallel.mesh import (
    MeshTooLarge,
    device_pipeline_step,
    device_recon_batch,
    frame_split,
    make_mesh,
    mesh_from_options,
    parse_mesh_spec,
    shard_scan_recon,
)
from solex_ser_recon_en_torch.pipeline import batch as port_batch
from solex_ser_recon_en_torch.pipeline import run as port_run

from torch_parity import lsb_diff

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.cpu().view(torch.int16).numpy().view(np.uint16)


# ---- the mesh itself ---------------------------------------------------------


def test_make_mesh_shapes():
    m = make_mesh(devices=[CPU] * 8)
    assert m.shape == {"batch": 1, "frame": 8}
    m = make_mesh({"batch": 2, "frame": 4}, devices=[CPU] * 8)
    assert m.axis_names == ("batch", "frame")
    assert m.shape == {"batch": 2, "frame": 4} and m.first == CPU
    assert len(m.row(1)) == 4
    with pytest.raises(ValueError, match="does not match 8 devices"):
        make_mesh({"batch": 3, "frame": 3}, devices=[CPU] * 8)


@pytest.mark.parametrize("spec,want", [
    ("8", {"frame": 8}), ("frame=8", {"frame": 8}),
    ("batch=2,frame=4", {"batch": 2, "frame": 4}),
    (" batch=2, frame=4 ", {"batch": 2, "frame": 4}),
])
def test_parse_mesh_spec(spec, want):
    assert parse_mesh_spec(spec) == want == jax_mesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["rows=3", "frame=", "2x4", "frame=-1", ""])
def test_parse_mesh_spec_rejects_garbage(spec):
    with pytest.raises(ValueError):
        parse_mesh_spec(spec)


def test_parse_mesh_spec_is_a_copy():
    assert inspect.getsource(parse_mesh_spec) == \
        inspect.getsource(jax_mesh.parse_mesh_spec)


def test_cli_mesh_flag():
    opts = Options()
    files, dev = parse_cli(opts, ["--mesh", "batch=2,frame=4", "-c", "x.ser"])
    assert opts.mesh == {"batch": 2, "frame": 4}
    assert opts.clahe_only and files == ["x.ser"] and dev == "cuda"
    opts2 = Options()
    parse_cli(opts2, ["--mesh=8"])
    assert opts2.mesh == {"frame": 8}
    with pytest.raises(SystemExit):
        parse_cli(Options(), ["--mesh"])  # trailing, no spec


@pytest.mark.parametrize("n,parts", [(81, 4), (56, 4), (194, 8), (3, 8),
                                     (2, 5), (0, 3)])
def test_frame_split_tiles_and_never_grows(n, parts):
    r = frame_split(n, parts)
    assert len(r) == parts and r[0][0] == 0 and r[-1][1] == n
    assert all(a <= b and b == c for (a, b), (c, _) in zip(r, r[1:]))
    for m in range(n):   # a shorter chunk's pieces are never longer
        assert all(b2 - a2 <= b - a for (a, b), (a2, b2)
                   in zip(r, frame_split(m, parts)))


def test_mesh_from_options():
    assert mesh_from_options(None, CPU) is None
    assert mesh_from_options({"frame": 1}, CPU) is None
    m = mesh_from_options({"batch": 2, "frame": 4}, CPU)
    assert m.shape == {"batch": 2, "frame": 4}
    assert all(d == CPU for row in m.devices for d in row)
    for bad in ("1x2", {"rows": 2}, {"frame": 0}):
        with pytest.raises(ValueError, match="mesh spec"):
            mesh_from_options(bad, CPU)


# ---- a mesh larger than the cards -----------------------------------------


def test_mesh_larger_than_the_cards_raises(monkeypatch):
    """The JAX package prints a warning and runs on one device
    (``mesh_from_options``); the port raises, naming both counts
    (ROADMAP C14)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(MeshTooLarge, match=r"needs 2 devices; this machine "
                                           r"has 1 visible CUDA card"):
        mesh_from_options({"frame": 2}, torch.device("cuda"))
    with pytest.raises(MeshTooLarge, match="needs 8 devices"):
        mesh_from_options({"batch": 2, "frame": 4}, torch.device("cuda", 0))


def test_cli_mesh_larger_than_the_cards_exits_2(basic_scan, tmp_path,
                                                  monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "out"
    rc = cli_main(["-cw0", basic_scan["path"], "--mesh", "frame=2",
                   "--output-dir", str(out)])
    assert rc == 2
    said = capsys.readouterr().out
    assert "ERROR: " in said and "needs 2 devices" in said
    assert not out.exists() or not any(out.iterdir())


def test_prebuilt_mesh_must_start_on_the_run_device(basic_scan, tmp_path):
    mesh = make_mesh({"frame": 2}, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="first device"):
        port_run.read_scan(basic_scan["path"], Options(
            shift=[0], clahe_only=True, output_dir=str(tmp_path)),
            torch.device("meta"), mesh=mesh)
    assert list(tmp_path.iterdir()) == []


# ---- a frame mesh equals one device ----------------------------------------


def _run(scan_path, tmp_path, name, **kw):
    outdir = tmp_path / name
    outdir.mkdir()
    opts = Options(shift=[0, 3], save_fit=True, transversalium=True,
                   output_dir=str(outdir), _nolog=True, feed_mode="device",
                   **kw)
    return port_run.process_file(scan_path, opts, CPU), outdir


def _assert_identical(res_a, res_b, dir_a, dir_b):
    assert [s for s, _ in res_a] == [s for s, _ in res_b]
    for (_, out_a), (_, out_b) in zip(res_a, res_b):
        for img_a, img_b in zip(out_a, out_b):
            if isinstance(img_a, torch.Tensor):
                img_a, img_b = img_a.view(torch.int16), img_b.view(
                    torch.int16)
                assert torch.equal(img_a, img_b)
            else:
                np.testing.assert_array_equal(np.asarray(img_a),
                                              np.asarray(img_b))
    files_a = sorted(os.listdir(dir_a))
    assert files_a == sorted(os.listdir(dir_b))
    n = 0
    for f in files_a:
        if f.endswith((".fits", ".png")):
            assert (dir_a / f).read_bytes() == (dir_b / f).read_bytes(), f
            n += 1
    assert n >= 9


class _Count:
    """Counts the calls of a module function (and passes them on)."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        self.orig = getattr(module, name)
        monkeypatch.setattr(module, name, self)

    def __call__(self, *a, **k):
        self.n += 1
        return self.orig(*a, **k)


@pytest.mark.parametrize("frame_chunk", [512, 64])
def test_process_file_frame_mesh_byte_identical(basic_scan, tmp_path,
                                                monkeypatch, frame_chunk):
    """``mesh={"frame": 8}``: FITS and PNG bytes and the returned arrays
    equal the run without a mesh; pass A runs once a piece and B3 once a
    shard (200 frames: one chunk of 200, or chunks of 64, 64, 64, 8)."""
    res_1, dir_1 = _run(basic_scan["path"], tmp_path, "single",
                        frame_chunk=frame_chunk)
    passa = _Count(monkeypatch, fused, "sum_max")
    passb = _Count(monkeypatch, fused, "recon_chunks")
    res_8, dir_8 = _run(basic_scan["path"], tmp_path, "mesh",
                        mesh={"frame": 8}, frame_chunk=frame_chunk)
    _assert_identical(res_1, res_8, dir_1, dir_8)
    pieces = sum(min(8, n) for n in
                 [len(r) for r in np.array_split(np.arange(200), range(
                     frame_chunk, 200, frame_chunk))])
    assert passa.n == pieces and passb.n == 8


def test_mesh_with_non_divisible_frame_count(tmp_path):
    """194 frames over 8 shards, in chunks of 64, 64, 64 and 2: uneven
    pieces and shards with none of the last chunk; bit-identical to one
    device, and no padding reaches the disks."""
    p = str(tmp_path / "odd.ser")
    SyntheticScan(ih=128, iw=64, frames=194, depth=16,
                  line_poly=(30.0, 0.01, 0.0, 0.0), noise=0.002,
                  seed=6).write(p, transpose_to_wide=True)
    for chunk in (512, 64):
        res_1, dir_1 = _run(p, tmp_path, f"odd1_{chunk}", frame_chunk=chunk)
        res_8, dir_8 = _run(p, tmp_path, f"odd8_{chunk}", mesh={"frame": 8},
                            frame_chunk=chunk)
        _assert_identical(res_1, res_8, dir_1, dir_8)
        raw = read_fits(str(dir_8 / "odd_shift=0_raw.fits"))[0]
        assert raw.shape[1] == 194


def _disks(path, tmp_path, **kw):
    opts = Options(shift=[0, 3], ratio_fixe=1.0, slant_fix=0.0,
                   output_dir=str(tmp_path), **kw)
    scan = port_run.read_scan(path, opts, CPU)
    return scan


@pytest.mark.parametrize("mesh", [{"frame": 8}, {"batch": 2}])
@pytest.mark.parametrize("feed", ["band", "device"])
def test_feed_under_a_mesh_equals_one_device(basic_scan, tmp_path, feed,
                                             mesh):
    """The band feed's and the device feed's disks under a frame mesh
    equal their single-device runs (the JAX package's band feed only gets
    within 1 LSB: its one-hot contraction's shape changes with the
    split); under ``batch=2`` one scan takes the first row, a single frame
    shard on the run's device."""
    one = _disks(basic_scan["path"], tmp_path, feed_mode=feed,
                 frame_chunk=48)
    sharded = _disks(basic_scan["path"], tmp_path, feed_mode=feed,
                     frame_chunk=48, mesh=mesh)
    assert torch.equal(one.disk_list.view(torch.int16),
                       sharded.disk_list.view(torch.int16))
    np.testing.assert_array_equal(one.mean_img, sharded.mean_img)
    log = (tmp_path / "basic_log.txt").read_text()
    shape = {"batch": mesh.get("batch", 1), "frame": mesh.get("frame", 1)}
    assert f"Mesh : {shape}" in log
    assert f"once a frame shard of {shape['frame']}" in log


@pytest.mark.parametrize("mesh", [{"frame": 8}, {"batch": 2},
                                  {"batch": 2, "frame": 4}])
def test_streaming_pass_b_under_a_mesh(basic_scan, tmp_path, monkeypatch,
                                       mesh):
    """A scan too large to stay resident re-reads its pieces for pass B;
    a mesh of one frame shard a row (``batch=2``) streams as one device."""
    one = _disks(basic_scan["path"], tmp_path, feed_mode="device",
                 frame_chunk=48)
    monkeypatch.setattr(port_run, "RESIDENT_CAP_BYTES", 0)
    sharded = _disks(basic_scan["path"], tmp_path, feed_mode="device",
                     frame_chunk=48, mesh=mesh)
    assert torch.equal(one.disk_list.view(torch.int16),
                       sharded.disk_list.view(torch.int16))


def test_host_feed_ignores_the_mesh(basic_scan, tmp_path):
    one = _disks(basic_scan["path"], tmp_path, feed_mode="host")
    four = _disks(basic_scan["path"], tmp_path, feed_mode="host",
                  mesh={"frame": 4})
    assert four.feed == "host"
    assert torch.equal(one.disk_list.view(torch.int16),
                       four.disk_list.view(torch.int16))
    assert "(not used by the host feed)" in \
        (tmp_path / "basic_log.txt").read_text()


def test_auto_takes_device_under_a_mesh(basic_scan, tmp_path):
    scan = _disks(basic_scan["path"], tmp_path, mesh={"frame": 2})
    assert scan.feed == "device"
    assert "Feed : device (auto under a mesh)" in \
        (tmp_path / "basic_log.txt").read_text()


def test_cli_mesh_runs_on_cpu(basic_scan, tmp_path):
    """``--mesh frame=8 --device cpu`` runs ``-c`` and gives the run
    without a mesh its bytes."""
    outs = []
    for extra in ([], ["--mesh", "frame=8"]):
        out = tmp_path / f"out{len(extra)}"
        assert cli_main(["-cw0", basic_scan["path"], "--device", "cpu",
                         "--output-dir", str(out), *extra]) == 0
        outs.append((out / "basic_shift=0_clahe.png").read_bytes())
    assert outs[0] == outs[1]


# ---- the port's mesh against the JAX mesh ------------------------------------


def _tpu_warp_gate(mat3):
    """geometry/correct.py:_use_fast_warp without its TPU placement test
    (as tests/test_torch_pipeline.py)."""
    return bool(unit_y_row(mat3) and window_for(mat3) > 0)


@pytest.fixture(scope="module")
def jax_vs_port_mesh(basic_scan, tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    import importlib

    from solex_ser_recon_en_torch.pipeline import products as port_products

    jax_correct = importlib.import_module(
        "solex_ser_recon_en_tpu.geometry.correct")
    path = basic_scan["path"]
    out_j = str(tmp_path_factory.mktemp("jax_mesh"))
    out_t = str(tmp_path_factory.mktemp("port_mesh"))
    slopes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_correct, "_use_fast_warp", _tpu_warp_gate)
        oj = JaxOptions(shift=[0], clahe_only=True, feed_mode="device",
                        output_dir=out_j, mesh={"frame": 8})
        scan_j = jax_run.read_scan(path, oj)
        jax_run.process_scan(scan_j, oj)
        orig = port_products._stretch

        def spy(img, lo, hi):
            slopes.append(65535.0 / float(hi - lo))
            return orig(img, lo, hi)

        mp.setattr(port_products, "_stretch", spy)
        ot = Options(shift=[0], clahe_only=True, output_dir=out_t,
                     mesh={"frame": 8})
        scan_t = port_run.read_scan(path, ot, CPU)
        port_run.process_scan(scan_t, ot)
    return dict(scan_j=scan_j, scan_t=scan_t, slope=slopes[0],
                png_j=read_image(out_j + "/basic_shift=0_clahe.png"),
                png_t=read_png(out_t + "/basic_shift=0_clahe.png"))


def test_mesh_disks_against_the_jax_mesh(jax_vs_port_mesh):
    sj, st = jax_vs_port_mesh["scan_j"], jax_vs_port_mesh["scan_t"]
    np.testing.assert_array_equal(st.mean_img, sj.mean_img)
    assert st.shifts == sj.shifts == [10, 0]
    mx, frac = lsb_diff(_u16(st.disk_list), np.asarray(sj.disk_list))
    assert mx <= 1 and frac < 0.001


def test_mesh_clahe_png_against_the_jax_mesh(jax_vs_port_mesh):
    a, b = jax_vs_port_mesh["png_j"], jax_vs_port_mesh["png_t"]
    assert a.shape == b.shape and b.dtype == np.uint16
    h, w = a.shape
    lut_step = 65535 / (((h + h % 2) // 2) * ((w + w % 2) // 2))
    mx, _ = lsb_diff(b, a)
    assert mx <= math.ceil(3 * lut_step * jax_vs_port_mesh["slope"]) + 1
    assert np.abs(b.astype(np.int64) - a.astype(np.int64)).mean() <= 2.0


# ---- the library functions against JAX ---------------------------------------


def _jax_mesh(axes):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    n = axes.get("batch", 1) * axes["frame"]
    return jax_mesh.make_mesh(axes, jax.devices()[:n])


def _close_u16(port, ref):
    mx, frac = lsb_diff(port, ref)
    assert mx <= 1 and frac < 0.005, (mx, frac)


@pytest.mark.parametrize("kernel", ["onehot", "gather"])
def test_shard_scan_recon_against_jax(kernel):
    """tests/test_sharding.py's inputs: 64 frames of 32 x 24 random u16,
    shifts [0, 2, -1], over 8 frame shards."""
    rng = np.random.default_rng(42)
    F, ih, iw = 64, 32, 24
    frames = rng.integers(0, 65536, size=(F, ih, iw), dtype=np.uint16)
    curve = 10.0 + 0.03 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    ind_l, left_w = jax_build_shift_indices(floor, curve - floor, [0, 2, -1],
                                            iw)
    ref = np.asarray(jax_mesh.shard_scan_recon(
        frames, ind_l, left_w, _jax_mesh({"frame": 8}), kernel=kernel))
    mesh = make_mesh(devices=[CPU] * 8)
    out = shard_scan_recon(frames, ind_l, left_w, mesh, kernel=kernel)
    assert out.shape == (3, ih, F) and out.dtype == torch.uint16
    _close_u16(_u16(out), ref)
    whole = shard_scan_recon(frames, ind_l, left_w,
                             make_mesh(devices=[CPU]), kernel=kernel)
    assert torch.equal(out.view(torch.int16), whole.view(torch.int16))
    with pytest.raises(ValueError, match="unknown recon kernel"):
        shard_scan_recon(frames, ind_l, left_w, mesh, kernel="pallas")


def test_device_recon_batch_against_jax(tmp_path):
    """tests/test_batch_device.py's inputs: two 40-frame 96 x 64 synthetic
    scans, shifts [10, 0], over a (2, 2) mesh."""
    scan = SyntheticScan(ih=96, iw=64, frames=40, depth=16,
                         line_poly=(32.0, 0.01, 0.0, 0.0), noise=0.002,
                         seed=7)
    one = np.asarray(scan.generate())
    frames = np.stack([one, one[::-1].copy()])
    B, F, ih, iw = frames.shape
    curve = 32.0 + 0.01 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    ind_l, left_w = jax_build_shift_indices(floor, curve - floor, [10, 0], iw)
    ind_b = np.ascontiguousarray(np.broadcast_to(ind_l, (B,) + ind_l.shape))
    w_b = np.ascontiguousarray(np.broadcast_to(left_w, (B,) + left_w.shape))
    ref = np.asarray(jax_mesh.device_recon_batch(
        frames, ind_b, w_b, mesh=_jax_mesh({"batch": 2, "frame": 2})))
    mesh = make_mesh({"batch": 2, "frame": 2}, devices=[CPU] * 4)
    out = device_recon_batch(frames, ind_b, w_b, mesh=mesh)
    assert out.shape == (B, 2, ih, F)
    _close_u16(_u16(out), ref)
    unsharded = device_recon_batch(frames, ind_b, w_b, device="cpu")
    assert torch.equal(out.view(torch.int16), unsharded.view(torch.int16))


def _step_inputs(mats):
    rng = np.random.default_rng(42)
    B, F, ih, iw = 2, 16, 32, 16
    frames = rng.integers(0, 65536, size=(B, F, ih, iw), dtype=np.uint16)
    curve = iw / 2 + 0.01 * np.arange(ih)
    floor = np.floor(curve).astype(np.int64)
    ind_l, left_w = jax_build_shift_indices(floor, curve - floor, [0, 1], iw)
    ind_l = np.ascontiguousarray(np.broadcast_to(ind_l, (B,) + ind_l.shape))
    left_w = np.ascontiguousarray(np.broadcast_to(left_w,
                                                  (B,) + left_w.shape))
    gains = np.stack([np.ones(ih, np.float32),
                      np.linspace(0.9, 1.1, ih, dtype=np.float32)])
    return frames, ind_l, left_w, mats, gains


IDENTITY = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
#: a mild circularisation map: scale, shear and a shift of the rows
WARPED = np.stack([np.array([[1.0, 0.0, 0.0], [0.02, 1.05, -0.4],
                             [0.0, 0.0, 1.0]], np.float32)] * 2)


def test_device_pipeline_step_against_jax():
    """tests/test_sharding.py's inputs over a (2, 4) mesh: mean and max
    exact, raw and circular within 1 LSB on the C2 share, each equal to
    the unsharded step."""
    args = _step_inputs(IDENTITY)
    ref = jax_mesh.device_pipeline_step(*args,
                                        mesh=_jax_mesh({"batch": 2,
                                                        "frame": 4}))
    mesh = make_mesh({"batch": 2, "frame": 4}, devices=[CPU] * 8)
    out = device_pipeline_step(*args, mesh=mesh)
    for k in ("mean", "max"):
        np.testing.assert_array_equal(_u16(out[k]), np.asarray(ref[k]))
    for k in ("raw", "circular"):
        assert out[k].shape == (2, 2, 32, 16)
        _close_u16(_u16(out[k]), np.asarray(ref[k]))
    whole = device_pipeline_step(*args, device="cpu")
    for k in out:
        assert torch.equal(out[k].view(torch.int16),
                           whole[k].view(torch.int16)), k


def test_device_pipeline_step_float_circular_against_jax():
    """The float circular output (``out_u16=False``) of a non-trivial
    warp against the JAX step's, within 65536 x (2e-7 + 3e-5)."""
    args = _step_inputs(WARPED)
    ref = jax_mesh._batched_step(*[jax.numpy.asarray(a) for a in args],
                                 out_u16=False)
    mesh = make_mesh({"batch": 2, "frame": 4}, devices=[CPU] * 8)
    out = device_pipeline_step(*args, mesh=mesh, out_u16=False)
    assert out["circular"].dtype == torch.float32
    d = np.abs(out["circular"].numpy() - np.asarray(ref["circular"]))
    assert d.max() <= 65536 * (2e-7 + 3e-5), d.max()
    d = np.abs(out["raw"].numpy() - np.asarray(ref["raw"]))
    assert d.max() <= 65536 * 2e-7, d.max()
    whole = device_pipeline_step(*args, device="cpu", out_u16=False)
    assert torch.equal(out["circular"], whole["circular"])


# ---- the group read under a mesh ---------------------------------------------


def test_group_read_under_a_mesh_equals_the_unsharded_one(tmp_path):
    """Four same-shape scans under a (batch=2, frame=2) mesh: members over
    the batch rows, frames over the frame shards, B3 once a piece; the
    disks equal the unsharded group read's, by a prebuilt mesh and by
    ``Options.mesh``."""
    files = []
    for i in range(4):
        p = str(tmp_path / f"b{i}.ser")
        SyntheticScan(ih=96, iw=64, frames=40, depth=16,
                      line_poly=(32.0, 0.01, 0.0, 0.0), noise=0.002,
                      seed=7 + i).write(p, transpose_to_wide=True)
        files.append(p)

    def group(name, prebuilt=None, **kw):
        out = tmp_path / name
        out.mkdir()
        tasks = [(f, Options(shift=[0], clahe_only=True, output_dir=str(out),
                             **kw)) for f in files]
        return port_batch.read_scans_batched(tasks, {}, CPU, mesh=prebuilt)

    plain = group("plain")
    assert sorted(plain) == sorted(files)
    mesh = make_mesh({"batch": 2, "frame": 2}, devices=[CPU] * 4)
    for sharded in (group("prebuilt", mesh),
                    group("options", mesh={"batch": 2, "frame": 2})):
        for f in files:
            assert torch.equal(plain[f].disk_list.view(torch.int16),
                               sharded[f].disk_list.view(torch.int16)), f


def test_group_read_pieces(tmp_path, monkeypatch):
    """B3 once a piece: 4 members x 2 frame shards."""
    calls = []
    orig = port_mesh.sharded_recon

    def spy(frames, *a, **kw):
        calls.append(frames.shape[0])
        return orig(frames, *a, **kw)

    monkeypatch.setattr(port_mesh, "sharded_recon", spy)
    from solex_ser_recon_en_torch.ops import recon_cuda

    launches = _Count(monkeypatch, recon_cuda, "recon_chunks")
    files = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.ser")
        SyntheticScan(ih=64, iw=48, frames=21, depth=16,
                      line_poly=(24.0, 0.01, 0.0, 0.0), noise=0.002,
                      seed=30 + i).write(p, transpose_to_wide=True)
        files.append(p)
    tasks = [(f, Options(shift=[0], clahe_only=True,
                         output_dir=str(tmp_path), mesh={"frame": 2}))
             for f in files]
    out = port_batch.read_scans_batched(tasks, {}, CPU)
    assert sorted(out) == sorted(files) and calls == [21, 21, 21]
    assert launches.n == 6


# ---- every kernel launches on its input's card -------------------------------


WRAPPER_FILES = ("ops/fused_cuda.py", "ops/recon_cuda.py",
                 "ops/warp_fast.py", "ops/clahe.py")


def _launch_sites():
    """(file, function, device expression, stream expression) of every
    call into the kernel library (``cuda_build.lib()``)."""
    sites = []
    for rel in WRAPPER_FILES:
        path = os.path.join(ROOT, "solex_ser_recon_en_torch", rel)
        tree = ast.parse(open(path).read(), path)
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            params = {a.arg for a in fn.args.args}
            # local names bound to an input's device (dev = x.device)
            local = {}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    local[node.targets[0].id] = node.value
            for w in ast.walk(fn):
                if not isinstance(w, ast.With):
                    continue
                for item in w.items:
                    ctx = item.context_expr
                    if ast.unparse(getattr(ctx, "func", ctx)) != \
                            "torch.cuda.device":
                        continue
                    dev = ctx.args[0]
                    for call in ast.walk(ast.Module(body=w.body,
                                                    type_ignores=[])):
                        if (isinstance(call, ast.Call)
                                and ast.unparse(call.func) ==
                                "cuda_build.lib"):
                            sites.append((rel, fn.name, dev, params, local,
                                          w))
            n_calls = sum(1 for c in ast.walk(fn) if isinstance(c, ast.Call)
                          and ast.unparse(c.func) == "cuda_build.lib")
            n_guarded = sum(1 for s in sites if s[1] == fn.name
                            and s[0] == rel)
            assert n_calls <= n_guarded, (
                f"{rel}:{fn.name} calls the kernel library outside "
                "torch.cuda.device(...)")
    return sites


def _input_device(expr, params, local) -> bool:
    """Whether ``expr`` is an input tensor's device: ``x.device`` of a
    parameter (or of its first element), or a local name bound to one."""
    if isinstance(expr, ast.Name) and expr.id in local:
        return _input_device(local[expr.id], params, set())
    if isinstance(expr, ast.Attribute) and expr.attr == "device":
        base = expr.value
        if isinstance(base, ast.Subscript):
            base = base.value
        return isinstance(base, ast.Name) and base.id in params
    return False


def test_every_wrapper_launches_under_its_inputs_device():
    """Every call into the kernel library (a launch, or a launch plan read
    from the card) runs under ``torch.cuda.device(<its input's device>)``,
    and a launch passes that device's stream: a tensor on ``cuda:1``
    launches on ``cuda:1`` from a thread whose current card is another
    (tests/test_torch_cuda_kernels.py::test_kernels_launch_on_their_
    tensors_card runs them so on the card)."""
    sites = _launch_sites()
    names = {(rel, fn) for rel, fn, *_ in sites}
    assert names == {
        ("ops/fused_cuda.py", "sum_max"),
        ("ops/fused_cuda.py", "fused_mxu_plan_cuda"),
        ("ops/fused_cuda.py", "fused_plan_cuda"),
        ("ops/fused_cuda.py", "_launch"),
        ("ops/recon_cuda.py", "recon_chunks"),
        ("ops/warp_fast.py", "hresample"),
        ("ops/clahe.py", "_launch_hist"),
    }
    for rel, fn, dev, params, local, w in sites:
        assert _input_device(dev, params, local), (rel, fn, ast.unparse(dev))
        for call in ast.walk(ast.Module(body=w.body, type_ignores=[])):
            if (isinstance(call, ast.Call) and ast.unparse(call.func)
                    == "cuda_build.stream_handle"):
                assert ast.unparse(call.args[0]) == ast.unparse(dev), (
                    rel, fn)


def test_hist_kernel_caches_its_setup_by_card():
    """csrc/hist.cu's once-only set-up (the shared-memory attribute, which
    binds only the current card, and the active-cluster count) is kept
    per card, not once a process."""
    src = open(os.path.join(ROOT, "solex_ser_recon_en_torch", "csrc",
                            "hist.cu")).read()
    assert "cached_clusters[kMaxDevices]" in src
    assert "cudaGetDevice(&dev)" in src
    assert "static int max_clusters" not in src

