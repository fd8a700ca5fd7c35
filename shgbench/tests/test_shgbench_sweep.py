"""A Doppler sweep held shift by shift (CPU, the ``SMALL`` size): the
pending cell ``fulldisk16.sweep5`` (``shg -cw-10:10:5``) compares each
requested shift's circularised disk, row gain and ``_clahe.png`` with the
reference's of that shift; faults in one shift make it not correct; and
the one-shift cells read the same numbers and roofline bytes as before
the comparison went by shift."""

import io
import itertools
import time
import types

import numpy as np
import pytest
import torch

from shgbench import compare
from shgbench.generator import ScanFile, ScanModel
from shgbench.harness import load_reader, load_reference, run_cell
from solex_ser_recon_en_torch.pipeline import products
from solex_ser_recon_en_torch.pipeline import run as run_mod

from .conftest import small_cell

CPU = torch.device("cpu")
SWEEP = "fulldisk16.sweep5"
SHIFTS = [-10, -5, 0, 5, 10]
SEED = 2 ** 31 + 99


def _run(name, seed=SEED):
    cell = small_cell(name)
    if cell.mix["kind"] == "session":
        cell.mix["files"] = 3
    rec, err = {}, io.StringIO()
    rc = run_cell(cell, seed, 0.5, False, CPU, time.perf_counter(),
                  out=io.StringIO(), err=err, record=rec)
    assert rc == 0
    return rec, err.getvalue()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sweep, and its one-shift runs, on one small scan."""
    cell = small_cell(SWEEP)
    path = str(tmp_path_factory.mktemp("sweep") / "s.ser")
    scan = ScanFile(ScanModel.from_config(cell.config), 2 ** 31 + 3, CPU,
                    path)
    ref = load_reference(cell.config)
    fit = int(cell.config["fit_shift"])
    out = {"sweep": ref.run(path, shifts=SHIFTS, fit_shift=fit),
           "one": {s: ref.run(path, shifts=[s], fit_shift=fit)
                   for s in SHIFTS}}
    scan.close()
    return out


def test_the_sweep_is_correct_with_every_product_compared(monkeypatch):
    read = compare.read_png
    seen = []

    def read_png(path):
        seen.append(path)
        return read(path)

    monkeypatch.setattr(compare, "read_png", read_png)
    rec, _ = _run(SWEEP)
    res = rec["result"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # the sample and the last scan: one or two scans of five products
    names = [p.rsplit("/", 1)[1] for p in seen]
    assert len(names) in (5, 10)
    for s in SHIFTS:
        assert sum(n.endswith(f"_shift={s}_clahe.png") for n in names) \
            == len(names) // 5


def test_reference_products_equal_the_one_shift_runs(reference):
    sweep = reference["sweep"]
    assert list(sweep["products"]) == SHIFTS
    for s in SHIFTS:
        one = reference["one"][s]
        for k in ("warped", "gain", "clahe"):
            np.testing.assert_array_equal(sweep["products"][s][k], one[k])
    for k in ("warped", "gain", "clahe"):
        np.testing.assert_array_equal(sweep[k], sweep["products"][SHIFTS[0]][k])


# the compared numbers of each accepted cell on seed 2**31 + 99 at the
# SMALL size, as the comparison read them before it went by shift
BEFORE = {
    "fulldisk16.single": {
        "passa_mean_lsb": 0.0, "linefit_px": 0.0, "disk_max_lsb": 1.0,
        "disk_off_pct": 0.0517578125, "ratio_rel": 0.0, "tilt_deg": 0.0,
        "warp_shape_px": 0.0, "warp_mean_lsb": 0.0010521298363095238,
        "warp_p99_lsb": 0.0, "warp_max_lsb": 1.0, "warp_off_pct": 0.0,
        "gain_max": 1.4384531754618735e-06, "png_shape_px": 0.0,
        "png_mean_lsb": 1.0801130022321428, "png_p99_lsb": 9.0,
        "png_max_lsb": 18.0, "png_off_pct": 0.0},
    "fulldisk8.single": {
        "passa_mean_lsb": 0.0, "linefit_px": 0.0, "disk_max_lsb": 1.0,
        "disk_off_pct": 0.23111979166666666, "ratio_rel": 0.0,
        "tilt_deg": 0.0, "warp_shape_px": 0.0,
        "warp_mean_lsb": 0.0010521298363095238, "warp_p99_lsb": 0.0,
        "warp_max_lsb": 1.0, "warp_off_pct": 0.0,
        "gain_max": 5.980997265253585e-05, "png_shape_px": 0.0,
        "png_mean_lsb": 5.475504557291667, "png_p99_lsb": 36.0,
        "png_max_lsb": 57.0, "png_off_pct": 0.0},
}
BEFORE["fulldisk16.session"] = BEFORE["fulldisk16.single"]

# the roofline readers' bytes a scan for these cells at the SMALL size and
# a 512 x 551 product, as they counted them before
BYTES = {
    "fulldisk16": {"sum_max_roofline": 29884416, "recon_roofline": 1843200,
                   "hresample_roofline": 6256640,
                   "tile_hist_roofline": 2439168},
    "fulldisk8": {"sum_max_roofline": 15138816, "recon_roofline": 1228800,
                  "hresample_roofline": 6256640,
                  "tile_hist_roofline": 2439168},
}
BYTES["fulldisk16_folder"] = BYTES["fulldisk16"]


def _bytes(cell):
    """Each roofline reader's bytes a scan, read through a stand-in run."""
    run = types.SimpleNamespace(
        cell=cell, model=ScanModel.from_config(cell.config),
        product_shape=(512, 551), roofline_pct=lambda needle, b: b)
    return {m: load_reader(m)(run) for m in BYTES["fulldisk16"]}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_one_shift_cells_read_what_they_read_before(name):
    rec, _ = _run(name)
    assert rec["result"]["correct"]
    assert rec["numbers"] == BEFORE[name]
    assert list(rec["numbers"]) == list(BEFORE[name])
    cell = small_cell(name)
    assert _bytes(cell) == BYTES[cell.config_name]


def test_sweep_rooflines_count_every_shift():
    from shgbench import roofline

    cell = small_cell(SWEEP)
    m = ScanModel.from_config(cell.config)
    got = _bytes(cell)
    shifts = [10, 0, -10, -5, 5]           # read_scan's order of the disks
    floor = np.floor(m.line_center(np.arange(m.ih, dtype=np.float64)))
    taps = roofline.distinct_taps(floor, shifts, m.iw)
    assert got["recon_roofline"] == roofline.recon_bytes(
        m.frames, m.ih, m.sample_bytes, 5, taps)
    assert got["hresample_roofline"] == roofline.hresample_bytes(
        512, 551, m.frames, 5)
    assert got["tile_hist_roofline"] == 5 * roofline.tile_hist_bytes(512, 551)
    assert got["sum_max_roofline"] == BYTES["fulldisk16"]["sum_max_roofline"]


# -- faults of one shift ---------------------------------------------------------

def _farthest_pair(reference):
    """The two shifts whose reference products lie farthest apart."""
    p = reference["sweep"]["products"]
    return max(itertools.combinations(SHIFTS, 2), key=lambda ab: compare.
               image_numbers(p[ab[0]]["clahe"], p[ab[1]]["clahe"])[
                   "png_off_pct"])


def _png_missing(monkeypatch, reference):
    """One shift's product PNG is never written."""
    save = products._save_png

    def _save_png(path, img):
        if "_shift=5_" not in path:
            save(path, img)

    monkeypatch.setattr(products, "_save_png", _save_png)


def _png_unasked(monkeypatch, reference):
    """A product PNG of a shift nobody asked for is written beside one."""
    save = products._save_png

    def _save_png(path, img):
        save(path, img)
        if "_shift=5_" in path:
            save(path.replace("_shift=5_", "_shift=7_"), img)

    monkeypatch.setattr(products, "_save_png", _save_png)


def _batched_warp_off(monkeypatch, reference):
    """The sweep's batched warp uses a Y/X ratio 1% off the fitted one."""
    orig = run_mod.correct_images_batched

    def correct_images_batched(stack, phi, ratio, *a, **k):
        return orig(stack, phi, ratio * 1.01, *a, **k)

    monkeypatch.setattr(run_mod, "correct_images_batched",
                        correct_images_batched)


def _products_swapped(monkeypatch, reference):
    """The farthest pair of shifts write each other's products."""
    a, b = _farthest_pair(reference)
    orig = run_mod.single_image_process
    names = {f"_shift={a}": f"_shift={b}", f"_shift={b}": f"_shift={a}"}

    def single_image_process(frame, hdr, options, circle, borders, basefich,
                             *args, **k):
        stem, shift = basefich.rsplit("_shift=", 1)
        basefich = stem + names.get("_shift=" + shift, "_shift=" + shift)
        return orig(frame, hdr, options, circle, borders, basefich, *args,
                    **k)

    monkeypatch.setattr(run_mod, "single_image_process", single_image_process)


def _frames_swapped(monkeypatch, reference):
    """The batched warp hands its first two shifts each other's disks."""
    orig = run_mod.correct_images_batched

    def correct_images_batched(stack, *a, **k):
        warped, *rest = orig(stack, *a, **k)
        return (torch.stack([warped[1], warped[0], *warped[2:]]), *rest)

    monkeypatch.setattr(run_mod, "correct_images_batched",
                        correct_images_batched)


FAULTS = {"png_missing": _png_missing, "png_unasked": _png_unasked,
          "batched_warp_off": _batched_warp_off,
          "products_swapped": _products_swapped,
          "frames_swapped": _frames_swapped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_one_shift_is_not_correct(monkeypatch, reference, fault):
    FAULTS[fault](monkeypatch, reference)
    rec, err = _run(SWEEP)
    # every scan ran: the comparison, not a crash, says not correct
    assert rec["result"]["failed"] == 0
    assert not rec["result"]["correct"], rec["result"]["checks"]
    if fault in ("png_missing", "png_unasked"):
        assert "shgbench: products of shifts" in err
