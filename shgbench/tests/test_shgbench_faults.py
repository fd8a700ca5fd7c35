"""The comparison that decides ``correct``: a sound run passes, the control
and a run with the timed path broken underneath fail.  Runs the harness
past its look for a card, on the CPU at a small size."""

import io
import time

import numpy as np
import pytest
import torch

from shgbench import compare
from shgbench.generator import ScanFile, ScanModel
from shgbench.harness import load_cell, load_reference, run_cell
from solex_ser_recon_en_torch.ops import fused
from solex_ser_recon_en_torch.pipeline import products
from solex_ser_recon_en_torch.pipeline import run as run_mod

from .conftest import small_cell, small_override

CPU = torch.device("cpu")
CELLS = ["fulldisk16.single", "fulldisk8.single", "fulldisk16.session",
         "fulldisk16.sweep5"]


def _run(name, seed=2 ** 31 + 99):
    cell = small_cell(name)
    if cell.mix["kind"] == "session":
        cell.mix["files"] = 3
    rec = {}
    rc = run_cell(cell, seed, 0.5, False, CPU, time.perf_counter(),
                  out=io.StringIO(), err=io.StringIO(), record=rec)
    assert rc == 0
    return rec["result"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


def _unchanged_disks(monkeypatch):
    """Pass B returns its disks as they were made: all zero."""
    orig = fused.RawScanProcessor.reconstruct

    def reconstruct(self, *a, **k):
        return torch.zeros_like(orig(self, *a, **k))

    monkeypatch.setattr(fused.RawScanProcessor, "reconstruct", reconstruct)


def _half_the_frames(monkeypatch):
    """Pass A sums the first half of the frames only and divides by their
    count; pass B still sees every frame."""
    orig_acc = fused.RawScanProcessor.accumulate
    orig_mm = fused.RawScanProcessor.mean_max
    half = small_override(load_cell(CELLS[0]).config)["frames"] // 2

    def accumulate(self, start, chunk, keep=True, shard=0):
        k = max(0, min(chunk.shape[0], half - start))
        if k:
            orig_acc(self, start, chunk[:k], False, shard)
        self._left_out = getattr(self, "_left_out", 0) + chunk.shape[0] - k
        if keep:
            self._pieces.append((start, chunk, shard))

    def mean_max(self):
        out = orig_mm(self)
        self.count += getattr(self, "_left_out", 0)
        return out

    monkeypatch.setattr(fused.RawScanProcessor, "accumulate", accumulate)
    monkeypatch.setattr(fused.RawScanProcessor, "mean_max", mean_max)


def _altered_answer(monkeypatch):
    """The product image's top quarter inverted where it is made."""
    orig = products._products_body

    def body(fj, want=(True, True)):
        cl1, cc, hc, pr = orig(fj, want)
        cc = cc.clone()
        q = cc.shape[0] // 4
        cc[:q] = (65535 - cc[:q].to(torch.int32)).to(torch.uint16)
        return cl1, cc, hc, pr

    monkeypatch.setattr(products, "_products_body", body)


def _transversalium_skipped(monkeypatch):
    """The transversalium row gain comes back as ones where it is made."""
    orig = run_mod.transversalium_gain

    def gain(*a, **k):
        c, y1, y2, corr = orig(*a, **k)
        return np.ones_like(c), y1, y2, corr

    monkeypatch.setattr(run_mod, "transversalium_gain", gain)


def _warp_off(monkeypatch):
    """The circularisation warps with a Y/X ratio 1% off the fitted one."""
    orig = run_mod._warp_fixed

    def warp_fixed(disk, phi, ratio, log=None):
        return orig(disk, phi, ratio * 1.01, log=log)

    monkeypatch.setattr(run_mod, "_warp_fixed", warp_fixed)


FAULTS = {"state_unchanged": _unchanged_disks,
          "half_the_batch": _half_the_frames,
          "answer_altered": _altered_answer,
          "transversalium_skipped": _transversalium_skipped,
          "warp_off": _warp_off}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["fulldisk16.single", "fulldisk16.session"])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["fulldisk16.single", "fulldisk8.single",
                                  "fulldisk16.sweep5"])
def test_control_fails_the_limits(tmp_path, name):
    """The reference on samples cut to the configuration's control bits,
    in the program's place, fails the cell's limits: each requested
    shift's products against the reference's of that shift."""
    cell = small_cell(name)
    ref_mod = load_reference(cell.config)
    scan = ScanFile(ScanModel.from_config(cell.config), 2 ** 31 + 3, CPU,
                    str(tmp_path / "s.ser"))
    shifts = list(cell.mix["options"]["shift"])
    ref = ref_mod.run(scan.path, shifts=shifts)
    low = ref_mod.run(scan.path, shifts=shifts,
                      bits=int(cell.config["control_bits"]))
    nums = compare.control_numbers(low, ref)
    chk = compare.checks(nums, cell.limits)
    assert not compare.passed(chk)
    assert chk["passa_mean_lsb"]["value"] > 0
    assert np.isfinite(list(nums.values())).all()
    scan.close()
