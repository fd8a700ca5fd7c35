"""The frozen byte counts of the kernels' rooflines for the cells' shapes."""

import json

import numpy as np
import pytest

from shgbench import roofline
from shgbench.generator import ScanModel
from shgbench.harness import ROOT

PEAK = 3.35e12


def _model(name):
    with open(ROOT / "shgbench" / "configs" / f"{name}.json") as f:
        return ScanModel.from_config(json.load(f))


@pytest.mark.parametrize("name,sample,passa_ms,recon_ms", [
    ("fulldisk16", 2, 0.73508, 0.01468),
    ("fulldisk8", 1, 0.36826, 0.00979),
])
def test_pass_a_and_b3_bytes(name, sample, passa_ms, recon_ms):
    m = _model(name)
    assert (m.frames, m.ih, m.iw, m.sample_bytes) == (2000, 2048, 300, sample)
    b = roofline.sum_max_bytes(m.frames, m.ih, m.iw, m.sample_bytes)
    assert b == 2000 * 2048 * 300 * sample + 2 * 2048 * 300 * 4
    assert b / PEAK * 1e3 == pytest.approx(passa_ms, rel=1e-4)
    floor = np.floor(m.line_center(np.arange(m.ih, dtype=np.float64)))
    taps = roofline.distinct_taps(floor, [10, 0], m.iw)
    assert taps == 4 * m.ih            # shifts 10 apart never share a tap
    rb = roofline.recon_bytes(m.frames, m.ih, m.sample_bytes, 2, taps)
    assert rb / PEAK * 1e3 == pytest.approx(recon_ms, rel=1e-3)


def test_post_kernel_bytes_at_the_product_size():
    # the -c product of the bench scan is 2048 x 2204, warped from 2000 columns
    hb = roofline.hresample_bytes(2048, 2204, 2000)
    assert hb / PEAK * 1e3 == pytest.approx(0.03185, rel=1e-3)
    tb = roofline.tile_hist_bytes(2048, 2204)
    assert tb / PEAK * 1e3 == pytest.approx(0.00578, rel=1e-3)


def test_distinct_taps_counts_shared_columns_once():
    assert roofline.distinct_taps([5, 5], [0, 1], 100) == 6
    assert roofline.distinct_taps([0], [-3, 0], 100) == 2    # both clip to 0
    assert roofline.distinct_taps([98], [10], 100) == 2      # clipped to 98


def test_peak_by_card_name():
    assert roofline.peak_bandwidth("NVIDIA H100 80GB HBM3") == PEAK
    with pytest.raises(KeyError):
        roofline.peak_bandwidth("cpu")
