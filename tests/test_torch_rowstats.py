"""The transversalium row statistics' entry point on the CPU
(ops/rowstats.py:row_stats) and the order its plain twin fixes.

The kernel (csrc/rowstats.cu) runs only on the card and is held to the
plain twin there (tests/test_torch_cuda_kernels.py).  Here: CPU tensors take
the twin and count under ``plain``, other devices raise, the twin's masked
median equals the numpy twin of the host pipeline bit for bit on the rows
whose order the kernel reproduces (NaN, +-inf, -0.0, no valid entry, one
valid entry), and the twin's strip mask equals the host's chord bounds on
the edge geometries.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from solex_ser_recon_en_torch.ops import rowstats
from solex_ser_recon_en_torch.pipeline import transversalium
from torch_parity import limb_darkened_disk, t

INF = np.float32(np.inf)
NAN = np.float32(np.nan)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.float64])
def test_row_stats_takes_the_plain_twin_on_the_cpu(dtype):
    img = limb_darkened_disk(120, 150, 3).astype(dtype)
    circle, borders = (75.5, 60.0, 50.0), [0.0, 0.0, 149.0, 119.0]
    before = dict(rowstats.ROW_STATS_LAUNCHES)
    got = rowstats.row_stats(t(img), circle, borders)
    assert rowstats.ROW_STATS_LAUNCHES == {
        "kernel": before["kernel"], "plain": before["plain"] + 1}
    valid, _, _ = rowstats.strip_mask(
        120, 150, np.asarray(circle, dtype=np.float32),
        np.asarray(borders, dtype=np.float32), torch.device("cpu"))
    want = rowstats.row_log_ratio_stats(t(img), valid)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (120,)
        assert torch.equal(a, b)
    assert bool((got[1] != 0).any())


def test_row_stats_refuses_other_devices():
    img = torch.empty((8, 8), dtype=torch.uint16, device="meta")
    before = dict(rowstats.ROW_STATS_LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        rowstats.row_stats(img, (4.0, 4.0, 3.0), [0.0, 0.0, 7.0, 7.0])
    assert rowstats.ROW_STATS_LAUNCHES == before


def test_transversalium_gain_counts_one_plain_call_on_the_cpu():
    img = limb_darkened_disk(120, 150, 4)
    before = dict(rowstats.ROW_STATS_LAUNCHES)
    transversalium.transversalium_gain(t(img), (75.0, 60.0, 50.0),
                                       [0.0, 0.0, 149.0, 119.0], 31)
    assert rowstats.ROW_STATS_LAUNCHES == {
        "kernel": before["kernel"], "plain": before["plain"] + 1}


# rows of (values, valid) for the masked median; W = 8 columns each
MEDIAN_ROWS = {
    "nan": [([NAN, 1, 2, 3, NAN, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0]),
            ([NAN, NAN, NAN, 2, 5, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0])],
    "nan_past_padding": [([NAN] * 7 + [1], [1] * 8),
                         ([NAN] * 6 + [1, 0], [1] * 7 + [0])],
    "posinf": [([INF, 1, INF, 2, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0]),
               ([INF, INF, INF, 2, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0])],
    "neginf": [([-INF, -INF, -INF, 2, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0]),
               ([-INF, INF, 1, 2, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0])],
    "negzero": [([-0.0, -0.0, 1, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0, 0, 0]),
                ([-0.0, 1, 0, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0]),
                ([-0.0, 0.0, 5, 6, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0])],
    "all_invalid": [([3, 1, NAN, -INF, 0, 0, 0, 0], [0] * 8)],
    "one_valid": [([9, 1, 2, 3, 4, 5, 6, 7], [0, 0, 1, 0, 0, 0, 0, 0]),
                  ([NAN, 1, 2, 3, 4, 5, 6, 7], [1, 0, 0, 0, 0, 0, 0, 0])],
    "two_valid": [([9, 1, 2, 3, 4, 5, 6, 7], [0, 0, 1, 0, 0, 0, 0, 1]),
                  ([INF, 1, 2, 3, 4, 5, 6, 7], [1, 0, 0, 0, 1, 0, 0, 0])],
}


@pytest.mark.parametrize("kind", sorted(MEDIAN_ROWS))
def test_masked_row_median_twin_equals_numpy(kind):
    """The torch twin's masked median = numpy's (np.sort's order), bit for
    bit, NaN equal to NaN: invalid entries as +inf, NaN after them."""
    rows = MEDIAN_ROWS[kind]
    x = np.array([r for r, _ in rows], dtype=np.float32)
    valid = np.array([v for _, v in rows], dtype=bool)
    got = rowstats._masked_row_median(torch.from_numpy(x),
                                      torch.from_numpy(valid)).numpy()
    with np.errstate(invalid="ignore"):
        want = transversalium._masked_row_median_host(x, valid)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  want[keep].view(np.int32))


# (h, w, circle, borders) at the edges of the chord geometry
STRIP_GEOMETRIES = {
    "backup_circle": (300, 340, (0, 0, 99999), [0, 50, 339, 250]),
    "cut_left": (200, 240, (120.5, 100.0, 90.0), [60.0, 0, 239, 199]),
    "cut_right": (200, 240, (120.5, 100.0, 90.0), [0, 0, 170.5, 199]),
    "cut_top_bottom": (200, 240, (120.0, 100.0, 90.0), [0, 33.5, 239, 150]),
    "off_left_edge": (200, 240, (-20.0, 100.0, 90.0), [0, 0, 239, 199]),
    "above_the_image": (200, 240, (120.0, -300.0, 90.0), [0, 0, 239, 199]),
    "tiny_circle": (40, 60, (30.5, 20.0, 2.5), [0, 0, 59, 39]),
}


@pytest.mark.parametrize("name", sorted(STRIP_GEOMETRIES))
def test_strip_mask_equals_the_host_chord_bounds(name):
    h, w, circle, borders = STRIP_GEOMETRIES[name]
    valid, _, _ = rowstats.strip_mask(
        h, w, np.asarray(circle, dtype=np.float32),
        np.asarray(borders, dtype=np.float32), torch.device("cpu"))
    row_ok, lo, hi = transversalium._strip_bounds_host(h, w, circle, borders)
    xs = np.arange(w)
    chords = row_ok[:, None] & (xs >= lo[:, None]) & (xs < hi[:, None])
    np.testing.assert_array_equal(valid.numpy(), chords)
    np.testing.assert_array_equal(
        valid.numpy(), transversalium._strip_mask_host(h, w, circle, borders))
    if name != "above_the_image":
        assert valid.any()
    else:
        assert not valid.any()
