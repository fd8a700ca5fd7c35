"""The comparison's own pieces: the PNG reader against the port's writer,
and the timed path's stages that a run captures for the comparison."""

import io
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from shgbench import compare
from shgbench.harness import run_cell
from solex_ser_recon_en_torch.io.png import write_png_streaming

from .conftest import small_cell


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_read_png_reads_the_port_writer(tmp_path, dtype):
    rng = np.random.default_rng(5)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (37, 53)).astype(dtype)
    path = str(tmp_path / "a.png")
    write_png_streaming(path, img)
    out = compare.read_png(path)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, img)


def _png(rows, ftypes, w):
    """An 8-bit grey PNG whose scanlines carry the given filter bytes."""
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    raw = b"".join(bytes([f]) + bytes(r) for f, r in zip(ftypes, rows))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, len(rows), 8, 0, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [1, 2, 3, 4])
def test_read_png_refuses_other_filters(tmp_path, ftype):
    path = tmp_path / "f.png"
    path.write_bytes(_png([[1, 2], [3, 4]], [0, ftype], 2))
    with pytest.raises(ValueError, match="filter"):
        compare.read_png(str(path))


@pytest.mark.parametrize("name", ["fulldisk16.single", "fulldisk16.session"])
def test_run_compares_the_warp_and_the_gain(name):
    """The circularised disk and the row gain come from the timed path's
    own calls and are compared with the reference's."""
    cell = small_cell(name)
    if cell.mix["kind"] == "session":
        cell.mix["files"] = 2
    rec = {}
    rc = run_cell(cell, 2 ** 31 + 7, 0.3, False, torch.device("cpu"),
                  time.perf_counter(), out=io.StringIO(), err=io.StringIO(),
                  record=rec)
    assert rc == 0 and rec["result"]["correct"]
    nums = rec["numbers"]
    assert nums["warp_shape_px"] == 0
    assert nums["warp_off_pct"] == 0 and nums["warp_max_lsb"] <= 1
    # the control reads ~6e-3 here, a skipped transversalium ~0.12
    assert 0 <= nums["gain_max"] < 1e-3
