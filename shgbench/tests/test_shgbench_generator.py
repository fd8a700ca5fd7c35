"""The benchmark's generator against the port's SyntheticScan."""

import numpy as np
import torch

from shgbench.generator import ScanFile, ScanModel, render_blocks
from solex_ser_recon_en_torch.io.ser import SerReader
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan


def _model(depth: int, noise: float) -> ScanModel:
    return ScanModel(frames=90, ih=160, iw=48, depth=depth,
                     line_poly=(24.0, 0.005, -2e-6, 1e-9), squash_y=1.08,
                     shear=0.02, disk_radius=float(int(0.42 * 90)),
                     trans_stripes=0.08, noise=noise)


def _synthetic(m: ScanModel) -> np.ndarray:
    s = SyntheticScan(ih=m.ih, iw=m.iw, frames=m.frames, depth=m.depth,
                      line_poly=m.line_poly, squash_y=m.squash_y,
                      shear=m.shear, disk_radius=m.disk_radius,
                      trans_stripes=m.trans_stripes, noise=m.noise, seed=5)
    return np.rot90(s.generate(), k=-1, axes=(1, 2))


def _rendered(m: ScanModel, seed: int) -> np.ndarray:
    blocks = [b.numpy() for _, b in render_blocks(m, seed, torch.device("cpu"),
                                                  block=32)]
    out = np.concatenate(blocks)
    return out if m.depth == 8 else out.view(np.uint16)


def test_frames_equal_synthetic_scan_without_noise():
    for depth in (16, 8):
        m = _model(depth, 0.0)
        np.testing.assert_array_equal(_rendered(m, 123), _synthetic(m))


def test_noise_has_the_model_sigma_and_follows_the_seed():
    m = _model(16, 0.002)
    a, b = _rendered(m, 2 ** 31 + 11), _rendered(m, 2 ** 31 + 11)
    np.testing.assert_array_equal(a, b)
    c = _rendered(m, 2 ** 31 + 12)
    assert np.count_nonzero(a != c) > a.size // 2
    clean = _synthetic(_model(16, 0.0)).astype(np.float64)
    inside = (clean > 2000) & (clean < 60000)
    diff = (a.astype(np.float64) - clean)[inside]
    assert abs(diff.mean()) < 2.0
    assert abs(diff.std() / (0.002 * 65535) - 1.0) < 0.05


def test_scan_file_reads_back_as_a_ser(tmp_path):
    m = _model(16, 0.002)
    f = ScanFile(m, 77, torch.device("cpu"), str(tmp_path / "s.ser"))
    r = SerReader(f.path)
    assert (r.frame_count, r.ih, r.iw) == (m.frames, m.ih, m.iw)
    np.testing.assert_array_equal(np.asarray(r.raw_frames(0, m.frames)),
                                  _rendered(m, 77))
    f.close()
    assert not (tmp_path / "s.ser").exists()
