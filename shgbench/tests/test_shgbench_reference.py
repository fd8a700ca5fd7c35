"""The frozen reference against the port's replica and the port's
documented stages, on a small scan (CPU)."""

import numpy as np
import torch

from shgbench.generator import ScanFile, ScanModel
from shgbench.reference import shg_c
from solex_ser_recon_en_torch.geometry.correct import ellipse_to_circle
from solex_ser_recon_en_torch.geometry.linefit import fit_spectral_line
from solex_ser_recon_en_torch.utils import cpu_reference as replica


def _scan(tmp_path, depth=16):
    m = ScanModel(frames=300, ih=512, iw=96, depth=depth,
                  line_poly=(48.0, 0.005, -2e-6, 1e-9), squash_y=1.08,
                  shear=0.02, disk_radius=126.0, trans_stripes=0.08,
                  noise=0.002)
    return ScanFile(m, 2 ** 31 + 5, torch.device("cpu"),
                    str(tmp_path / f"s{depth}.ser"))


def test_stages_equal_the_replica_and_the_port(tmp_path):
    for depth in (16, 8):
        f = _scan(tmp_path, depth)
        frames, d, rot = shg_c.read_ser(f.path)
        mean, mx = shg_c.mean_max(frames, d, rot)
        rmean, rmx = replica.cpu_mean_max(f.path)
        np.testing.assert_array_equal(mean, rmean)
        np.testing.assert_array_equal(mx, rmx)
        fit = shg_c.line_fit(mean, mx)
        port = fit_spectral_line(np.ascontiguousarray(mean),
                                 np.ascontiguousarray(mx))
        np.testing.assert_array_equal(fit["curve"], port.curve)
        disks = shg_c.recon(frames, d, rot, fit["floor"], fit["frac"], [10, 0])
        rep = replica.cpu_recon(f.path, np.stack([fit["floor"], fit["frac"]],
                                                 axis=1), [10, 0])
        np.testing.assert_array_equal(disks, np.stack(rep))
        cl = shg_c.clahe_u16(disks[1])
        np.testing.assert_array_equal(cl, replica._clahe_u16(disks[1]))
        geo = shg_c.geometry(disks[0])
        pg = ellipse_to_circle(torch.from_numpy(disks[0].astype(np.int32)).to(
            torch.uint16), need_image=False)
        assert abs(geo["ratio"] / pg.ratio - 1) < 1e-9
        assert abs(geo["phi"] - pg.phi) < 1e-9
        np.testing.assert_allclose(geo["circle"], pg.circle, rtol=1e-9)
        del frames
        f.close()


def test_run_is_deterministic_and_bits_cut_the_samples(tmp_path):
    f = _scan(tmp_path)
    a = shg_c.run(f.path)
    b = shg_c.run(f.path)
    np.testing.assert_array_equal(a["clahe"], b["clahe"])
    low = shg_c.run(f.path, bits=8)
    assert np.abs(low["mean"].astype(int) - a["mean"]).max() > 64
    f.close()
