"""Frozen yardsticks of the kernels' rooflines: published peaks and the
bytes each kernel's work needs for one ``-c`` scan.

Each function counts every input byte once and every output byte once per
scan, whatever a kernel reads again or however many launches it takes.
All four kernels are bound by bytes (their operations per byte are far
below the card's ratio of peak FLOP/s to bandwidth).
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, at the full 700 W power limit)
PEAKS = {
    "NVIDIA H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}


def peak_bandwidth(kind: str) -> float:
    """Published HBM bandwidth of the card named ``kind``."""
    for name, peak in PEAKS.items():
        if kind.startswith(name):
            return peak["hbm_bytes_per_s"]
    raise KeyError(f"no published peak for {kind!r}")


def sum_max_bytes(frames: int, ih: int, iw: int, sample_bytes: int) -> int:
    """Pass A: every raw sample read once; the int32 sum and the maximum
    (int32) of every pixel written once."""
    return frames * ih * iw * sample_bytes + 2 * ih * iw * 4


def recon_bytes(frames: int, ih: int, sample_bytes: int, shifts: int,
                taps: int) -> int:
    """Kernel B3: the distinct tap samples of every frame read once
    (``taps`` in all over a frame's rows, ``distinct_taps``), and the
    (shifts, ih, frames) uint16 disks written once."""
    return frames * taps * sample_bytes + shifts * ih * frames * 2


def hresample_bytes(out_h: int, out_w: int, in_w: int, images: int = 1) -> int:
    """Kernel B4 at its interface: the float32 row-lerped rows (images,
    out_h, in_w), the int32 tap columns and the two float32 weights
    (out_h, out_w), the float32 outside term and the float32 result
    (images, out_h, out_w), each once."""
    return 4 * (images * out_h * in_w + 3 * out_h * out_w
                + 2 * images * out_h * out_w)


def tile_hist_bytes(h: int, w: int) -> int:
    """Kernel B5 on one product image: the uint16 image read twice (the
    CLAHE's tile histograms with the whole image's, then the CLAHE
    image's own histogram) and 5 x 65536 int32 bins written once."""
    return 2 * h * w * 2 + 5 * 65536 * 4


def distinct_taps(floor_cols, shifts, iw: int) -> int:
    """Distinct tap columns of one frame, summed over its rows: row y reads
    columns c and c + 1, c = clip(floor_cols[y] + s, 0, iw - 2), of each
    shift s."""
    total = 0
    for f in floor_cols:
        cols = set()
        for s in shifts:
            c = min(max(int(f) + s, 0), iw - 2)
            cols.update((c, c + 1))
        total += len(cols)
    return total
