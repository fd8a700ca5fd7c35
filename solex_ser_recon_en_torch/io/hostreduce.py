"""Host passes A and B of the ``host`` and ``band`` feeds.

Counterpart of solex_ser_recon_en_tpu/io/hostreduce.py.  Pass A (the int
sum and max over every frame) and pass B (the float64 two-tap recon) run on
the host, over the SER's page cache, through the native library
(io/native.py: ``ser_mean_max``, ``ser_mean_max_band``,
``ser_sample_stats``, ``ser_band_stats``, ``ser_recon_f64``), with the same
uint64 sums, reference truncation and float64 arithmetic as the JAX module,
so every result is bit-identical to it.

The numpy forms of the native sweeps stay beside them: ``NATIVE`` False
runs them instead (the tests hold each native sweep to its numpy twin).
Where the JAX module degrades to numpy when the library is missing or a
native call fails, this one raises.

``fast_passa`` is the two-step pass A of the ``host`` feed: a frame
subsample locates the spectral band, then a native sweep reads only the
band's bytes of every frame and a banded line fit verifies that its fit is
the full-sweep fit.  A verification miss is not an error: it returns None
and the caller takes the full sweep.  ``EXACT_PASSA``,
``FAST_PASSA_MARGIN`` and ``FAST_PASSA_MIN_BYTES`` take the place of the
JAX module's environment switches (``SOLEX_EXACT_PASSA``,
``SOLEX_FASTPASSA_MARGIN``, ``SOLEX_FASTPASSA_MIN_MB``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.recon import build_shift_indices
from .native import NativeSerReader, recon_chunk
from .ser import SerReader

#: the native sweeps; False runs their numpy twins (tests)
NATIVE = True
#: True always takes the full sweep (the JAX package's SOLEX_EXACT_PASSA=1)
EXACT_PASSA = False
#: spectral columns of slack on each side of the subsample's band: 18 is
#: the smallest that keeps the banded fit's gates clear on the JAX
#: package's bench corpus (blur half-window 12 + the subsample's drift);
#: too small only costs a verified fall back to the full sweep
FAST_PASSA_MARGIN = 18
#: scans below this raw size take the full sweep: the two-step pays only
#: when the avoided read is large
FAST_PASSA_MIN_BYTES = 256 * 1024**2


def _finalize_mean_max(
    acc: np.ndarray, mx: np.ndarray, r: SerReader, frames: int = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Raw-layout (sum, max) -> normalised-orientation (mean u16, max u16).

    ``frames`` overrides the divisor for subsampled accumulations
    (provisional_spectral_band)."""
    if r.flag_rotate:
        acc = np.rot90(acc)
        mx = np.rot90(mx)
    scale = 256 if r.header.pixel_depth == 8 else 1
    n = r.frame_count if frames is None else frames
    mean = ((acc.astype(np.float64) * scale) / n).astype(np.uint16)
    mx16 = mx.astype(np.uint16)
    if r.header.pixel_depth == 8:
        mx16 = mx16 << 8
    return mean, np.ascontiguousarray(mx16)


def host_mean_max_frames(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/max of an in-memory normalised (F, ih, iw) uint16 stack.

    The host pass A for non-SER sources (AVI) on CPU-only hosts — same
    truncating arithmetic as the reference accumulator
    (solex_util.py:174-188)."""
    n = frames.shape[0]
    acc = frames.sum(axis=0, dtype=np.uint64)
    mean = (acc.astype(np.float64) / n).astype(np.uint16)
    return mean, frames.max(axis=0)


def _weights(fit_frac) -> Tuple[np.ndarray, np.ndarray]:
    frac = np.asarray(fit_frac, dtype=np.float64)
    return 1.0 - frac, frac


def _recon_loop(src, F: int, flat_l: np.ndarray, right_off: int, w_l, w_r,
                upscale: bool, out: np.ndarray, chunk_frames: int) -> None:
    """Pass B over ``src(start, n)`` chunks of frames into ``out``:
    ``ser_recon_f64`` (NATIVE) or the numpy twin, the same float64
    interpolation and truncating uint16 store (solex_util.py:113-134)."""
    S, ih = flat_l.shape
    for start in range(0, F, chunk_frames):
        n = min(chunk_frames, F - start)
        chunk = src(start, n)
        if NATIVE:
            recon_chunk(chunk, flat_l, right_off, w_l, w_r, upscale, out,
                        start)
            continue
        raw2 = chunk.reshape(n, -1)
        for si in range(S):
            left = np.take(raw2, flat_l[si], axis=1)
            right = np.take(raw2, flat_l[si] + right_off, axis=1)
            vals = left * w_l
            vals += right * w_r
            if upscale:
                vals *= 256.0
            out[si, :, start:start + n] = vals.T  # truncating u16 store


def host_reconstruct_frames(
    frames: np.ndarray,
    fit_floor: np.ndarray,
    fit_frac: np.ndarray,
    shifts,
    chunk_frames: int = 512,
) -> np.ndarray:
    """Multi-shift recon from an in-memory normalised (F, ih, iw) uint16
    stack (the pass B of host_mean_max_frames), float64,
    reference-exact."""
    F, ih, iw = frames.shape
    ind_l, _ = build_shift_indices(fit_floor, fit_frac, list(shifts), iw)
    w_l, w_r = _weights(fit_frac)
    out = np.empty((len(ind_l), ih, F), dtype=np.uint16)
    frames = np.ascontiguousarray(frames, dtype=np.uint16)
    # normalised frames index flat as y*iw + il, the right neighbour +1
    flat_l = np.arange(ih, dtype=np.int64)[None, :] * iw + ind_l.astype(
        np.int64)
    _recon_loop(lambda s, n: frames[s:s + n], F, flat_l, 1, w_l, w_r, False,
                out, chunk_frames)
    return out


def _numpy_stats(r: SerReader, rect=None, chunk_frames: int = 256):
    """numpy twin of the native sweeps: (sum u64, max, band slab or None)
    over every frame, of the raw rectangle ``rect`` (r0, r1, c0, c1) for
    the band slab."""
    h, w = r.header.height, r.header.width
    acc = np.zeros((h, w), dtype=np.uint64)
    mx = np.zeros((h, w), dtype=r.header.dtype)
    band = None
    if rect is not None:
        r0, r1, c0, c1 = rect
        band = np.empty((r.frame_count, r1 - r0, c1 - c0), r.header.dtype)
    for start in range(0, r.frame_count, chunk_frames):
        n = min(chunk_frames, r.frame_count - start)
        raw = r.raw_frames(start, n)
        acc += raw.sum(axis=0, dtype=np.uint64)
        np.maximum(mx, raw.max(axis=0), out=mx)
        if band is not None:
            band[start:start + n] = raw[:, r0:r1, c0:c1]
    return acc, mx, band


def host_mean_max(r: SerReader) -> Tuple[np.ndarray, np.ndarray]:
    """Normalised-orientation mean/max of a SER scan on the host, in one
    native sweep (``ser_mean_max``; uint64 sums, reference truncation)."""
    if NATIVE:
        with NativeSerReader(r.path) as nr:
            acc, mx = nr.mean_max()
    else:
        acc, mx, _ = _numpy_stats(r)
    return _finalize_mean_max(acc, mx, r)


def _band_rect(r: SerReader, x0: int, x1: int) -> Tuple[int, int, int, int]:
    """Raw-frame rectangle (r0, r1, c0, c1) covering spectral cols [x0, x1).

    Wide-stored scans (flag_rotate) keep the spectral axis on raw ROWS,
    tall-stored on raw columns.
    """
    if r.flag_rotate:
        return x0, x1, 0, r.header.width
    return 0, r.header.height, x0, x1


def host_mean_max_band(
    r: SerReader, x0: int, x1: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pass A and the spectral band's extraction in ONE sweep over the scan
    (``ser_mean_max_band``).

    Returns (mean, max, band): mean/max equal host_mean_max's, band is the
    raw-layout slab of spectral columns [x0, x1) of every frame, equal to
    extract_band over all frames.
    """
    rect = _band_rect(r, x0, x1)
    if NATIVE:
        with NativeSerReader(r.path) as nr:
            acc, mx, band = nr.mean_max_band(*rect)
    else:
        acc, mx, band = _numpy_stats(r, rect)
    mean, mx16 = _finalize_mean_max(acc, mx, r)
    return mean, mx16, band


def provisional_spectral_band(
    r: SerReader, shifts, margin: int = 12, target_frames: int = 64
) -> Tuple[int, int]:
    """The recon's spectral band estimated from a sparse frame subsample
    (about ``target_frames`` frames) and ``margin`` columns of slack.
    Callers verify the band against the final fit (band_covers) before
    they use it."""
    from ..geometry.linefit import fit_spectral_line

    F = r.frame_count
    step = max(1, F // target_frames)
    h, w = r.header.height, r.header.width
    acc = np.zeros((h, w), dtype=np.uint64)
    mx = np.zeros((h, w), dtype=r.header.dtype)
    n = 0
    for start in range(0, F, step):
        raw = r.raw_frames(start, 1)
        acc += raw[0]
        np.maximum(mx, raw[0], out=mx)
        n += 1
    mean, mx16 = _finalize_mean_max(acc, mx, r, frames=n)
    lf = fit_spectral_line(mean, mx16)
    return spectral_band(lf.floor, shifts, r.iw, margin=margin)


def fast_passa(r: SerReader, shifts, sample_target: int = 64,
               margin: int = None, miss: Optional[List[str]] = None):
    """Two-step pass A: a frame subsample (``ser_sample_stats``) locates
    the spectral band and the sun's vertical extent, then a sweep of every
    frame reads ONLY the band's bytes (``ser_band_stats``), about 1/5 of a
    Sol'Ex scan.

    Returns (LineFit, mean_band, max_band, x0, x1), the fit bit-identical
    to the full sweep's whenever the banded fit's verification gates pass
    (geometry/linefit.py:fit_spectral_line_banded); or None, after
    appending the reason to ``miss`` when given, and the caller takes the
    full sweep.  A failed native call raises.
    """
    from ..geometry.linefit import fit_spectral_line, fit_spectral_line_banded

    def missed(why: str):
        if miss is not None:
            miss.append(why)
        return None

    if EXACT_PASSA:
        return missed("EXACT_PASSA is set")
    if margin is None:
        margin = FAST_PASSA_MARGIN
    nbytes = r.header.frame_bytes * r.frame_count
    if nbytes < FAST_PASSA_MIN_BYTES:
        return missed(f"the scan's {nbytes} bytes are under "
                      f"FAST_PASSA_MIN_BYTES ({FAST_PASSA_MIN_BYTES})")
    with NativeSerReader(r.path) as nr:
        step = max(1, r.frame_count // sample_target)
        acc_s, mx_s, n = nr.sample_stats(step)
        mean_sub, max_sub = _finalize_mean_max(acc_s, mx_s, r, frames=n)
        try:
            lf_sub = fit_spectral_line(mean_sub, max_sub)
        except ValueError as e:     # the fit's own refusal (no sun found)
            return missed(f"the subsample's line fit failed ({e})")
        x0, x1 = spectral_band(lf_sub.floor, shifts, r.iw, margin=margin)
        if (x1 - x0) * 3 >= r.iw:
            return missed(f"the band [{x0}, {x1}) covers a third or more "
                          f"of the {r.iw} spectral columns")
        acc_b, mx_b = nr.band_stats(*_band_rect(r, x0, x1))
    mean_band, max_band = _finalize_mean_max(acc_b, mx_b, r)
    lf = fit_spectral_line_banded(mean_band, max_band, x0, r.iw, lf_sub)
    if lf is None:
        return missed(f"the banded fit over [{x0}, {x1}) failed its "
                      "verification gates")
    return lf, mean_band, max_band, x0, x1


def band_covers(
    x0: int, x1: int, fit_floor: np.ndarray, fit_frac, shifts, iw: int
) -> bool:
    """True when spectral cols [x0, x1) contain every recon gather index."""
    ind_l, _ = build_shift_indices(fit_floor, fit_frac, list(shifts), iw)
    return int(ind_l.min()) >= x0 and int(ind_l.max()) + 1 <= x1 - 1


def _flat_taps(r: SerReader, il64: np.ndarray, row_elems: int):
    """(flat left-tap indices (S, ih), right-tap offset) in a raw frame
    (or band slab frame) viewed flat, ``row_elems`` elements a raw row.
    Rotated: norm[y, x] = raw[x, W-1-y], the right tap one raw row over;
    else raw[y, x], the right tap one element over."""
    ih = r.ih
    if r.flag_rotate:
        yrev = np.arange(ih - 1, -1, -1, dtype=np.int64)
        return il64 * row_elems + yrev[None, :], row_elems
    rows = np.arange(ih, dtype=np.int64)
    return rows[None, :] * row_elems + il64, 1


def host_reconstruct_from_band(
    r: SerReader,
    band: np.ndarray,
    x0: int,
    fit_floor: np.ndarray,
    fit_frac: np.ndarray,
    shifts,
    chunk_frames: int = 512,
) -> np.ndarray:
    """host_reconstruct gathering from a band slab of spectral columns
    [x0, x0 + bw) (host_mean_max_band's): the same float64 arithmetic, so
    bit-identical to it.  Callers check band_covers first."""
    F = r.frame_count
    ind_l, _ = build_shift_indices(fit_floor, fit_frac, list(shifts), r.iw)
    w_l, w_r = _weights(fit_frac)
    out = np.empty((len(ind_l), r.ih, F), dtype=np.uint16)
    il64 = ind_l.astype(np.int64) - x0          # band-local spectral index
    row_elems = r.header.width if r.flag_rotate else band.shape[2]
    flat_l, right_off = _flat_taps(r, il64, row_elems)
    _recon_loop(lambda s, n: band[s:s + n], F, flat_l, right_off, w_l, w_r,
                r.header.pixel_depth == 8, out, chunk_frames)
    return out


def host_reconstruct(
    r: SerReader,
    fit_floor: np.ndarray,
    fit_frac: np.ndarray,
    shifts,
    chunk_frames: int = 512,
) -> np.ndarray:
    """Multi-shift disk reconstruction on the host, float64,
    reference-exact (solex_util.py:113-134): the two taps of each (shift,
    row) gathered straight out of the SER memmap's page cache
    (``ser_recon_f64`` a chunk of frames), no copy of the scan."""
    F = r.frame_count
    ind_l, _ = build_shift_indices(fit_floor, fit_frac, list(shifts), r.iw)
    w_l, w_r = _weights(fit_frac)
    out = np.empty((len(ind_l), r.ih, F), dtype=np.uint16)
    flat_l, right_off = _flat_taps(r, ind_l.astype(np.int64),
                                   r.header.width)
    _recon_loop(r.raw_frames, F, flat_l, right_off, w_l, w_r,
                r.header.pixel_depth == 8, out, chunk_frames)
    return out


def spectral_band(
    fit_floor: np.ndarray, shifts, iw: int, margin: int = 2
) -> Tuple[int, int]:
    """Smallest spectral column range [x0, x1) the recon gathers from.

    reference consumer indices: clip(floor + shift, 0, iw-2) and +1
    (solex_util.py:113-119).
    """
    shifts = np.asarray(list(shifts), dtype=np.int64)
    lo = int(np.clip(fit_floor.min() + shifts.min(), 0, iw - 2)) - margin
    hi = int(np.clip(fit_floor.max() + shifts.max(), 0, iw - 2)) + 1 + 1 + margin
    return max(0, lo), min(iw, hi)


def extract_band(r: SerReader, x0: int, x1: int, start: int, count: int) -> np.ndarray:
    """Raw-layout band slab (count, ...) restricted to spectral cols [x0, x1).

    For wide-stored scans the spectral axis is the raw ROW axis; for tall
    storage it is the raw column axis.  Returns a contiguous copy.
    """
    raw = r.raw_frames(start, count)
    if r.flag_rotate:
        # raw (F, iw_spectral, W_spatial): spectral = axis 1
        return np.ascontiguousarray(raw[:, x0:x1, :])
    # raw (F, H_spatial, iw_spectral): spectral = axis 2
    return np.ascontiguousarray(raw[:, :, x0:x1])
