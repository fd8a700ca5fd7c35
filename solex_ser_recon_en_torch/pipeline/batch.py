"""Folder-batch grouping: same-shape small scans read as one group.

Counterpart of solex_ser_recon_en_tpu/pipeline/batch.py.  There a group of
B same-shape scans is staged as one (B, F, ih, iw) slab and reconstructed
by one vmapped device program, which amortises the TPU's per-dispatch
cost.  Here the slab goes to the device in one copy (at most SLAB_MB
of frames a copy), and each member's disks come from one launch of kernel
B3 (ops/recon_cuda.py:recon_chunks) over that member's frames: the
normalised frames, so with no rotate and no x256, which gives the values
read_scan's B3 computes from the raw layout bit for bit (x256 is exact in
float32).  The control plane stays per file, as there: each scan is read
whole on the host (io/video.py:read_all), its mean and max taken there
(io/hostreduce.py:host_mean_max_frames, the same truncating mean as
read_scan's pass A) and its line fit made; ellipse fit, transversalium and
products run per file in process_scan.

cli.main.handle_files does not call it.  On the H100 the group read was
2.6-3.6x slower than the session's overlapped per-file path for four
61 MB scans (PERF.md, the session's findings): it reads and sums each scan
on the host, where read_scan feeds the card from the pinned ring and sums
there, and a group read up front leaves nothing for the next scan's read
to hide.  It stays a library entry point with the JAX package's grouping,
held to read_scan member by member; a batched design that beats the
per-file path is ROADMAP A5's open item.

A group is >= MIN_FILES scans that share (frames, ih, iw), each of at most
MAX_MB (the JAX package's defaults; its environment switches are not
read); anything else, and every scan of options that ask for
``_mean.fits`` (save_fit), is left to read_scan.

Under a mesh (the members' ``Options.mesh``, or a prebuilt
parallel/mesh.py:Mesh) a group's members go over the mesh's batch rows in
contiguous runs and each member's frames over its row's frame shards
(parallel/mesh.py:frame_split), each piece uploaded to its own device:
kernel B3 runs once a piece there, and the pieces' columns are gathered,
in frame order, into the member's disks on the first device (the JAX
package's ('batch', 'frame') sharding of its vmapped program).  The disks
are bit-identical to the unsharded group read's: B3's arithmetic is per
column.
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Options, output_path
from ..utils.log import RunLog
from ..utils.timer import StageTimer

MIN_FILES = 3  # scans of one shape that make a group
MAX_MB = 64.0  # larger scans fill the card alone through the per-file feed
SLAB_MB = 512.0  # frames staged a copy: a 300-file folder must not stack 19 GB


def _group_key(path: str):
    """(frames, ih, iw) of a scan, or None when unreadable.

    SER headers are parsed directly (cheap); AVI goes through open_video
    (cv2 metadata only — frames are not decoded here)."""
    try:
        if path.lower().endswith(".ser"):
            from ..io.ser import SerReader

            r = SerReader(path)
            return (r.frame_count, r.ih, r.iw)
        from ..io.video import open_video

        v = open_video(path)
        return (v.frame_count, v.ih, v.iw)
    except Exception:
        return None


def read_scans_batched(
    tasks: List[Tuple[str, Options]],
    timers: Dict[str, StageTimer],
    device: torch.device,
    mesh=None,
) -> Dict[str, "object"]:
    """Batched read+recon for the same-shape groups within ``tasks``.

    Returns {file: ScanResult} for every file it handled; callers run the
    remaining files through the per-file read_scan.  A file that cannot be
    read or fitted is left to read_scan (and a group it leaves too small
    with it); the device work is not guarded: a kernel that fails raises,
    as everywhere in the port.  ``mesh``: a prebuilt mesh (default: built
    from the first task's ``Options.mesh`` on ``device``; its first device
    must be ``device``); a mesh larger than the visible cards raises.
    """
    from ..parallel.mesh import mesh_from_options, same_device

    if not tasks or tasks[0][1].save_fit:
        return {}  # _mean.fits wants read_scan's exact mean product path
    if mesh is None:
        mesh = mesh_from_options(tasks[0][1].mesh, device)
    elif not same_device(mesh.first, device):
        raise ValueError(f"the mesh's first device {mesh.first} is not the "
                         f"run's device {device}")
    max_bytes = int(MAX_MB * 1024**2)

    groups: Dict[tuple, List[Tuple[str, Options]]] = {}
    for file, opts in tasks:
        if not file.lower().endswith((".ser", ".avi")):
            continue
        try:
            if os.path.getsize(file) > max_bytes:
                continue
        except OSError:
            continue
        key = _group_key(file)
        if key is not None:
            groups.setdefault(key, []).append((file, opts))

    out: Dict[str, object] = {}
    for key, members in groups.items():
        if len(members) < MIN_FILES:
            continue
        _process_group(key, members, timers, out, device, mesh)
    return out


def _to_device(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (B, F, ih, iw) uint16 stack on ``device`` (through an int16 view:
    uint16 from numpy is not covered by every torch build)."""
    t = torch.from_numpy(frames.view(np.int16)).to(device)
    return t.view(torch.uint16)


def _process_group(key, members, timers, out, device, mesh=None) -> None:
    from ..geometry.linefit import fit_spectral_line
    from ..io.fits import make_header
    from ..io.hostreduce import host_mean_max_frames
    from ..io.video import open_video
    from ..io.writers import submit_figure
    from ..ops.dtypes import as_int16
    from ..ops.recon import build_shift_indices
    from ..ops.recon_cuda import recon_chunks
    from ..parallel.mesh import frame_split, sharded_recon
    from ..utils.device import synchronize
    from .run import ScanResult, check_supported, figures_wanted

    frames_list, fits, metas = [], [], []
    for file, opts in members:
        try:
            check_supported(opts)
            timer = timers.setdefault(file, StageTimer())
            # opened before the log is written, as read_scan does
            with timer.stage("open"):
                vid = open_video(file)
            basefich0 = os.path.splitext(file)[0]
            opts.basefich0 = basefich0
            log = RunLog(basefich0, opts)
            log.clear()
            log("Pixel shift : " + str(opts.shift))
            requested = list(opts.shift)
            opts.shift_requested = requested
            shifts = list(dict.fromkeys(
                [opts.ellipse_fit_shift, 0] + requested))
            log(f"Width, Height : {vid.Width} {vid.Height}")
            log(f"Number of frames : {vid.frame_count}")
            with timer.stage("mean/max"):
                frames = np.asarray(vid.read_all())
                mean_img, max_img = host_mean_max_frames(frames)
            with timer.stage("line fit"):
                lf = fit_spectral_line(mean_img, max_img)
            log(f"Vertical limits y1, y2 : {lf.y1} {lf.y2}")
            log("Spectral line polynomial fit: " + str(lf.poly))
            frames_list.append(frames)
            fits.append(lf)
            metas.append((file, opts, shifts, requested, mean_img,
                          make_header(vid.iw, vid.ih), basefich0, log))
        except Exception:
            traceback.print_exc()
    if len(frames_list) < MIN_FILES:
        return

    # shift lists can differ per file only via options copies — the
    # batch driver hands out copies of ONE options object, so S aligns;
    # a mismatched straggler falls back to the per-file path
    S = len(metas[0][2])
    aligned = [i for i in range(len(metas)) if len(metas[i][2]) == S]
    if len(aligned) < MIN_FILES:
        return
    iw = key[2]

    slab_bytes = int(SLAB_MB * 1024**2)
    per_file = max(1, frames_list[aligned[0]].nbytes)
    chunk_b = max(MIN_FILES, slab_bytes // per_file)

    stamp = timers[metas[aligned[0]][0]]
    disks_of = {}
    with stamp.stage("recon"):
        for c0 in range(0, len(aligned), chunk_b):
            sel = aligned[c0:c0 + chunk_b]
            if mesh is not None:
                # members over the batch rows, frames over the frame shards
                rows = frame_split(len(sel), mesh.shape["batch"])
                for r, (a, b) in enumerate(rows):
                    for i in sel[a:b]:
                        ind_l, left_w = build_shift_indices(
                            fits[i].floor, fits[i].frac, metas[i][2], iw)
                        disks_of[i] = sharded_recon(
                            frames_list[i], ind_l, left_w, mesh.row(r),
                            mesh.first, kernel="gather")
                continue
            slab = _to_device(np.stack([frames_list[i] for i in sel]),
                              device)
            for j, i in enumerate(sel):
                lf = fits[i]
                ind_l, left_w = build_shift_indices(
                    lf.floor, lf.frac, metas[i][2], iw)
                # one launch of kernel B3 over this member's frames
                disks_of[i] = recon_chunks(
                    [slab[j]], torch.from_numpy(ind_l).to(device),
                    torch.from_numpy(left_w).to(device), False, False)
            del slab
        synchronize(device)

    for i in aligned:
        file, opts, shifts, requested, mean_img, hdr, basefich0, log = \
            metas[i]
        lf = fits[i]
        disks = disks_of[i]
        if opts.flip_x:  # mirror like read_scan (run.py flip_x branch)
            disks = as_int16(disks).flip(2).view(torch.uint16)
        hdr["NAXIS1"] = disks.shape[2]  # recon width (reference :65)
        if figures_wanted(opts):
            from .plots import save_spectral_line_plot

            submit_figure(
                save_spectral_line_plot,
                output_path(basefich0 + "_spectral_line_data.png", opts),
                mean_img, lf,
            )
        out[file] = ScanResult(
            disk_list=disks,
            shifts=shifts,
            shift_requested=requested,
            backup_bounds=(lf.y1, lf.y2),
            header=hdr,
            basefich0=basefich0,
            mean_img=mean_img,
            linefit=lf,
        )
