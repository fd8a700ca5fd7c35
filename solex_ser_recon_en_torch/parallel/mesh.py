"""Device meshes for the reconstruction pipeline.

Counterpart of solex_ser_recon_en_tpu/parallel/mesh.py.  There a mesh is
a jax ``Mesh(('batch', 'frame'))`` and XLA partitions the programs from
``NamedSharding`` annotations.  Here a mesh is a (batch, frame) grid of
``torch.device``s in one process, and the callers split the work
themselves:

- **frame axis**: each frame writes a disjoint column of every disk, so a
  scan's frames cut into contiguous pieces, one a frame shard, need no
  communication in pass B; pass A's int32 sums and maxima of the shards
  are folded on the mesh's first device, exactly (integer sums and maxima
  give the same bits in any order).  No ``torch.distributed`` collective
  is needed inside one process.
- **batch axis**: different scans on different mesh rows, independent.

A mesh may name one device more than once (``make_mesh`` over
``[card] * 4``): the shards then run one after another on that device,
which is how the tests (on the CPU) and ``chip_smoke.py`` (on one card)
drive the sharded paths.  ``mesh_from_options`` takes the run's device
and the other visible cards; a spec larger than the visible cards raises
(the JAX package prints a warning and runs on one device; ROADMAP C14).

``shard_scan_recon``, ``device_recon_batch`` and ``device_pipeline_step``
compute their recon as the JAX functions do, by the one-hot contraction
(ops/recon.py:recon_onehot), not by a kernel; it contracts in float64
(``split_invariant``) so that a sharded recon equals the whole one bit for
bit.  Pass A goes through ops/fused_cuda.py:sum_max and the warp is
ops/warp.py:warp_projective.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dtypes import as_int16, to_u16

AXES = ("batch", "frame")


class MeshTooLarge(ValueError):
    """A mesh spec asks for more devices than the machine has."""


class Mesh:
    """A (batch, frame) grid of torch devices (a device may repeat)."""

    axis_names = AXES

    def __init__(self, rows: Sequence[Sequence]):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(torch.device(d) for d in row) for row in rows)
        if not self.devices or not self.devices[0] or len(
                {len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty (batch, frame) grid")

    @property
    def shape(self) -> Dict[str, int]:
        return {"batch": len(self.devices), "frame": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device the shards' results are gathered on."""
        return self.devices[0][0]

    def row(self, b: int = 0) -> Tuple[torch.device, ...]:
        """The frame shards of batch row ``b``."""
        return self.devices[b]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[[str(d) for d in r] for r in self.devices]})")


def same_device(a, b) -> bool:
    """Whether two device names are one device (``cuda`` is the current
    card)."""
    def canonical(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return canonical(a) == canonical(b)


def visible_cards() -> List[torch.device]:
    """Every CUDA device this process sees (raises where there is none)."""
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device is visible: pass the devices of "
                           "the mesh (e.g. the CPU, repeated)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Build a ('batch', 'frame') mesh over ``devices`` (default: every
    visible card), row by row.

    axes: {"batch": B, "frame": F} with B*F == len(devices); the default
    puts every device on the frame axis (the zero-communication direction).
    A device may appear more than once.
    """
    devs = [torch.device(d) for d in
            (devices if devices is not None else visible_cards())]
    n = len(devs)
    if axes is None:
        axes = {"batch": 1, "frame": n}
    b = int(axes.get("batch", 1))
    f = int(axes.get("frame", max(1, n // max(b, 1))))
    if b < 1 or f < 1 or b * f != n:
        raise ValueError(f"mesh {axes} does not match {n} devices")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {devs}")
    return Mesh([devs[r * f:(r + 1) * f] for r in range(b)])


def _spec_axes(spec: Dict[str, int]) -> Tuple[int, int]:
    if not isinstance(spec, dict) or not set(spec) <= set(AXES):
        raise ValueError(f"invalid mesh spec {spec!r}: a dict of "
                         "'batch' and 'frame' sizes")
    b, f = int(spec.get("batch", 1)), int(spec.get("frame", 1))
    if b < 1 or f < 1:
        raise ValueError(f"invalid mesh spec {spec!r}: sizes must be >= 1")
    return b, f


def mesh_from_options(spec: Optional[Dict[str, int]],
                      device: torch.device) -> Optional[Mesh]:
    """The pipeline's mesh for ``Options.mesh`` on the run's ``device``.

    None when the spec is empty or names one device.  On CUDA the mesh
    takes the run's device first, then the other visible cards in index
    order (``cuda:0 .. n-1`` for a run on ``cuda:0``), each once; a spec
    larger than the visible cards raises ``MeshTooLarge``, naming both
    counts.  On the CPU, asked for explicitly as the tests do, it repeats
    the CPU ``n`` times.
    """
    if not spec:
        return None
    b, f = _spec_axes(spec)
    n = b * f
    if n <= 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise MeshTooLarge(
                f"mesh {spec} needs {n} devices; this machine has {count} "
                "visible CUDA card(s)")
        first = (device.index if device.index is not None
                 else torch.cuda.current_device())
        order = [first] + [i for i in range(count) if i != first]
        devs = [torch.device("cuda", i) for i in order[:n]]
    elif device.type == "cpu":
        devs = [device] * n
    else:
        raise ValueError(f"unsupported mesh device {device}")
    return make_mesh({"batch": b, "frame": f}, devs)


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``frame=8`` / ``batch=2,frame=4`` / bare ``8`` (all-frame) -> dict."""
    spec = spec.strip()
    if spec.isdigit():
        return {"frame": int(spec)}
    out: Dict[str, int] = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in ("batch", "frame") or not v.strip().isdigit():
            raise ValueError(f"invalid mesh spec {spec!r}")
        out[k] = int(v)
    return out


def frame_split(n: int, parts: int) -> List[Tuple[int, int]]:
    """[0, n) cut into ``parts`` contiguous ranges, one a shard (the
    counterpart of a ``P('frame')`` sharding): the first ``n % parts``
    shards take one frame more.  A range is empty when ``n < parts``.
    Sizes never grow as ``n`` shrinks, so a trailing short chunk gives
    every shard a piece no longer than its earlier ones (what kernel B3's
    launch over a shard's pieces needs)."""
    base, extra = divmod(n, parts)
    out, a = [], 0
    for i in range(parts):
        b = a + base + (i < extra)
        out.append((a, b))
        a = b
    return out


def replicate(t: torch.Tensor, devices: Sequence[torch.device]) -> dict:
    """``t`` on every distinct device of ``devices`` ({device: tensor};
    the counterpart of a replicated sharding)."""
    return {d: t.to(d) for d in dict.fromkeys(torch.device(x)
                                              for x in devices)}


def cat_frames(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """Frame-sharded pieces (..., F_k) gathered along the last axis on
    ``device``, in order."""
    if parts[0].dtype == torch.uint16:
        return torch.cat([as_int16(p.to(device)) for p in parts],
                         dim=-1).view(torch.uint16)
    return torch.cat([p.to(device) for p in parts], dim=-1)


def _tensor(x, device=None) -> torch.Tensor:
    """A numpy array (uint16 through an int16 view) or tensor as a tensor,
    on ``device`` when given."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(np.asarray(x))
        x = (torch.from_numpy(a.view(np.int16)).view(torch.uint16)
             if a.dtype == np.uint16 else torch.from_numpy(a))
    return x if device is None else x.to(device)


def sharded_recon(frames, ind_l, left_w, devices, first: torch.device,
                  out_u16: bool = True, kernel: str = "onehot"):
    """One scan's recon (frames (F, ih, iw), ind_l (S, ih), left_w (ih,),
    tensors or numpy arrays), its frames split over ``devices``: each
    piece's disks on its own device, gathered on ``first``."""
    from ..ops.recon import recon_onehot
    from ..ops.recon_cuda import recon_chunks

    if kernel not in ("onehot", "gather"):
        raise ValueError(f"unknown recon kernel {kernel!r} (onehot|gather)")
    frames = _tensor(frames)
    idx = replicate(_tensor(ind_l), devices)
    wts = replicate(_tensor(left_w), devices)
    parts = []
    for dev, (a, b) in zip(devices, frame_split(frames.shape[0],
                                                len(devices))):
        if a == b:
            continue
        x = frames[a:b].to(dev)
        if kernel == "onehot":
            parts.append(recon_onehot(x, idx[dev], wts[dev], out_u16,
                                      split_invariant=True))
        else:
            # the gather-lerp: kernel B3 on the card, its plain version on
            # the CPU
            parts.append(recon_chunks([x.contiguous()], idx[dev], wts[dev],
                                      False, False))
    return cat_frames(parts, first)


def shard_scan_recon(frames, ind_l, left_w, mesh: Mesh,
                     kernel: str = "onehot") -> torch.Tensor:
    """Single-file multi-shift recon with the frame axis sharded.

    frames (F, ih, iw) u16 split over the first row's frame shards; the
    weights replicated.  The (S, ih, F) u16 disks are gathered on the
    mesh's first device.  ``kernel``: "onehot" (the JAX function's
    default, ``recon_onehot``) or "gather" (the gather-lerp; kernel B3 on
    the card).
    """
    return sharded_recon(frames, ind_l, left_w, mesh.row(0), mesh.first,
                         kernel=kernel)


def _batch_rows(B: int, mesh: Optional[Mesh], device):
    """(batch row's frame devices, gather device) of each of B scans: the
    scans split over the mesh's rows in contiguous runs; without a mesh,
    ``device`` alone."""
    if mesh is None:
        dev = torch.device(device)
        return [((dev,), dev)] * B, dev
    rows = []
    for r, (a, b) in enumerate(frame_split(B, mesh.shape["batch"])):
        rows += [(mesh.row(r), mesh.row(r)[0])] * (b - a)
    return rows, mesh.first


def _stack(parts: List[torch.Tensor], device) -> torch.Tensor:
    if parts[0].dtype == torch.uint16:
        return torch.stack([as_int16(p.to(device)) for p in parts]).view(
            torch.uint16)
    return torch.stack([p.to(device) for p in parts])


def device_recon_batch(frames, ind_l, left_w, mesh: Optional[Mesh] = None,
                       device="cuda") -> torch.Tensor:
    """Raw disks (B, S, ih, F) u16 of B same-shape scans: frames (B, F, ih,
    iw) u16, ind_l (B, S, ih) int32, left_w (B, ih) float32.  Under
    ``mesh`` the scans go over its batch rows and each scan's frames over
    its row's frame shards (the JAX function's ('batch', 'frame')
    sharding); without one, everything runs on ``device``.  Gathered on
    the mesh's first device (or ``device``)."""
    frames, ind_l, left_w = _tensor(frames), _tensor(ind_l), _tensor(left_w)
    rows, out_dev = _batch_rows(frames.shape[0], mesh, device)
    return _stack([sharded_recon(frames[i], ind_l[i], left_w[i], devs, g)
                   for i, (devs, g) in enumerate(rows)], out_dev)


def device_pipeline_step(frames, ind_l, left_w, warp_mats, row_gains,
                         mesh: Optional[Mesh] = None, device="cuda",
                         out_u16: bool = True) -> Dict[str, torch.Tensor]:
    """The batched device step of the JAX package's ``_batched_step``.

    frames (B, F, ih, iw) u16, ind_l (B, S, ih) int32, left_w (B, ih)
    float32, warp_mats (B, 3, 3) float32 circularisation inverse maps,
    row_gains (B, ih) float32 transversalium gains.  Returns {"mean",
    "max": (B, ih, iw) u16, "raw", "circular": (B, S, ih, F)}: each scan's
    truncating mean and max (pass A's int32 sums and maxima a shard,
    folded on the row's first device), its unclipped float32 disks
    (one-hot recon a shard, gathered), and each disk warped on [0, 1)
    (cval 0), rescaled and clipped, times the row gains and clipped.
    ``out_u16`` (the JAX default) casts raw and circular to u16; False
    keeps them float32.  Sharded as ``device_recon_batch``.
    """
    from ..ops.fused_cuda import sum_max
    from ..ops.warp import warp_projective

    frames, ind_l, left_w = _tensor(frames), _tensor(ind_l), _tensor(left_w)
    gains = _tensor(row_gains)
    mats = np.asarray(warp_mats.cpu() if isinstance(warp_mats, torch.Tensor)
                      else warp_mats, dtype=np.float32)
    B, F, ih, iw = frames.shape
    rows, out_dev = _batch_rows(B, mesh, device)
    outs = {"mean": [], "max": [], "raw": [], "circular": []}
    for i, (devs, g) in enumerate(rows):
        total = torch.zeros((ih, iw), dtype=torch.int32, device=g)
        mx = torch.zeros_like(total)
        for dev, (a, b) in zip(devs, frame_split(F, len(devs))):
            if a == b:
                continue
            s_k = torch.zeros((ih, iw), dtype=torch.int32, device=dev)
            m_k = torch.zeros_like(s_k)
            sum_max(frames[i, a:b].to(dev), s_k, m_k)
            total += s_k.to(g)
            mx = torch.maximum(mx, m_k.to(g))
        outs["mean"].append(to_u16(torch.div(total, F, rounding_mode="floor")))
        outs["max"].append(to_u16(mx))
        disks = sharded_recon(frames[i], ind_l[i], left_w[i], devs, g,
                               out_u16=False)
        gain = gains[i].to(g)[:, None]
        circ = []
        for disk in disks:
            w = warp_projective(disk / 65536.0, mats[i], ih, F, cval=0.0)
            w = torch.clamp(w * 65536.0, 0, 65535)
            circ.append(torch.clamp(w * gain, 0, 65535))
        circ = torch.stack(circ)
        if out_u16:
            disks = to_u16(torch.clamp(disks, 0, 65535))
            circ = to_u16(circ)
        outs["raw"].append(disks)
        outs["circular"].append(circ)
    return {k: _stack(v, out_dev) for k, v in outs.items()}
