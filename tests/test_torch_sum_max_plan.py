"""Pass A's launch plan (csrc/plans.cuh: solex_plans::sum_max), the code
the kernel library plans each launch with, here through its host build
``ops/fused_cuda.py:sum_max_plan`` (CPU; the card's tests hold the host
build's plan to the kernel library's, tests/test_torch_cuda_kernels.py).

An H100 SXM has 132 SMs and holds 2 blocks of the kernel an SM at the split
ring's shared memory.  The owned plan splits a frame's 16-byte granules
evenly over every block slot, each block reading every frame for its run;
frames too small for runs of ``PLAN_LIMITS["sum_max_min_owned_run"]``
bytes take the split plan (16 KB runs over frame splits, atomic merge)."""

import pytest
import torch

from solex_ser_recon_en_torch.io import native
from solex_ser_recon_en_torch.ops import fused_cuda
from solex_ser_recon_en_torch.ops.fused_cuda import (
    SUM_MAX_PLANS,
    sum_max,
    sum_max_plan,
)

SMS, BPS = 132, 2
ALIGNED = 1 << 20
#: (F, pixels a frame, bytes an element): -c's raw chunks of the bench scan
#: (2048 x 300 frames, 25 u16 chunks of 81 frames, the last 56; 13 u8
#: chunks of 163, the last 44), the resident 2000-frame slab, mesh pieces of
#: 14-21 frames
BENCH = {"u16 chunk": (81, 300 * 2048, 2), "u16 tail": (56, 300 * 2048, 2),
         "u8 chunk": (163, 300 * 2048, 1), "u8 tail": (44, 300 * 2048, 1),
         "slab": (2000, 2048 * 300, 2), "mesh piece": (14, 300 * 2048, 2),
         "mesh piece 21": (21, 300 * 2048, 2)}


def limit(name):
    """A limit of csrc/plans.cuh, read from the host library."""
    return fused_cuda.PLAN_LIMITS[name]


def runs(plan, npix, eb):
    """(first pixel, pixels) of each block's run, as the kernel computes
    them from the plan."""
    gpx = 16 // eb
    base, rem = plan["base"], plan["rem"]
    out = []
    for b in range(plan["blocks"]):
        p0 = (b * base + min(b, rem)) * gpx
        out.append((p0, min((base + (b < rem)) * gpx, npix - p0)))
    return out


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_shapes_take_one_full_owned_wave(name):
    """Every -c chunk, the tails, the slab and the mesh pieces: owned, on
    the bulk path, one block a slot, every frame in one frame range, runs
    within one granule of each other, and the SMs' bytes too when blocks
    go round the SMs in order."""
    F, npix, eb = BENCH[name]
    plan = sum_max_plan(ALIGNED, eb, F, npix, SMS, BPS)
    assert plan["plan"] == "owned" and plan["path"] == "bulk"
    assert plan["blocks"] == SMS * BPS and plan["grid"] == (SMS * BPS, 1)
    assert plan["fper"] == F
    lens = [n * eb for _, n in runs(plan, npix, eb)]
    assert max(lens) - min(lens) <= 16
    per_sm = [sum(lens[s::SMS]) for s in range(SMS)]
    assert max(per_sm) - min(per_sm) <= 16
    assert sum(lens) == npix * eb


@pytest.mark.parametrize("eb,run_b,K,D", [(2, 4656, 8, 2), (1, 2336, 16, 2)])
def test_bench_chunk_ring(eb, run_b, K, D):
    """The bench chunk's runs (~4.7 KB u16, ~2.3 KB u8) and their ring: K
    frames a stage, D stages, within the split ring's shared memory."""
    plan = sum_max_plan(ALIGNED, eb, 81, 300 * 2048, SMS, BPS)
    assert 16 * (plan["base"] + (plan["rem"] > 0)) == run_b
    assert (plan["K"], plan["D"]) == (K, D)
    fst = run_b + 16
    assert 64 + plan["D"] * plan["K"] * fst <= plan["smem"]


@pytest.mark.parametrize("granules", [64, 100, 146, 291, 437, 500, 700, 1024])
def test_owned_ring_within_the_split_ring(granules):
    """An owned run of any length between the shortest owned run and 16 KB
    gets a ring of at least two stages of a power of two frames within the
    split ring's shared memory, so the card's slots stay those counted."""
    npix = granules * 8 * SMS * BPS
    plan = sum_max_plan(ALIGNED, 2, 100, npix, SMS, BPS)
    assert plan["plan"] == "owned" and plan["base"] == granules
    fst = 16 * granules + 16
    assert plan["D"] >= 2 and plan["K"] & (plan["K"] - 1) == 0
    assert 64 + plan["D"] * plan["K"] * fst <= plan["smem"] == 98464
    assert plan["K"] <= limit("sum_max_owned_max_k")


@pytest.mark.parametrize("F,h,w,eb", [(200, 448, 96, 2), (200, 448, 96, 1),
                                      (150, 96, 448, 2), (37, 100, 60, 2),
                                      (5, 3, 2, 1)])
def test_small_frames_take_the_split_plan(F, h, w, eb):
    """Frames below the shortest owned run a slot (the small
    session scans' 448 x 96) keep the split plan: runs of up to 16 KB over
    frame ranges that are multiples of 32 frames."""
    npix = h * w
    assert npix * eb < SMS * BPS * limit("sum_max_min_owned_run")
    plan = sum_max_plan(ALIGNED, eb, F, npix, SMS, BPS)
    assert plan["plan"] == "split" and plan["rem"] == 0
    assert plan["base"] == min(-(-npix * eb // 16),
                               limit("sum_max_max_run") // 16)
    assert plan["fper"] % 32 == 0
    assert plan["grid"][1] == -(-F // plan["fper"])


@pytest.mark.parametrize("ptr,eb,npix,path", [
    (ALIGNED + 2, 2, 300 * 2048, "element"),
    (ALIGNED + 1, 1, 300 * 2048, "element"),
    (ALIGNED, 2, 300 * 2048 - 3, "element"),
    (ALIGNED, 2, 300 * 2048, "bulk"),
])
def test_unaligned_frames_take_the_element_path(ptr, eb, npix, path):
    """A pointer or a frame that is not a multiple of 16 bytes takes the
    element path; the plan stays owned."""
    plan = sum_max_plan(ptr, eb, 81, npix, SMS, BPS)
    assert plan["path"] == path and plan["plan"] == "owned"


def _shapes():
    g = torch.Generator().manual_seed(20)
    out = [(F, npix, eb) for F, npix, eb in BENCH.values()]
    out += [(3, 4096 * 4096, 2), (9, 264 * 64 * 8, 2), (9, 264 * 64 * 8 - 1, 2),
            (9, 264 * 64 * 16 - 5, 1), (1, 1, 1), (40, 9001 * 3, 2)]
    for _ in range(40):
        npix = int(torch.randint(1, 3_000_000, (1,), generator=g))
        eb = int(torch.randint(1, 3, (1,), generator=g))
        F = int(torch.randint(1, 3000, (1,), generator=g))
        out.append((F, npix, eb))
    return out


@pytest.mark.parametrize("sms,bps", [(132, 2), (114, 2), (8, 1)])
def test_every_pixel_exactly_once(sms, bps):
    """For any shape, the runs of either plan cover every pixel of a frame
    exactly once, none is empty, none passes 16 KB, and an owned plan is
    whole waves of the slots."""
    for F, npix, eb in _shapes():
        plan = sum_max_plan(ALIGNED, eb, F, npix, sms, bps)
        rs = runs(plan, npix, eb)
        at = 0
        for p0, n in rs:
            assert p0 == at and n > 0, (F, npix, eb, plan)
            assert n * eb <= limit("sum_max_max_run")
            at += n
        assert at == npix, (F, npix, eb, plan)
        if plan["plan"] == "owned":
            assert plan["blocks"] % (sms * bps) == 0 and plan["fper"] == F
            assert min(n for _, n in rs[:-1] or rs) * eb >= \
                limit("sum_max_min_owned_run") - 16
        else:
            assert plan["grid"][1] * plan["fper"] >= F
            assert npix * eb < sms * bps * limit("sum_max_min_owned_run")
        assert plan["D"] >= 2 and plan["K"] & (plan["K"] - 1) == 0
        fst = 16 * (plan["base"] + (plan["rem"] > 0)) + 16
        assert 64 + plan["D"] * plan["K"] * fst <= plan["smem"]


def test_large_frames_take_more_owned_waves():
    """A frame past 16 KB a slot takes whole waves of the slots, each run
    within 16 KB, still owned."""
    plan = sum_max_plan(ALIGNED, 2, 3, 4096 * 4096, SMS, BPS)
    assert plan["plan"] == "owned"
    assert plan["blocks"] == 8 * SMS * BPS
    assert 16 * (plan["base"] + 1) <= limit("sum_max_max_run")


@pytest.mark.parametrize("tiles,F,want", [(75, 81, 32), (38, 163, 32),
                                          (6, 200, 32), (1, 5, 32)])
def test_frames_per_block_mirror(tiles, F, want):
    """csrc/plans.cuh:frames_per_block through the host library: the
    parent plan's split of the bench chunk (75 runs x 32, 32, 17 frames)
    and of the u8 chunk (38 runs x 32 x 5 + 3)."""
    assert native.get_lib().solex_frames_per_block(tiles, SMS * BPS, F) == \
        want


def test_plan_limits_are_the_kernels():
    """PLAN_LIMITS holds the values the kernels are built with (the design
    notes of csrc/sum_max.cu, csrc/fused.cu and csrc/fused_mxu.cu: 256
    threads, an H100 block's 227 KB of opt-in shared memory, rings of at
    most 8 stages with an 8-byte barrier each, 32-frame splits, 4 16-byte
    chunks a thread in pass A and B1, B6's rows of up to 3072 u16), and
    frames_per_block is the frame split of every split plan of pass A."""
    assert fused_cuda.PLAN_LIMITS == {
        "threads": 256, "max_smem": 232448, "bar_bytes": 64,
        "max_stages": 8, "split_frames": 32,
        "sum_max_max_run": 16 * 4 * 256, "sum_max_min_owned_run": 1024,
        "sum_max_owned_max_k": 16, "b1_max_run": 8 * 4 * 256,
        "b6_max_iw": 3072}
    fpb = native.get_lib().solex_frames_per_block
    split = 0
    for F, npix, eb in _shapes():
        for sms, bps in ((132, 2), (114, 2), (8, 1)):
            plan = sum_max_plan(ALIGNED, eb, F, npix, sms, bps)
            if plan["plan"] == "split":
                split += 1
                assert plan["fper"] == fpb(plan["blocks"], sms * bps, F)
    assert split >= 10


def test_cpu_sum_max_counts_no_plan():
    """CPU tensors take the plain reductions: no plan is counted."""
    before = dict(SUM_MAX_PLANS)
    frames = torch.arange(2 * 3 * 4, dtype=torch.int32).to(
        torch.uint8).view(2, 3, 4)
    total = torch.zeros((3, 4), dtype=torch.int32)
    mx = torch.zeros_like(total)
    sum_max(frames, total, mx)
    assert SUM_MAX_PLANS == before
    assert torch.equal(total, frames.to(torch.int32).sum(0))
