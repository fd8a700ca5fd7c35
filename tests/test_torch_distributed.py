"""``parallel/distributed.py:initialize`` across two real processes (CPU).

The counterpart of tests/test_distributed_live.py: two child processes,
given a free localhost port, each join a ``torch.distributed`` process
group through the port's ``initialize`` on ``gloo`` (the CPU's backend;
``nccl`` on the card is driven by ``chip_smoke.py``), run one
``all_reduce`` of ones, whose sum must be the world size, 2, and agree on
a disjoint and complete ``assign_files`` split of 40 names.  Each child
gets ``communicate(timeout=180)``, so the test cannot hang.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys
import torch
import torch.distributed as dist
from solex_ser_recon_en_torch.parallel.distributed import (
    assign_files, initialize)

coord, pid, how = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if how == "args":
    initialize(coord, 2, pid, device="cpu")
else:                       # the environment, as a launcher sets it
    host, port = coord.rsplit(":", 1)
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE="2",
                      RANK=str(pid))
    initialize(device="cpu")
x = torch.ones(4)
dist.all_reduce(x)
files = [f"scan_{i:03d}.ser" for i in range(40)]
mine = assign_files(files, 2, pid)
shares = [None, None]
dist.all_gather_object(shares, mine)
print(json.dumps({"pid": pid, "rank": dist.get_rank(),
                  "world": dist.get_world_size(),
                  "backend": dist.get_backend(),
                  "sum": x.tolist(), "mine": mine, "shares": shares}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("how", ["args", "env"])
def test_two_process_initialize_all_reduce_and_file_split(how):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, coord, str(pid), how],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    files = [f"scan_{i:03d}.ser" for i in range(40)]
    for pid, res in enumerate(outs):
        assert res["rank"] == pid and res["world"] == 2
        assert res["backend"] == "gloo"
        assert res["sum"] == [2.0] * 4
        assert res["shares"] == [outs[0]["mine"], outs[1]["mine"]]
    a, b = outs[0]["mine"], outs[1]["mine"]
    assert not set(a) & set(b)
    assert sorted(a + b) == files
    assert a and b


def test_initialize_refuses_cuda_where_there_is_none(monkeypatch):
    """``nccl`` needs the card; asking for it where CUDA is absent raises
    before any process group is made (no silent ``gloo``)."""
    import torch

    from solex_ser_recon_en_torch.parallel.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize("127.0.0.1:1", 1, 0)
