"""The PyTorch port's session driver (cli/main.py, pipeline/batch.py,
parallel/distributed.py) on the CPU, against per-file runs of the port and
against the JAX package.

- ``handle_files`` overlaps each scan's post-processing with the next
  scan's read: its products are byte-identical to one run per file, a file
  that fails is counted out while the others are done, and a failed write
  is the failure of the file that queued it (the JAX driver names the
  wrong file there: ROADMAP C8).
- ``read_scans_batched`` (a library entry point the driver does not call:
  on the card it is slower than the overlapped per-file path) gives each
  member of a same-shape group the mean, disks and products of its own
  ``read_scan``, and the JAX package's within ROADMAP C2; the driver reads
  every member of such a group on its own.
- ``handle_folder``: the folder batch, and continuous mode, which finds a
  file dropped into the folder while it runs.
- ``assign_files`` is the JAX function; ``--num-processes`` splits a folder
  into disjoint shares that cover it; the environment fallback.
- ``--profile`` writes a trace; ``read_ini`` / ``write_ini`` round-trip
  with the JAX package's ``Options``.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from solex_ser_recon_en_tpu.config import Options as JaxOptions
from solex_ser_recon_en_tpu.parallel import distributed as jax_distributed
from solex_ser_recon_en_tpu.pipeline import run as jax_run
from solex_ser_recon_en_torch.cli import main as cli
from solex_ser_recon_en_torch.cli.flags import parse_cli
from solex_ser_recon_en_torch.config import Options
from solex_ser_recon_en_torch.io.ser import write_ser
from solex_ser_recon_en_torch.io.synthetic import SyntheticScan
from solex_ser_recon_en_torch.parallel import distributed
from solex_ser_recon_en_torch.pipeline import batch, products
from solex_ser_recon_en_torch.pipeline import run as port_run

from torch_parity import lsb_diff

CPU = torch.device("cpu")


def _copies(src, folder, names):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for name in names:
        p = os.path.join(folder, name)
        shutil.copy(src, p)
        paths.append(p)
    return paths


def _pngs(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.endswith(".png"):
            with open(os.path.join(folder, name), "rb") as f:
                out[name] = f.read()
    return out


def _per_file(paths, out, extra=()):
    """One CLI run per file: the reference products of the session."""
    for p in paths:
        assert cli.main(["-c", p, "--device", "cpu", "--output-dir", out,
                         *extra]) == 0
    return _pngs(out)


# ---- the overlapped session ------------------------------------------------


def test_handle_files_overlap_equals_per_file_runs(basic_scan, tmp_path,
                                                   capsys):
    """Four scans, the third unreadable: three done, each PNG the bytes of
    its file run alone; the pool ran process_scan beside read_scan."""
    paths = _copies(basic_scan["path"], str(tmp_path / "in"),
                    ["s0.ser", "s1.ser", "s3.ser"])
    bad = str(tmp_path / "in" / "s2.ser")
    with open(bad, "wb") as f:
        f.write(b"LUCAM-RECORDER" + b"\0" * 100)      # no complete header
    files = [paths[0], paths[1], bad, paths[2]]
    threads = set()
    orig = port_run.process_scan

    def spy(*a, **k):
        threads.add(threading.current_thread().name)
        return orig(*a, **k)

    out = str(tmp_path / "session")
    os.makedirs(out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "process_scan", spy)
        done = cli.handle_files(files, Options(shift=[0], clahe_only=True,
                                               output_dir=out), CPU)
    said = capsys.readouterr().out
    assert done == 3
    assert f"ERROR ENCOUNTERED: {bad}" in said and f"{bad} done" not in said
    for p in paths:
        assert f"{p} done:" in said
    assert all(name.startswith("solex-torch-post") for name in threads)
    session = _pngs(out)
    assert sorted(session) == [f"s{i}_shift=0_clahe.png" for i in (0, 1, 3)]
    assert session == _per_file(paths, str(tmp_path / "alone"))


def test_a_failed_write_is_its_own_files_failure(basic_scan, tmp_path,
                                                  capsys):
    """b's ``_mean.fits`` write (queued by read_scan of b while process_scan
    of a runs) fails after a delay: a is done, b is not, and the error is
    reported for b.  The JAX driver's global barrier gives the error to a
    and reports b done (ROADMAP C8)."""
    a, b = _copies(basic_scan["path"], str(tmp_path / "in"),
                   ["a.ser", "b.ser"])
    orig = products._save_fits_sync

    def slow_fail(path, *args):
        if os.path.basename(path) == "b_mean.fits":
            time.sleep(0.5)
            raise OSError("disk full writing b_mean.fits")
        return orig(path, *args)

    out = str(tmp_path / "out")
    os.makedirs(out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(products, "_save_fits_sync", slow_fail)
        done = cli.handle_files([a, b], Options(shift=[0], clahe_only=True,
                                                save_fit=True, output_dir=out),
                                CPU)
    said = capsys.readouterr()
    assert done == 1
    assert f"{a} done:" in said.out and f"{b} done:" not in said.out
    assert f"ERROR ENCOUNTERED: {b}" in said.out
    assert f"ERROR ENCOUNTERED: {a}" not in said.out
    assert "disk full writing b_mean.fits" in said.err
    for name in ("a_mean.fits", "a_shift=0_clahe.png", "b_shift=0_raw.fits"):
        assert os.path.exists(os.path.join(out, name)), name


def test_launch_counts_and_scan_writes_hold_across_threads():
    """A session launches kernels and queues writes from two threads: with
    more threads than cores and a short switch interval, no launch count is
    lost, and each thread's scan holds exactly the writes it queued."""
    import sys

    from solex_ser_recon_en_torch.io import writers
    from solex_ser_recon_en_torch.ops import cuda_build

    n_threads, n_each = 2 * (os.cpu_count() or 1) + 2, 2000
    before = cuda_build.LAUNCHES["recon"]
    groups = [[] for _ in range(n_threads)]
    done = []

    def work(k):
        with writers.scan_writes(groups[k]):
            for i in range(n_each):
                cuda_build.count_launch("recon")
                if i % 100 == 0:
                    writers.submit(done.append, (k, i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert cuda_build.LAUNCHES["recon"] == before + n_threads * n_each
    for k, futures in enumerate(groups):
        assert len(futures) == n_each // 100
        writers.barrier(futures)
        assert futures == []
    assert sorted(done) == sorted((k, i) for k in range(n_threads)
                                  for i in range(0, n_each, 100))


# ---- the small-scan group --------------------------------------------------


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Four same-shape small scans (two 16-bit copies, two 8-bit: the same
    frames as a SER and as a Y800 AVI) and a straggler of another shape."""
    from test_avi import _write_y800_avi_raw

    d = tmp_path_factory.mktemp("group")
    scan = SyntheticScan(ih=256, iw=96, frames=200, depth=16,
                         line_poly=(48.0, 0.02, -1e-4, 2e-7), noise=0.002,
                         seed=1)
    wide = np.rot90(scan.generate(), k=-1, axes=(1, 2))
    write_ser(str(d / "g0.ser"), wide)
    shutil.copy(str(d / "g0.ser"), str(d / "g1.ser"))
    wide8 = np.ascontiguousarray((wide >> 8).astype(np.uint8))
    write_ser(str(d / "g2.ser"), wide8)
    _write_y800_avi_raw(str(d / "g3.avi"), wide8, opendml_split=60)
    SyntheticScan(ih=240, iw=80, frames=180, depth=16,
                  line_poly=(40.0, 0.01, 0.0, 0.0), noise=0.002,
                  seed=4).write(str(d / "x.ser"), transpose_to_wide=True)
    members = [str(d / n) for n in ("g0.ser", "g1.ser", "g2.ser", "g3.avi")]
    return members, str(d / "x.ser")


def test_read_scans_batched_equals_read_scan(group, tmp_path):
    members, straggler = group
    tasks = [(f, Options(shift=[0], clahe_only=True,
                         output_dir=str(tmp_path / "b")))
             for f in members + [straggler]]
    os.makedirs(tmp_path / "b")
    os.makedirs(tmp_path / "s")
    timers = {}
    got = batch.read_scans_batched(tasks, timers, CPU)
    assert sorted(got) == sorted(members)            # the straggler is not
    assert set(timers) >= set(members)
    for f in members:
        o = Options(shift=[0], clahe_only=True, output_dir=str(tmp_path / "s"))
        ref = port_run.read_scan(f, o, CPU)
        sb = got[f]
        np.testing.assert_array_equal(sb.mean_img, ref.mean_img)
        assert sb.shifts == ref.shifts and sb.header == ref.header
        assert sb.backup_bounds == ref.backup_bounds
        assert torch.equal(sb.disk_list.view(torch.int16),
                           ref.disk_list.view(torch.int16))
        port_run.process_scan(sb, dict(tasks)[f])
        port_run.process_scan(ref, o)
        name = os.path.basename(os.path.splitext(f)[0]) + "_shift=0_clahe.png"
        with open(tmp_path / "b" / name, "rb") as x, \
                open(tmp_path / "s" / name, "rb") as y:
            assert x.read() == y.read(), name
    # against the JAX package's per-file run of the same file
    sj = jax_run.read_scan(members[0], JaxOptions(shift=[0], clahe_only=True,
                                                  output_dir=str(tmp_path)))
    np.testing.assert_array_equal(got[members[0]].mean_img, sj.mean_img)
    disks_j = np.stack([np.asarray(d) for d in sj.disk_list])
    mx, frac = lsb_diff(got[members[0]].disk_list.numpy(), disks_j)
    assert mx <= 1 and frac < 0.005                  # ROADMAP C2


def test_read_scans_batched_mirrors_like_read_scan(group, tmp_path):
    """With flip_x (``-m``) every member's disks are read_scan's, mirrored
    the same way."""
    members, _ = group
    opts = Options(shift=[0], clahe_only=True, flip_x=True,
                   output_dir=str(tmp_path))
    got = batch.read_scans_batched([(f, opts.copy()) for f in members], {},
                                   CPU)
    assert sorted(got) == sorted(members)
    for f in members:
        ref = port_run.read_scan(f, opts.copy(), CPU)
        assert torch.equal(got[f].disk_list.view(torch.int16),
                           ref.disk_list.view(torch.int16))


@pytest.mark.parametrize("case", ["save_fit", "too_few", "too_big"])
def test_read_scans_batched_leaves_the_group_to_read_scan(group, tmp_path,
                                                           case, monkeypatch):
    """Options that ask for ``_mean.fits``, a group under ``MIN_FILES`` and
    scans over ``MAX_MB`` are all left to read_scan: nothing is returned
    and nothing is written."""
    members, straggler = group
    opts = Options(shift=[0], clahe_only=True, save_fit=case == "save_fit",
                   output_dir=str(tmp_path))
    if case == "too_few":
        monkeypatch.setattr(batch, "MIN_FILES", 5)
    if case == "too_big":
        monkeypatch.setattr(batch, "MAX_MB", 0.01)
    tasks = [(f, opts.copy()) for f in members + [straggler]]
    assert batch.read_scans_batched(tasks, {}, CPU) == {}
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flags", ["-c", "-cm"])
def test_handle_files_reads_every_member_of_a_group_alone(group, tmp_path,
                                                          flags):
    """A same-shape group and a straggler: the driver reads every file
    through read_scan, in order, beside the last one's post-processing,
    and every PNG is the bytes of its file run alone."""
    members, straggler = group
    read = []
    orig = cli.read_scan

    def spy(file, *a, **k):
        read.append(file)
        return orig(file, *a, **k)

    out = str(tmp_path / "session")
    os.makedirs(out)
    opts = Options(shift=[0], clahe_only=True, output_dir=out,
                   flip_x=flags == "-cm")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "read_scan", spy)
        assert cli.handle_files(members + [straggler], opts, CPU) == 5
    assert read == members + [straggler]
    alone = _per_file(members + [straggler], str(tmp_path / "alone"),
                      [flags])
    assert _pngs(out) == alone and len(alone) == 5


# ---- folder and continuous modes --------------------------------------------


def test_handle_folder_processes_the_folder(basic_scan, tmp_path):
    folder = str(tmp_path / "in")
    _copies(basic_scan["path"], folder, ["f0.ser", "f1.ser"])
    with open(os.path.join(folder, "notes.txt"), "w") as f:
        f.write("not a scan")
    out = str(tmp_path / "out")
    os.makedirs(out)
    opts = Options(shift=[0], clahe_only=True, input_dir=folder,
                   output_dir=out)
    assert cli.handle_folder(opts, CPU) == 2
    assert sorted(_pngs(out)) == ["f0_shift=0_clahe.png",
                                  "f1_shift=0_clahe.png"]


def test_continuous_mode_finds_a_dropped_file(basic_scan, tmp_path):
    """A scan is dropped into the folder 0.3 s into the run (written under
    another name, then renamed); an unreadable ``.ser`` is skipped."""
    folder = str(tmp_path / "watch")
    _copies(basic_scan["path"], folder, ["first.ser"])
    with open(os.path.join(folder, "junk.ser"), "wb") as f:
        f.write(b"\0" * 50)
    out = str(tmp_path / "out")
    os.makedirs(out)
    dropped = {}

    def drop():
        time.sleep(0.3)
        tmp = os.path.join(folder, "late.part")
        shutil.copy(basic_scan["path"], tmp)
        os.rename(tmp, os.path.join(folder, "late.ser"))
        dropped["t"] = time.time()

    th = threading.Thread(target=drop)
    opts = Options(shift=[0], clahe_only=True, input_dir=folder,
                   output_dir=out, continuous_detect_mode=True)
    th.start()
    t0 = time.monotonic()
    n = cli.handle_folder(opts, CPU, poll_seconds=0.05, stop_after=6.0)
    th.join(timeout=10)
    assert not th.is_alive()
    assert n == 2
    assert sorted(_pngs(out)) == ["first_shift=0_clahe.png",
                                  "late_shift=0_clahe.png"]
    late = os.path.getmtime(os.path.join(out, "late_shift=0_clahe.png"))
    assert 0 < late - dropped["t"] < 5.0
    assert time.monotonic() - t0 < 15.0


# ---- the process split ------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_assign_files_is_the_jax_function(n):
    rng = np.random.default_rng(11)
    names = [f"/data/{'night' if i % 3 else 'day'}/scan_"
             f"{rng.integers(0, 10**9)}.{'ser' if i % 5 else 'avi'}"
             for i in range(1000)]
    shares = [distributed.assign_files(names, n, pid) for pid in range(n)]
    for pid in range(n):
        assert shares[pid] == jax_distributed.assign_files(names, n, pid)
    assert sorted(sum(shares, [])) == sorted(names)
    with pytest.raises(ValueError):
        distributed.assign_files(names, n, n)


def test_shard_folder_batch_is_the_jax_function(basic_scan, tmp_path):
    folder = str(tmp_path / "in")
    _copies(basic_scan["path"], folder, [f"q{i}.ser" for i in range(6)])
    for pid in (0, 1):
        assert distributed.shard_folder_batch(
            Options(input_dir=folder), 2, pid) == \
            jax_distributed.shard_folder_batch(
                JaxOptions(input_dir=folder), 2, pid)


def test_num_processes_split_the_folder(basic_scan, tmp_path):
    folder = str(tmp_path / "in")
    names = [f"s{i}.ser" for i in range(4)]
    files = _copies(basic_scan["path"], folder, names)
    assert all(distributed.assign_files(files, 2, pid) for pid in (0, 1))
    outs = {}
    for pid in (0, 1):
        out = str(tmp_path / f"out{pid}")
        rc = cli.main(["-c", "--num-processes", "2", "--process-id",
                       str(pid), "--input-dir", folder, "--device", "cpu",
                       "--output-dir", out])
        assert rc == 0
        outs[pid] = {n.split("_")[0] for n in _pngs(out)}
        assert outs[pid] == {os.path.basename(f)[:-4] for f in
                             distributed.assign_files(files, 2, pid)}
    assert not outs[0] & outs[1]
    assert outs[0] | outs[1] == {n[:-4] for n in names}


def test_num_processes_env_fallback(monkeypatch, capsys):
    monkeypatch.setenv("SOLEX_NUM_PROCESSES", "4")
    monkeypatch.setenv("SOLEX_PROCESS_ID", "3")
    o = Options()
    parse_cli(o, [])
    assert (o.num_processes, o.process_id) == (4, 3)
    o.validate()
    o2 = Options()                                  # explicit flags win
    parse_cli(o2, ["--num-processes=2", "--process-id=1"])
    assert (o2.num_processes, o2.process_id) == (2, 1)
    monkeypatch.setenv("SOLEX_PROCESS_ID", "x")     # malformed: both ignored
    o3 = Options()
    parse_cli(o3, [])
    assert (o3.num_processes, o3.process_id) == (1, 0)
    assert "malformed" in capsys.readouterr().out
    jo = JaxOptions()
    from solex_ser_recon_en_tpu.cli.flags import parse_cli as jax_parse_cli

    jax_parse_cli(jo, [])
    assert (jo.num_processes, jo.process_id) == (1, 0)


def test_bad_process_id_exits_2(basic_scan, tmp_path, capsys):
    rc = cli.main(["-c", "--num-processes", "2", "--process-id", "2",
                   "--input-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 2 and "process_id" in capsys.readouterr().out


# ---- --profile and SHG_config.txt --------------------------------------------


def test_profile_writes_a_trace(basic_scan, tmp_path, capsys):
    trace = tmp_path / "trace"
    rc = cli.main([f"--profile={trace}", "-c", basic_scan["path"],
                   "--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    files = list(trace.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert str(files[0]) in capsys.readouterr().out


@pytest.mark.parametrize("data", [b"\x00\xffnot json{{{", b"", b"null",
                                  b"[1, 2]", None])
def test_read_ini_of_a_bad_config_gives_the_defaults(tmp_path, data):
    p = tmp_path / "SHG_config.txt"
    if data is not None:
        p.write_bytes(data)
    assert cli.read_ini(str(p)).to_dict() == Options().to_dict()


def test_config_round_trip_with_the_jax_package(tmp_path):
    from solex_ser_recon_en_tpu.cli.main import write_ini as jax_write_ini

    ours = Options(shift=[-2, 0, 2], clahe_only=True, trans_strength=151,
                   de_vignette=True, ratio_fixe=1.05, input_dir="scans",
                   continuous_detect_mode=True, num_processes=3,
                   process_id=1)
    p = str(tmp_path / cli.CONFIG_NAME)
    cli.write_ini(ours, p)
    back = JaxOptions.load(p).to_dict()
    with open(p) as f:
        keys = set(json.load(f))
    assert "de-vignette" in keys and "num_processes" not in keys
    for k in keys:
        assert back[k] == ours.to_dict()[k], k
    assert cli.read_ini(p).to_dict() == {**ours.to_dict(), "num_processes":
                                         1, "process_id": 0}

    theirs = JaxOptions(shift=[5], flip_x=True, fixed_width=1001,
                        output_dir="out", stubborn_transversalium=True)
    q = str(tmp_path / "jax_config.txt")
    jax_write_ini(theirs, q)
    assert cli.read_ini(q).to_dict() == theirs.to_dict()


def test_write_ini_reports_an_unwritable_path(tmp_path, capsys):
    cli.write_ini(Options(), str(tmp_path / "missing" / "SHG_config.txt"))
    assert "failed to write config file" in capsys.readouterr().out
