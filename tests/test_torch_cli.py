"""The PyTorch port's command line and the JAX CLI's long options (CPU).

``--input-dir``, ``--num-processes``, ``--process-id``, ``--feed``,
``--mesh`` and ``--profile`` run as in the JAX CLI: each case here, in
both the ``--name value`` and the ``--name=value`` form, exits 0 and
writes its products; every feed mode runs, and a bad one exits 2 with the
JAX CLI's message.  A bad ``--mesh`` spec and any unknown ``--name`` exit
2 with nothing written.  Before the port refused them, such a token fell
into the packed single-letter flag parser: ``--mesh 8`` reached the ``h``
of "mesh" and exited 0 with nothing done.
"""

import os
import shutil
import tempfile

import pytest

from solex_ser_recon_en_torch.cli.flags import UNPORTED_LONG_OPTS
from solex_ser_recon_en_torch.cli.main import main as cli_main
from solex_ser_recon_en_torch.parallel.distributed import assign_files

VALUES = {"--mesh": "frame=8", "--feed": "host", "--input-dir": "scans",
          "--num-processes": "2", "--process-id": "1"}
UNPORTED = ()
PORTED = ("--input-dir", "--num-processes", "--process-id", "--feed",
          "--mesh")


def _cases(names):
    return ([(name, [name, VALUES[name]]) for name in names]
            + [(name, [f"{name}={VALUES[name]}"]) for name in names])


CASES = _cases(UNPORTED) + [("--frobnicate", ["--frobnicate"]),
                            ("--frobnicate", ["--frobnicate=3"]),
                            ("--mesh", ["--mesh", "rows=3"]),
                            ("--mesh", ["--mesh=frame="])]
RUN_CASES = _cases(PORTED) + [("--profile", ["--profile"]),
                              ("--profile", ["--profile=prof"])]
#: the folder of the folder cases: ``--num-processes 2`` gives c.ser to
#: process 0 and a.ser, b.ser to process 1
SCANS = ("a.ser", "b.ser", "c.ser")


def test_every_jax_long_option_is_named():
    """Each long option of the JAX CLI is either refused here or run by a
    case of ``test_ported_long_option_runs``."""
    assert set(UNPORTED_LONG_OPTS) == set(UNPORTED)
    assert set(VALUES) | {"--profile"} == \
        set(UNPORTED_LONG_OPTS) | {name for name, _ in RUN_CASES}


@pytest.mark.parametrize("name,tokens", CASES,
                         ids=[" ".join(tok) for _, tok in CASES])
def test_unported_long_option_exits_2(basic_scan, tmp_path, capsys, name,
                                      tokens):
    out = tmp_path / "out"
    rc = cli_main([*tokens, "-cw0", basic_scan["path"], "--device", "cpu",
                   "--output-dir", str(out)])
    assert rc == 2
    said = capsys.readouterr().out
    assert "ERROR: " in said and name in said
    if name in UNPORTED_LONG_OPTS:
        assert "not ported" in said
    elif name == "--mesh":
        assert "invalid mesh spec" in said
    else:
        assert "unknown option" in said
    assert not out.exists() or not any(out.iterdir())


@pytest.mark.parametrize("name,tokens", RUN_CASES,
                         ids=[" ".join(tok) for _, tok in RUN_CASES])
def test_ported_long_option_runs(basic_scan, tmp_path, monkeypatch, capsys,
                                 name, tokens):
    """The folder options run over ./scans (the share of ``--process-id``
    is process 1's of 2, that of ``--num-processes 2`` alone process 0's);
    ``--profile`` runs one file and writes its trace (bare: into the
    temporary directory's solex_profile)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    os.makedirs("scans")
    for s in SCANS:
        shutil.copy(basic_scan["path"], os.path.join("scans", s))
    out = tmp_path / "out"
    argv = [*tokens, "-cw0", "--device", "cpu", "--output-dir", str(out)]
    if name == "--profile":
        argv.append(basic_scan["path"])
        want = ["basic"]
    else:
        if name != "--input-dir":
            argv += ["--input-dir", "scans"]
        if name == "--process-id":
            argv += ["--num-processes", "2"]
        files = [os.path.join("scans", s) for s in SCANS]
        pid = {"--num-processes": 0, "--process-id": 1}.get(name)
        share = files if pid is None else assign_files(files, 2, pid)
        want = sorted(os.path.basename(f)[:-4] for f in share)
    rc = cli_main(argv)
    assert rc == 0
    assert sorted(p.name for p in out.iterdir() if p.suffix == ".png") == \
        [f"{w}_shift=0_clahe.png" for w in want]
    if name == "--profile":
        trace_dir = tmp_path / ("prof" if "=" in tokens[0]
                                else "solex_profile")
        traces = list(trace_dir.iterdir())
        assert len(traces) == 1 and traces[0].name.endswith(".trace.json")
        assert "profiler trace written to" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["auto", "device", "band", "host"])
def test_every_feed_mode_runs(basic_scan, tmp_path, mode):
    """``--feed MODE`` on one file: rc 0, the product, and the feed in the
    run log (``auto`` is ``device`` on the CPU)."""
    out = tmp_path / "out"
    rc = cli_main(["-cw0", basic_scan["path"], "--device", "cpu",
                   "--feed", mode, "--output-dir", str(out)])
    assert rc == 0
    assert (out / "basic_shift=0_clahe.png").exists()
    taken = "device" if mode == "auto" else mode
    assert f"Feed : {taken} (" in (out / "basic_log.txt").read_text()


@pytest.mark.parametrize("tokens", [["--feed", "bogus"], ["--feed=bogus"]],
                         ids=["--feed bogus", "--feed=bogus"])
def test_bad_feed_mode_exits_2(basic_scan, tmp_path, capsys, tokens):
    out = tmp_path / "out"
    rc = cli_main([*tokens, "-cw0", basic_scan["path"], "--device", "cpu",
                   "--output-dir", str(out)])
    assert rc == 2
    said = capsys.readouterr().out
    assert "invalid feed mode 'bogus' (auto|device|band|host)" in said
    assert not out.exists() or not any(out.iterdir())


def test_python_m_package_runs_the_cli(basic_scan, tmp_path):
    """``python -m solex_ser_recon_en_torch`` is ``shg-torch``: its
    ``-cw0 --device cpu`` product equals the in-process run's, byte for
    byte, and without ``--device cpu`` on a machine with no CUDA it exits
    2."""
    import subprocess
    import sys

    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    sub, here = tmp_path / "sub", tmp_path / "here"
    res = subprocess.run(
        [sys.executable, "-m", "solex_ser_recon_en_torch", "--device", "cpu",
         "-cw0", basic_scan["path"], "--output-dir", str(sub)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert cli_main(["-cw0", basic_scan["path"], "--device", "cpu",
                     "--output-dir", str(here)]) == 0
    name = "basic_shift=0_clahe.png"
    assert (sub / name).read_bytes() == (here / name).read_bytes()
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "solex_ser_recon_en_torch", "-cw0",
             basic_scan["path"], "--output-dir", str(tmp_path / "none")],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 2 and "CUDA is not available" in res.stdout
        none = tmp_path / "none"
        assert not none.exists() or not any(none.iterdir())
