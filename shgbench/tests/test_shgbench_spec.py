"""BENCHMARK.json against the benchmark's contract, and every configuration,
mix, metric and limit found by name."""

import json
import re

import pytest

from shgbench.harness import BENCH_DIR, ROOT, load_cell, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["shgbench"]
    assert bench["command"][:2] == ["python3", "shgbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    n = 24
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("shgbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and 1 <= len(c["source"]) <= 200
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["scan_bytes"] == (cfg["frames"] * cfg["slit_px"]
                                     * cfg["spectral_px"] * cfg["bit_depth"] // 8)
        assert (ROOT / cfg["reference"]).is_file()
    assert len({c["source"] for c in bench["configs"]}) == len(names)


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    seen = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH_DIR / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    assert configs == {w["config"] for w in bench["workloads"]}


def test_metrics(bench):
    names = set()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert callable(load_reader(m["name"]))
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_cell_loads_by_name(bench):
    for w in bench["workloads"]:
        cell = load_cell(w["name"], bench)
        assert cell.mix["kind"] in ("serial", "session")
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert {m["name"] for m in cell.e2e} >= {"setup_s"}


def test_pending_cells_meet_the_same_rules():
    """A cell under shgbench/pending/ is a BENCHMARK.json away: with its
    entries added, the file still meets every rule above."""
    from .conftest import bench_with_pending

    full = bench_with_pending()
    assert len(full["workloads"]) > 1
    for test in (test_workloads, test_metrics, test_every_cell_loads_by_name):
        test(full)
    names = [w["name"] for w in full["workloads"]]
    assert len(set(names)) == len(names)


PENDING = sorted((BENCH_DIR / "pending").glob("*.json"))


def _promoted(bench, pending):
    """``bench`` with ``pending`` promoted as its ``why`` says: its entries
    added, and its cells' names added to the workloads of the metrics
    under ``reports``."""
    bench = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += json.loads(json.dumps(pending.get(key, [])))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in pending.get("reports", []) and "workloads" in m:
            m["workloads"] += [w["name"] for w in pending["workloads"]]
    return bench


def _as_sets(bench):
    """``bench`` with every list taken as a set."""
    def entry(e):
        e = dict(e, workloads=sorted(e["workloads"])) if "workloads" in e else e
        return json.dumps(e, sort_keys=True)

    return {k: sorted(map(entry, v)) if k in ("configs", "workloads",
                                               "end_to_end", "per_layer")
            else v for k, v in bench.items()}


def _appended(bench):
    """What ``bench_with_pending`` returned before it skipped what
    ``bench`` holds: every pending entry appended, and each pending cell's
    name appended to the workloads of the metrics it reports."""
    bench = json.loads(json.dumps(bench))
    pendings = [json.loads(p.read_text()) for p in PENDING]
    for pending in pendings:
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + pending.get(key, [])
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for pending in pendings:
        for cell in pending.get("workloads", []):
            for name in pending.get("reports", []):
                if "workloads" in metrics[name]:
                    metrics[name]["workloads"].append(cell["name"])
    return bench


def _backed_out(bench):
    """``bench`` without anything a pending file defines: the entries of
    its names, and its cells' names in the metrics' workloads."""
    bench = json.loads(json.dumps(bench))
    pendings = [json.loads(p.read_text()) for p in PENDING]
    cells = {w["name"] for p in pendings for w in p.get("workloads", [])}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for p in pendings for e in p.get(key, [])}
        bench[key] = [e for e in bench[key] if e["name"] not in names]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in m["workloads"] if c not in cells]
    return bench


@pytest.fixture(scope="module")
def unpromoted(bench):
    """BENCHMARK.json before any pending file was promoted into it (on a
    tree that has promoted none, BENCHMARK.json itself)."""
    return _backed_out(bench)


@pytest.mark.parametrize("path", PENDING, ids=lambda p: p.stem)
def test_a_promoted_pending_file_changes_nothing(unpromoted, path):
    """Promoting a pending file into BENCHMARK.json and leaving the file in
    place meets every rule, names nothing twice, and gives the view that
    the unpromoted tree gives."""
    from .conftest import bench_with_pending

    promoted = _promoted(unpromoted, json.loads(path.read_text()))
    full = bench_with_pending(promoted)
    for test in (test_workloads, test_metrics, test_every_cell_loads_by_name):
        test(full)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in full[key]]
        assert len(set(names)) == len(names), key
    for m in full["end_to_end"] + full["per_layer"]:
        cells = m.get("workloads", [])
        assert len(set(cells)) == len(cells), m["name"]
    assert _as_sets(full) == _as_sets(bench_with_pending(unpromoted))
    assert _as_sets(full) == _as_sets(bench_with_pending(full))


@pytest.mark.parametrize("key,value", [("config", "fulldisk8"),
                                       ("traffic", "single"), ("chips", 4)])
def test_a_promoted_cell_unlike_its_pending_file_is_refused(unpromoted, key,
                                                            value):
    from .conftest import bench_with_pending

    pending = json.loads((BENCH_DIR / "pending" /
                          "fulldisk16.sweep5.json").read_text())
    promoted = _promoted(unpromoted, pending)
    cell = next(w for w in promoted["workloads"]
                if w["name"] == "fulldisk16.sweep5")
    cell[key] = value
    with pytest.raises(ValueError, match="fulldisk16.sweep5"):
        bench_with_pending(promoted)
    cell[key] = pending["workloads"][0][key]
    cell["why"] = "another reason, in other words"
    full = bench_with_pending(promoted)
    assert [w["why"] for w in full["workloads"]
            if w["name"] == "fulldisk16.sweep5"] == [cell["why"]]


def test_the_view_without_promoted_cells_is_the_appended_one(bench,
                                                             unpromoted):
    """Where BENCHMARK.json holds nothing a pending file defines, the view
    is what appending every pending entry gave, list order included."""
    from .conftest import bench_with_pending

    assert bench_with_pending(unpromoted) == _appended(unpromoted)
    assert bench_with_pending(bench) == bench_with_pending()
    assert bench == json.loads((ROOT / "BENCHMARK.json").read_text())


#: what the pending files add to a BENCHMARK.json that holds none of them:
#: the names of the entries appended, and the cells added to each metric
SWEEP5 = ["fulldisk16.sweep5"]
ADDED = {"configs": [], "workloads": SWEEP5,
         "end_to_end": ["scan_s.p90", "session_frames_per_s"],
         "per_layer": [],
         "cells_of": {m: SWEEP5 for m in (
             "kernel_ms_per_scan", "sum_max_roofline", "recon_roofline",
             "hresample_roofline", "tile_hist_roofline")}}


def test_the_view_adds_the_pinned_entries(unpromoted):
    """The ``--pending`` view adds to the unpromoted BENCHMARK.json the
    entries and cells pinned in ``ADDED``, and nothing else."""
    from .conftest import bench_with_pending

    full = bench_with_pending(unpromoted)
    added = {}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        held = [e["name"] for e in unpromoted[key]]
        assert [e["name"] for e in full[key]][:len(held)] == held
        added[key] = [e["name"] for e in full[key]][len(held):]
    before = {m["name"]: m.get("workloads")
              for m in unpromoted["end_to_end"] + unpromoted["per_layer"]}
    added["cells_of"] = {}
    for m in full["end_to_end"] + full["per_layer"]:
        if m["name"] in before and m.get("workloads") != before[m["name"]]:
            cells = m["workloads"]
            assert cells[:len(before[m["name"]])] == before[m["name"]]
            added["cells_of"][m["name"]] = cells[len(before[m["name"]]):]
    assert added == ADDED


def test_layers_are_named_in_perf_md(bench):
    perf = (ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]
