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


def test_layers_are_named_in_perf_md(bench):
    perf = (ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]
