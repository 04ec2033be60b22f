"""BENCHMARK.json against the form the benchmark requires, and the result line's
schema from a run at a size the CPU holds."""

import json
import math
import re

import pytest

from perfbench import run
from perfbench.harness import ROOT, load_cell
from perfbench.tiny import tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
        assert (ROOT / c["file"]).exists()
        assert (ROOT / "perfbench" / "reference" / f"{c['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").exists()
        cell = load_cell(w["name"])
        assert (ROOT / "perfbench" / "runners" / f"{cell.config['task']}_"
                f"{cell.traffic['kind']}.py").exists()


def test_metrics_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert (ROOT / "perfbench" / "end_to_end" / f"{m['name']}.py").exists()
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert w in WORKLOADS
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]
    for w in WORKLOADS:
        cell = load_cell(w)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer


def test_a_full_check_fits_its_time():
    """2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s a cell to
    compile, 1200 s spare: within 43200 s at 24 cells."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(workload, trace):
    cell = tiny_cell(workload)
    result, rows = run.run_cell(cell, 2 ** 31 + 7, 0.3, trace, "cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    assert [r[0] for r in rows] == list(line["checks"])
    # the program's plain path on the CPU against the reference
    assert line["correct"], line["checks"]
