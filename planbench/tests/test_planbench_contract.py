"""``BENCHMARK.json`` and the result line keep to their schema."""
import json
import re

import pytest

from _planbench_util import ROOT, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_schema():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    for p in spec["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith(tuple(spec["paths"]))
        assert (ROOT / c["file"]).is_file()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert len(cells) == len(spec["workloads"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (ROOT / "planbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    names = set()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= set(cells)
        assert (ROOT / "planbench" / "metrics"
                / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:         # each cell reports what it moves
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or w in mv["workloads"]
    for w in cells:                      # setup_s, one more, one per layer
        mine = [m for m in spec["end_to_end"]
                if w in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])


@pytest.mark.parametrize("workload,trace", [("plansvc.fresh", 0),
                                            ("plansvc.fresh", 1),
                                            ("plansvc.bigjoin", 0)])
def test_result_line_schema(workload, trace):
    rc, res, err = run_small(workload, trace=trace)
    assert rc == 0, err
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    spec = _spec()
    want = {m["name"]: m for m in (spec["per_layer"] if trace
                                   else spec["end_to_end"])
            if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) <= set(want)
    for k, v in res["metrics"].items():
        assert v["unit"] == want[k]["unit"]
        assert isinstance(v["value"], float)
    if not trace:
        assert set(res["metrics"]) == set(want)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    for k, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {k} " in err
    assert err.strip().splitlines()[-1].startswith("check ")
