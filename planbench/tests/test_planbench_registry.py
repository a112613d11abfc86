"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new ``BENCHMARK.json`` entries, and the harness
finds each by its name without an edit to any file it already has."""
import hashlib
import json
import shutil

from _planbench_util import PLANBENCH, ROOT, SMALL, run_small
from pbench.registry import Bench


def _digest(base):
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(base.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_config_and_metric_as_files_only(tmp_path):
    base = tmp_path / "planbench"
    shutil.copytree(PLANBENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(base)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((base / "configs" / "plansvc-synth.json").read_text())
    cfg["name"] = "plansvc-nolayer"
    cfg["server"]["layer_cache"] = False
    (base / "configs" / "plansvc-nolayer.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "fresh.json").read_text())
    mix.update(SMALL, clients=4)
    mix["topologies"] = ["chain", "star"]
    (base / "traffic" / "chains.json").write_text(json.dumps(mix))
    (base / "metrics" / "runtime.answered_share.py").write_text(
        "def read(run):\n"
        "    done = sum(o.answered for o in run.outcomes)\n"
        "    return 100.0 * done / len(run.outcomes)\n")
    spec["configs"].append({"name": "plansvc-nolayer", "source": "test",
                            "file": "planbench/configs/plansvc-nolayer.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "plansvc.chains",
                              "config": "plansvc-nolayer",
                              "traffic": "chains", "chips": 1,
                              "why": "test"})
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    e2e["plans_per_s.svc"]["workloads"].append("plansvc.chains")
    spec["per_layer"].append({"name": "runtime.answered_share", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "runtime: service/runtime.py, "
                              "server.py", "moves": "plans_per_s.svc",
                              "workloads": ["plansvc.chains"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
    bench = Bench(root=tmp_path, base=base)
    assert bench.config("plansvc-nolayer")["server"]["layer_cache"] is False
    rc, res, err = run_small("plansvc.chains", bench=bench, overrides={})
    assert rc == 0, err
    assert res["correct"] and set(res["metrics"]) == {"plans_per_s.svc",
                                                      "setup_s"}
    rc, res, err = run_small("plansvc.chains", bench=bench, overrides={},
                             trace=1)
    assert rc == 0, err
    assert res["metrics"]["runtime.answered_share"]["value"] == 100.0
