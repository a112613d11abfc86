"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one precision below the
configuration's (float32 for its float64), and judged as a run's
answers are.  It has to come out as not correct.

    python3 planbench/control.py --workload <cell> --count <k> \
        --seed <n> [<n> ...]

For each seed it answers the first ``--count`` requests of the cell's
stream (as many as a run of the cell compares), prints each number
beside its limit and the verdict, one JSON line a seed, and exits 0;
the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from pbench import judge
from pbench.registry import Bench
from pbench.runstate import Outcome


def control(bench, cell_name: str, seed: int, count: int, device,
            mix_overrides=None, dtype=torch.float32) -> dict:
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    mix = dict(bench.mix(cell["traffic"]), **(mix_overrides or {}))
    traffic = bench.generator(mix.get("generator", "stream")).make(
        mix, seed, 0.0)
    reqs = [next(traffic.more) for _ in range(count)]
    ref = bench.reference(config["reference"])
    sem = config["semantics"]
    outcomes = [Outcome(req=r, due=0.0, done=0.0, status="exact")
                for r in reqs]
    keys = [(r.ref, r.cost) for r in reqs]
    low = judge.solve_refs(ref, traffic.refs, keys, sem, device, dtype=dtype)
    answers = {}
    for r in reqs:
        sol = low[(r.ref, r.cost)]
        answers[r.i] = (sol["opt"], ref.extract_tree(sol, r.n))
    sols = judge.solve_refs(ref, traffic.refs, keys, sem, device)
    numbers = judge.compare(ref, outcomes, sols, answers=answers)
    correct, checks = judge.verdict(numbers, config["limits"])
    return {"workload": cell_name, "seed": seed, "compared": len(reqs),
            "precision": str(dtype).replace("torch.", ""),
            "correct": correct, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--count", type=int, required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in a.seed:
        res = control(Bench(), a.workload, seed, a.count, device)
        for k, c in res["checks"].items():
            print(f"control {seed} {k} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        res["checks"] = {k: {"value": min(c["value"],
                                          1.7976931348623157e308),
                             "limit": c["limit"]}
                         for k, c in res["checks"].items()}
        print(json.dumps(res), flush=True)
    return 0
