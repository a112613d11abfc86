"""One run of one cell:

    python3 planbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

set-up (the program, the cell's traffic from the seed, the prewarm and
the warm-up the traffic needs), the measured window, then, with the
program's state freed, the reference's comparison.  The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), ``device``, with the trace a ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines
of standard error).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

from pbench import judge, program
from pbench.registry import Bench
from pbench.runstate import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
BIG = 1.7976931348623157e308       # what an infinite reading prints as


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot) is the JAX stack's, the JAX package's or the old benchmarks'."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _num(x: float) -> float:
    return x if math.isfinite(x) else (BIG if x > 0 else -BIG)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, t_start: float, bench: "Bench | None" = None,
             device=None, require_cuda: bool = True, mix_overrides=None,
             preloaded=(), out=sys.stdout, err=sys.stderr) -> int:
    """The whole run; returns the exit code.  Tests call it with a CPU
    ``device``, ``require_cuda=False``, small overrides of the mix and,
    as ``preloaded``, the forbidden modules their process had loaded
    before the run (other test files load the JAX package)."""
    import torch
    bench = bench or Bench()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    mix = dict(bench.mix(cell["traffic"]), **(mix_overrides or {}))
    if require_cuda:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"planbench: {cell['name']} needs {cell['chips']} CUDA "
                  f"device(s); found {found}", file=err)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
    device = torch.device(device)
    program.load(bench.root)
    gen = bench.generator(mix.get("generator", "stream"))
    run = Run(bench=bench, cell=cell, config=config, mix=mix,
              seed=args.seed, seconds=float(args.seconds),
              trace=bool(args.trace), device=device, t_start=t_start)
    run.mark("torch")
    run.traffic = gen.make(mix, args.seed, run.seconds)
    run.mark("traffic")
    bench.driver(mix["loop"]).drive(run)

    run.notes["builds_in_window"] = run.delta(run.eng_before, run.eng_after,
                                              "exec_cache_misses")
    bad = [m for m in forbidden_modules() if m not in preloaded]
    if bad:
        print(f"planbench: loaded after the window: {', '.join(bad)}",
              file=err)
        return 3

    # the program's part is over: read the trace, free its state, judge
    trace_read = {}
    if run.trace:
        dt = run.devtrace
        trace_read = {"busy_s": dt.busy_s, "window_s": dt.window_s}
    program.release(run.system)
    ref = bench.reference(config["reference"])
    keys = [(o.req.ref, o.req.cost) for o in run.outcomes if o.answered]
    t_ref = time.perf_counter()
    sols = judge.solve_refs(ref, run.traffic.refs, keys,
                            config["semantics"], device)
    numbers = judge.compare(ref, run.outcomes, sols)
    run.notes["reference_s"] = time.perf_counter() - t_ref
    run.notes["compared"] = len(keys)
    correct, checks = judge.verdict(numbers, config["limits"])

    metrics = {}
    for m in bench.metrics_for(cell["name"], run.trace):
        v = bench.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": _num(float(v)), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    dev.update(trace_read)
    result = {"correct": correct, "attempted": len(run.outcomes),
              "failed": int(numbers["unanswered"]), "metrics": metrics,
              "device": dev}
    if run.trace:
        result["breakdown"] = {
            "device_ops": run.devtrace.device_ops(),
            "idle_gaps": run.devtrace.idle_gaps()}
    result["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    notes = {k: v for k, v in run.notes.items() if k != "prewarm"}
    print(f"planbench: {cell['name']} seed {args.seed}: setup "
          f"{run.setup_s:.3f} s, {json.dumps(notes, default=str)}", file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None, t_start: "float | None" = None) -> int:
    args = parse(argv)
    t0 = time.perf_counter() if t_start is None else t_start
    return run_cell(args, t0)
