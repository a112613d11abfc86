"""One traced run of a cell, read beyond its result line: where the
window's time went by the program's own host spans and dispatch records.

    python3 scripts/span_report.py --tag NAME --seconds S RUN [RUN ...]

Each RUN is ``<workload>:<seed>``, run traced in this process through
the benchmark's own ``planbench/run.py`` path (``--cpu``: on the CPU at
the harness tests' small sizes, to try the script without a card).  For
each it keeps the result line and adds:

* ``device_ops``: the 40 device operations that took most time,
  summed by name (the result line's breakdown keeps 10);
* ``kernel_in_calls``: the share of the window's device kernel time
  (kernels, not copies) inside the dispatch records' program calls
  (``t0_ns``..``t1_ns``), which holds only if the program's clock is the
  profiler's;
* ``per_plan_ms``: the window's seconds per answered plan beside the
  per-query sums of the engine's host time, its execute time and the
  front end's spans;
* ``medians_ms``: the median of each span name in the window, and the
  latency median;
* ``idle_gaps``: the longest idle stretches of the device, each with the
  spans and program calls that cover its middle;
* ``minplus_per_call``: the (min,+) sweep kernel's device time and
  launches inside each sweeping program call (records with a
  ``sweep_total``), by cost, n and batch bucket: calls, median and sum
  of the milliseconds, median launches, and the median of the calls'
  valid splits (``sweep_pairs``, a connected sweep's #ccp);
* ``connmask_per_call``: the same for the connected-subset mask kernel
  (``connmask_kernel``), which the connected programs launch once a
  call;
* ``span_site_ns``: the host cost of one span site (open and close a
  child span) on a tracer without and with a profiler session, and of
  ``plan_one``'s site with no session (the shared null span).

Results go to ``chiprun_out/<NAME>.jsonl``.
"""
from __future__ import annotations

import argparse
import collections
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# as planbench/run.py: one thread per numeric library, no JAX
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "planbench"))

from pbench import cli, spans, stats  # noqa: E402
from pbench.registry import Bench  # noqa: E402

# the harness tests' small mixes, for --cpu
SMALL = {
    "plansvc.fresh": {"clients": 4, "classes": [
        {"cost": "max", "weight": 0.7, "n": [7, 8]},
        {"cost": "cap", "weight": 0.15, "n": [7, 7]},
        {"cost": "out", "weight": 0.15, "n": [7, 7]}]},
    "plansvc.bigjoin": {"classes": [{"cost": "max", "weight": 1.0,
                                     "n": [8, 9]}], "block": 2},
    "plansvc.bigjoin-cap": {"classes": [{"cost": "cap", "weight": 1.0,
                                         "n": [8, 9]}], "block": 2},
    "plansvc.sparse-outcap": {"clients": 4, "classes": [
        {"cost": "out", "weight": 0.5, "n": [7, 8]},
        {"cost": "cap", "weight": 0.5, "n": [7, 8]}]},
    "plansvc.sparse-out-large": {"classes": [{"cost": "out", "weight": 1.0,
                                              "n": [8, 9]}], "block": 2},
}
MINPLUS = "minplus_layer_kernel"
CONNMASK = "connmask_kernel"


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"


class _Capturing(Bench):
    """The benchmark as it stands, with one more reader that keeps the
    run's state for this report."""

    def __init__(self):
        super().__init__()
        self.run = None

    def metrics_for(self, cell, trace):
        return super().metrics_for(cell, trace) + [
            {"name": "_capture", "unit": "x"}]

    def reader(self, name):
        if name != "_capture":
            return super().reader(name)
        bench = self

        class _R:
            @staticmethod
            def read(run):
                bench.run = run
                return None
        return _R


def _covering(entries, t_ns):
    """The span names (with their thread) that cover ``t_ns``, shortest
    first."""
    out = [(e[4] - e[3], e[0], e[5]) for e in entries if e[3] <= t_ns
           <= e[4]]
    return [f"{name}@{thread}" for _, name, thread in sorted(out)]


def kernel_per_call(run, recs, kernel: str = MINPLUS) -> dict:
    """A kernel's device time (ms) and launches inside each sweeping
    program call, grouped by (cost, n, B)."""
    dt = run.devtrace
    ks = sorted((a, b) for a, b, name, k in dt.ops if k and kernel in name)
    by = collections.defaultdict(list)
    for r in recs:
        if not getattr(r, "sweep_total", 0):
            continue
        c = (r.t0_ns - dt.t0_ns) * 1e-9
        d = (r.t1_ns - dt.t0_ns) * 1e-9
        inside = [(a, b) for a, b in ks if a < d and b > c]
        by[f"{r.cost} n={r.n} B={r.B}"].append(
            (1e3 * sum(min(b, d) - max(a, c) for a, b in inside),
             len(inside), getattr(r, "sweep_pairs", 0)))
    return {k: {"calls": len(v),
                "ms_p50": stats.percentile([t for t, _, _ in v], 50),
                "ms_sum": sum(t for t, _, _ in v),
                "launches_p50": stats.percentile([m for _, m, _ in v], 50),
                "pairs_p50": stats.percentile([p for _, _, p in v], 50)}
            for k, v in sorted(by.items())}


def analyse(run) -> dict:
    dt = run.devtrace
    recs = spans.records(run) or []
    entries = spans.log_window(run)
    t0 = dt.t0_ns
    calls = [((r.t0_ns - t0) * 1e-9, (r.t1_ns - t0) * 1e-9) for r in recs]
    kernels = [(a, b) for a, b, _, k in dt.ops if k]
    k_total = sum(b - a for a, b in kernels)
    merged = []
    for a, b in sorted(calls):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    inside = 0.0
    for a, b in kernels:
        for c, d in merged:
            if d <= a:
                continue
            if c >= b:
                break
            inside += min(b, d) - max(a, c)
    out = {"records": len(recs), "span_entries":
           None if entries is None else len(entries),
           "log_dropped": getattr(sys.modules.get(spans.TRACE_MODULE),
                                  "SPAN_LOG").dropped,
           "kernel_s": k_total,
           "kernel_in_calls": inside / k_total if k_total else None,
           "window_s": dt.window_s, "busy_s": dt.busy_s,
           "device_ops": dt.device_ops(top=40)}
    answered = [o for o in run.outcomes if o.answered]
    q = sum(r.queries for r in recs)
    per = {"window_per_plan": 1e3 * dt.window_s / max(len(answered), 1),
           "plans": len(answered), "queries": q}
    if q:
        for f in ("prepare_s", "launch_s", "sync_s", "readback_s",
                  "trees_s", "execute_s"):
            per[f] = 1e3 * sum(getattr(r, f) for r in recs) / q
        per["engine_host"] = spans.engine_host_ms_per_query(run)
        per["server_host"] = spans.front_end_ms_per_query(run)
        if per["server_host"] is not None:
            per["accounted"] = (per["engine_host"] + per["server_host"]
                                + per["execute_s"])
    out["per_plan_ms"] = per
    med = {}
    if entries is not None:
        by = collections.defaultdict(list)
        for e in entries:
            by[e[0]].append((e[4] - e[3]) * 1e-6)
        med = {k: {"p50": stats.percentile(v, 50), "n": len(v),
                   "sum": sum(v)} for k, v in sorted(by.items())}
    med["latency"] = stats.percentile([o.latency * 1e3 for o in answered],
                                      50)
    out["medians_ms"] = med
    gaps = stats.gaps([(a, b) for a, b, _, _ in dt.ops], 0.0, dt.window_s)
    gaps.sort(key=lambda g: g[0] - g[1])
    rows = []
    for a, b in gaps[:10]:
        mid = t0 + int((a + b) / 2 * 1e9)
        rows.append({"s": b - a, "at_s": a,
                     "in_call": any(c <= (a + b) / 2 <= d
                                    for c, d in merged),
                     "spans": [] if entries is None
                     else _covering(entries, mid)[:4]})
    out["idle_gaps"] = rows
    out["minplus_per_call"] = kernel_per_call(run, recs, MINPLUS)
    out["connmask_per_call"] = kernel_per_call(run, recs, CONNMASK)
    idle = dt.window_s - dt.busy_s
    out["idle_in_calls_s"] = idle - (
        dt.window_s - stats.union_length(
            [(a, b) for a, b, _, _ in dt.ops] + [tuple(m) for m in merged]))
    return out


def span_site_ns() -> dict:
    """ns per span site: a child span opened and closed on a wall-clock
    tracer with a registry (the runtime's), without and with a profiler
    session, and the null span's site (``plan_one`` with no session)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.service.runtime import WallClock
    n = 20000

    def timed(root):
        t = time.perf_counter()
        for _ in range(n):
            root.child("x").close()
        return (time.perf_counter() - t) / n * 1e9

    def best(fn):
        return min(fn() for _ in range(5))

    tr = trace.Tracer(WallClock(), registry=MetricsRegistry())
    root = tr.request(req_id="site")
    out = {"null": best(lambda: timed(trace.NULL_SPAN)),
           "off": best(lambda: timed(root))}
    t = time.perf_counter()
    for _ in range(n):
        trace.profiling()
    out["profiling_check"] = (time.perf_counter() - t) / n * 1e9
    act = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    with profile(activities=[act]):
        out["on"] = best(lambda: timed(root))
        trace.SPAN_LOG.clear()
    trace.SPAN_LOG.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("runs", nargs="+")
    a = ap.parse_args(argv)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"{a.tag}.jsonl"
    dev = card()
    print(f"card: {dev}", flush=True)
    for spec in a.runs:
        wl, seed = spec.split(":")[:2]
        bench = _Capturing()
        args = argparse.Namespace(workload=wl, seed=int(seed),
                                  seconds=a.seconds, trace=1)
        out, err = io.StringIO(), io.StringIO()
        kw = {}
        if a.cpu:
            kw = dict(device="cpu", require_cuda=False,
                      mix_overrides=SMALL.get(wl),
                      preloaded=set(cli.forbidden_modules()))
        rc = cli.run_cell(args, time.perf_counter(), bench=bench, out=out,
                          err=err, **kw)
        lines = out.getvalue().strip().splitlines()
        rec = {"workload": wl, "seed": int(seed), "rc": rc, "card": dev,
               "result": json.loads(lines[-1]) if lines else None,
               "stderr_tail": err.getvalue()[-2000:]}
        if bench.run is not None and bench.run.devtrace is not None:
            rec["report"] = analyse(bench.run)
        with open(path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
        print(json.dumps({k: rec[k] for k in ("workload", "seed", "rc")}),
              flush=True)
        print(json.dumps(rec.get("report", {}), default=str)[:6000],
              flush=True)
        print(rec["stderr_tail"][-800:], flush=True)
        sys.modules.get(spans.TRACE_MODULE).SPAN_LOG.clear()
    sites = span_site_ns()
    with open(path, "a") as f:
        f.write(json.dumps({"span_site_ns": sites, "card": dev}) + "\n")
    print(json.dumps({"span_site_ns": sites}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
