#!/usr/bin/env python3
"""Where the time of the port's DPconv[max] batch lane goes, on one card.

    PYTHONPATH=src python3 scripts/profile_torch_lane.py [--out FILE.json]

Runs the workload of ``chip_smoke.py`` phase 5 (16 paper Sec. 9
clique(15) queries, chain/star/cycle at n = 12..15, one clique(12))
through
``repro_torch.service.batch.BatchedSolver`` three ways — the default
policy (fused engine, int32 kernel tier), the f64 tier, and the host
engine on the kernel tier — once to warm up and once under
``torch.profiler``.  For each it prints wall time, the card's busy time
(sum of kernel times) and idle share, kernel launches per solved query,
host syncs, feasibility passes, and the kernels that take the most
device time.  Wall and queries/s come from a run without the profiler;
busy time and launches from the profiled run that follows it (the idle
share divides the one by the other).  ``--out`` also writes the numbers
as JSON.  Needs a card; imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(solver, items, label: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.core import engine
    from repro_torch.kernels import ops

    solver.solve(items)                          # warm-up, programs built
    torch.cuda.synchronize()
    engine.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()                     # unprofiled wall
    results = solver.solve(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats().as_dict()
    own = ops.launch_counts()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(items)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    # one feasibility pass per round plus the extraction pass, per chunk
    passes = sum(r.meta["passes"] / r.meta["chunk"] for r in results)
    out = {
        "label": label, "queries": len(items), "wall_s": wall,
        "profiled_wall_s": prof_wall,
        "queries_per_s": len(items) / wall,
        "device_busy_s": busy_us * 1e-6,
        "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
        "kernel_launches": launches,
        "launches_per_query": launches / len(items),
        "own_kernel_launches": own, "chunks": len(solver.last_timings),
        "passes": passes, "fused_host_syncs": st["host_syncs"],
        "fused_rounds": st["rounds"],
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) * 1e-3}
                        for e in top],
    }
    print(f"== {label}: {len(items)} queries in {out['chunks']} chunks, "
          f"wall {wall:.4f} s ({prof_wall:.4f} s profiled), "
          f"{out['queries_per_s']:.2f} queries/s, device busy "
          f"{out['device_busy_s']:.4f} s, idle share "
          f"{out['device_idle_share']:.4f}, {launches} kernel launches "
          f"({out['launches_per_query']:.1f} per query), own kernels "
          f"{own}, feasibility passes {passes:g}, fused-engine host syncs "
          f"{st['host_syncs']}, fused rounds {st['rounds']}", flush=True)
    for k in out["top_kernels"]:
        print(f"   {k['device_ms']:9.4f} ms  {k['count']:6d}x  {k['name']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the numbers to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 1
    from repro_torch.core import querygraph as qg
    from repro_torch.core.engine import candidate_table
    from repro_torch.service.batch import BatchedSolver, BatchPolicy

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    items = [qg.paper_clique_instance(15, seed) for seed in range(16)]
    for n in range(12, 16):
        for maker in (qg.chain, qg.star, qg.cycle):
            q = maker(n)
            items.append((q, qg.make_cardinalities(q, seed=100 + n)))
    items.append(qg.paper_clique_instance(12, 16))
    ncand = [len(candidate_table(c, q.n)) for q, c in items]
    print(f"candidate tables: {sum(k == 1 for k in ncand)} of {len(items)} "
          f"queries have one candidate (no search round); the others "
          f"{sorted(k for k in ncand if k > 1)}", flush=True)
    runs = [
        profile(BatchedSolver(), items, "fused, kernel tier (default)"),
        profile(BatchedSolver(BatchPolicy(backend="f64")), items,
                "fused, f64 tier"),
        profile(BatchedSolver(BatchPolicy(engine="host")), items,
                "host engine, kernel tier"),
    ]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
