#!/usr/bin/env python3
"""Where the time of the port's batch lane goes, on one card.

    PYTHONPATH=src python3 scripts/profile_torch_lane.py \
        [--cost max|cap|out] [--out FILE.json]

``--cost max`` (the default) runs the workload of ``chip_smoke.py``
phase 5 (16 paper Sec. 9 clique(15) queries, chain/star/cycle at
n = 12..15, one clique(12)) through
``repro_torch.service.batch.BatchedSolver`` three ways — the default
policy (fused engine, int32 kernel tier), the f64 tier, and the host
engine on the kernel tier.  ``--cost cap`` runs phase 8's workload (16
clique(15) as ``"cap"``, chain/star/cycle(15) as ``"cap_conn"``) and
``--cost out`` phase 9's (the same 19 graphs as ``"out"``) through the
default policy, and then each part alone: the connected-subset masks
of the connected graphs, on the card as the programs build them
(``lattice.connected_masks``, the ``connmask`` kernel) beside the host's
numpy masks (``dpccp.connectivity_masks``) that the lane built before,
and on the 16 cliques the pass-1 search (cap), the (min,+) sweep and
the value-mode extraction scan.

Each run goes once to warm up, once without the profiler (wall,
queries/s, peak device memory) and once under ``torch.profiler`` (the
card's busy time, the sum of kernel times, and launches); the idle share
divides the one by the other.  It prints host syncs and the kernels that
take the most device time.  ``--out`` also writes the numbers as JSON.
Needs a card; imports nothing of JAX or ``repro``.
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


def profile(run, queries: int, label: str, passes_of=None) -> dict:
    """Profile ``run()`` (one solve of ``queries`` queries): a warm-up
    call, an unprofiled call for wall time, a profiled one for device
    time.  ``passes_of(results)`` counts feasibility passes (max lane)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.core import engine
    from repro_torch.kernels import ops

    run()                                        # warm-up, programs built
    torch.cuda.synchronize()
    engine.reset_stats()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()                     # unprofiled wall
    results = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats().as_dict()
    own = ops.launch_counts()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    out = {
        "label": label, "queries": queries, "wall_s": wall,
        "profiled_wall_s": prof_wall,
        "queries_per_s": queries / wall,
        "peak_device_bytes": peak,
        "device_busy_s": busy_us * 1e-6,
        "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
        "kernel_launches": launches,
        "launches_per_query": launches / queries,
        "own_kernel_launches": own,
        "passes": passes_of(results) if passes_of else None,
        "fused_solves": st["solves"], "fused_host_syncs": st["host_syncs"],
        "fused_rounds": st["rounds"],
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) * 1e-3}
                        for e in top],
    }
    print(f"== {label}: {queries} queries, wall {wall:.4f} s "
          f"({prof_wall:.4f} s profiled), {out['queries_per_s']:.2f} "
          f"queries/s, peak device memory {peak / 2**20:.1f} MiB, device "
          f"busy {out['device_busy_s']:.4f} s, idle share "
          f"{out['device_idle_share']:.4f}, {launches} kernel launches "
          f"({out['launches_per_query']:.1f} per query), own kernels "
          f"{own}, feasibility passes {out['passes']}, fused solves "
          f"{st['solves']}, host syncs {st['host_syncs']}, fused rounds "
          f"{st['rounds']}", flush=True)
    for k in out["top_kernels"]:
        print(f"   {k['device_ms']:9.4f} ms  {k['count']:6d}x  {k['name']}")
    return out


def lane(solver, items, label: str, max_lane: bool = False) -> dict:
    """Profile ``solver.solve(items)``; on the max lane also count one
    feasibility pass per round plus the extraction pass, per chunk."""
    def passes(results):
        return sum(r.meta["passes"] / r.meta["chunk"] for r in results)
    out = profile(lambda: solver.solve(items), len(items), label,
                  passes if max_lane else None)
    out["chunks"] = len(solver.last_timings)
    return out


def max_runs(qg) -> list:
    from repro_torch.core.engine import candidate_table
    from repro_torch.service.batch import BatchedSolver, BatchPolicy
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
    return [
        lane(BatchedSolver(), items, "fused, kernel tier (default)", True),
        lane(BatchedSolver(BatchPolicy(backend="f64")), items,
             "fused, f64 tier", True),
        lane(BatchedSolver(BatchPolicy(engine="host")), items,
             "host engine, kernel tier", True),
    ]


def value_runs(qg, cost: str) -> list:
    """The cap-15 or out-15 lane, then its parts alone on the 16
    cliques."""
    import numpy as np
    import torch

    from repro_torch.core import engine, lattice
    from repro_torch.core.dpccp import connectivity_masks
    from repro_torch.service.batch import BatchedSolver

    cliques = [qg.paper_clique_instance(15, seed) for seed in range(16)]
    sparse = []
    for i, maker in enumerate((qg.chain, qg.star, qg.cycle)):
        q = maker(15)
        sparse.append((q, qg.make_cardinalities(q, seed=300 + i)))
    if cost == "cap":
        items = ([(q, c, "cap") for q, c in cliques]
                 + [(q, c, "cap_conn") for q, c in sparse])
    else:
        items = [(q, c, "out") for q, c in cliques + sparse]
    runs = [lane(BatchedSolver(), items, f"{cost} lane, fused (default)")]
    graphs = [q for q, _, c in items if cost == "out" or c == "cap_conn"]
    t0 = time.perf_counter()
    for q in graphs:
        connectivity_masks(q)
    host_s = time.perf_counter() - t0
    runs.append({"label": "host: connected-subset masks", "queries":
                 len(graphs), "wall_s": host_s})
    print(f"== host: connected-subset masks of {len(graphs)} graphs "
          f"(numpy, what the lane built before the connmask kernel): "
          f"{host_s:.4f} s", flush=True)
    dev = torch.device("cuda", 0)
    adjs = torch.as_tensor(np.stack([q.adjacency() for q in graphs]),
                           dtype=torch.int32, device=dev)
    runs.append(profile(lambda: lattice.connected_masks(adjs, 15),
                        len(graphs), "connected-subset masks alone, "
                        "connmask kernel"))
    cards_np = np.stack([c for _, c in cliques])
    cards = torch.as_tensor(cards_np, device=dev)
    if cost == "cap":
        runs.append(profile(
            lambda: engine.fused_dpconv_max(cards_np, 15,
                                            extract_tree=False, device=dev),
            16, "pass 1 alone: lockstep search, f64 tier, 16 cliques"))
        gammas = engine.fused_dpconv_max(cards_np, 15, extract_tree=False,
                                         device=dev).optima
        pc = lattice.popcounts_on(15, dev)
        mask = ((cards <= torch.as_tensor(gammas, device=dev)[:, None])
                | (pc < 2))
        sweep = lambda: lattice.minplus_value_layers(cards, mask, 15)  # noqa: E731
        what = "(min,+) value sweep"
    else:
        mask = torch.as_tensor(np.stack([connectivity_masks(q)
                                         for q, _ in cliques]), device=dev)
        sweep = lambda: lattice.minplus_connected_layers(cards, mask, 15)  # noqa: E731
        what = "(min,+) connected sweep"
    runs.append(profile(sweep, 16, f"{what} alone, 16 cliques"))
    dpv = sweep()
    runs.append(profile(lambda: lattice.extract_scan(dpv, 15, card=cards),
                        16, "value-mode extraction scan alone, 16 cliques"))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cost", choices=("max", "cap", "out"), default="max",
                    help="which lane's workload to profile")
    ap.add_argument("--out", help="write the numbers to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 1
    from repro_torch.core import querygraph as qg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs = max_runs(qg) if args.cost == "max" else value_runs(qg, args.cost)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "cost": args.cost,
                                   "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
