#!/usr/bin/env python3
"""The (min,+) sweep of C_cap's pass 2 on one card: the table-free
``minplus_layer`` kernel against the gather sweep it replaces.

    python3 scripts/bench_minplus.py [--ns 16 17 18 19] [--reps 5]
        [--fit-batch 16] [--out F]

For each n, on a clique(n) of the paper's cardinalities (DPconv Sec. 9,
seeded) gated at its C_max optimum, as pass 2 runs it:

* ``kernel``: ``lattice.minplus_value_layers`` on the card (n - 1
  launches, no split table);
* ``gather``: the same sweep by split tables (``lattice._minplus_sweep``
  with ``_value_layer``, the plain version's arithmetic on the card):
  the tables' device bytes (``direct_layer_tables``, kept for good), the
  host RAM they took (their numpy copies, ``direct_layer_indices``) and
  its first sweep's wall time, which builds them;

each with its device time per sweep (CUDA events around ``--reps``
sweeps after one warm sweep), the peak device memory of one sweep above
what was allocated before it, and the live share of the gate.  The two
tables are compared bitwise.  Then one B = ``--fit-batch`` C_cap program
at the largest n through ``engine.fused_ccap`` (its build, first touch
and one call): its wall time and peak device memory.

Needs a card; imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _timed(fn, reps: int):
    import torch
    fn()                                       # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            torch.cuda.max_memory_allocated() - base, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", type=int, nargs="+", default=[16, 17, 18, 19])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fit-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2409)
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.core import engine, lattice
    from repro_torch.core.bitset import popcounts
    from repro_torch.core.querygraph import clique, make_cardinalities

    if not torch.cuda.is_available():
        print("bench_minplus: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)
    rows = []

    def emit(row: dict) -> None:
        row["device"] = name
        rows.append(row)
        print(json.dumps(row), flush=True)

    for n in args.ns:
        q = clique(n)
        card = make_cardinalities(q, seed=args.seed + n, base_range=(1e2, 1e6),
                                  selectivity_range=(1e-4, 1.0), cap=1e8)
        gamma = float(engine.fused_dpconv_max(card[None, :], n,
                                              extract_tree=False,
                                              device=dev).optima[0])
        pc = popcounts(n)
        ok_np = (card <= gamma) | (pc < 2)
        cards = torch.as_tensor(card[None, :], device=dev)
        ok = torch.as_tensor(ok_np[None, :], device=dev)
        live = float((ok_np & (pc >= 2)).sum() / (pc >= 2).sum())

        ms, peak, dp_k = _timed(
            lambda: lattice.minplus_value_layers(cards, ok, n), args.reps)
        emit({"n": n, "sweep": "kernel", "ms": ms, "peak_bytes": peak,
              "launches": n - 1, "live_share": live, "gamma": gamma})

        torch.cuda.synchronize()
        dev_before = torch.cuda.memory_allocated()
        rss0 = _rss_bytes()
        t0 = time.perf_counter()
        gather = (lambda: lattice._minplus_sweep(
            cards, n, lattice._value_layer, (cards, ok), None,
            lattice.SHARD_CHUNK_ELEMS))
        gather()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        tables = torch.cuda.memory_allocated() - dev_before
        host = _rss_bytes() - rss0
        ms_g, peak_g, dp_g = _timed(gather, args.reps)
        same = bool(torch.equal(dp_k, dp_g))
        emit({"n": n, "sweep": "gather", "ms": ms_g, "peak_bytes": peak_g,
              "table_bytes": tables, "host_rss_bytes": host,
              "first_sweep_s": first_s, "bitwise_equal": same,
              "live_share": live})
        if not same:
            print(f"bench_minplus: n={n}: kernel and gather differ",
                  file=sys.stderr)
            return 1
        # drop the split tables before the next n
        for key in [k for k in lattice._DEVICE_TABLES if k[0] == "direct"
                    and k[1] == n and k[2] > 4]:
            del lattice._DEVICE_TABLES[key]
        lattice.direct_layer_indices.cache_clear()
        del dp_k, dp_g
        torch.cuda.empty_cache()

    n = max(args.ns)
    B = args.fit_batch
    cards = np.stack([make_cardinalities(clique(n), seed=args.seed + b,
                                         cap=1e8) for b in range(B)])
    engine.clear_executable_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fc = engine.fused_ccap(cards, n, device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc2 = engine.fused_ccap(cards, n, device=dev)
    wall2 = time.perf_counter() - t0
    emit({"n": n, "fit_batch": B, "first_call_s": wall,
          "second_call_s": wall2,
          "peak_bytes": torch.cuda.max_memory_allocated() - base,
          "finite": bool(np.isfinite(fc.couts).all()),
          "repeat_equal": bool(np.array_equal(fc.couts, fc2.couts)),
          "maxrss_bytes": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss * 1024})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    sys.exit(main())
