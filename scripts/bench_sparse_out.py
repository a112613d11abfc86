"""Connected C_out at n = 14..19 on the card: the connected-subset masks
and the fused out program, per topology and n, against the host paths
they replace.

    python3 scripts/bench_sparse_out.py --tag NAME [--host-max-n N]

For chain, star, cycle and a JOB-like sparse graph (a random spanning
tree plus n // 2 other edges) at each n it measures:

* ``mask_host_ms``: ``QueryGraph.connected_mask`` (numpy) on the host;
* ``mask_ms``: the ``connmask`` kernel's device time (CUDA events around
  50 launches), its bytes' bound, and whether its masks are bitwise the
  host's;
* ``out_ms``: one warm ``engine.fused_out`` call (its CUDA graph
  replayed) from the entry point to the host trees, median of 5, with
  the dispatch record's ``sweep_pairs``, execute and host split;
* ``dpccp_ms`` (n <= ``--host-max-n``): ``dpccp_with_tree``, the host
  enumerator the router used past n = 13, and whether its optimum, DP
  table and tree are bitwise the card's.

Results go to ``chiprun_out/<NAME>.json``; the card's name and power
limit are printed beside them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--host-max-n", type=int, default=16)
    ap.add_argument("--ns", type=int, nargs="+", default=list(range(14, 20)))
    a = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.core import engine
    from repro_torch.core import querygraph as qg
    from repro_torch.core.dpccp import dpccp_with_tree
    from repro_torch.kernels.connmask import connmask_cuda

    dev = torch.device("cuda", 0)
    name = card()
    print(f"card: {name}", flush=True)
    makers = {"chain": qg.chain, "star": qg.star, "cycle": qg.cycle,
              "sparse": lambda n: qg.random_sparse(n, extra_edges=n // 2,
                                                   seed=n)}
    rows = []
    for n in a.ns:
        for topo, make in makers.items():
            q = make(n)
            c = qg.make_cardinalities(q, seed=100 + n, base_range=(1e2, 1e6),
                                      selectivity_range=(1e-4, 1.0),
                                      cap=1e8)
            t0 = time.perf_counter()
            want = q.connected_mask()
            mask_host = 1e3 * (time.perf_counter() - t0)
            adj = torch.as_tensor(q.adjacency()[None, :], dtype=torch.int32,
                                  device=dev)
            got = connmask_cuda(adj, n)
            same_mask = got[0].cpu().numpy().tobytes() == want.tobytes()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            e0.record()
            for _ in range(50):
                connmask_cuda(adj, n)
            e1.record()
            torch.cuda.synchronize()
            mask_ms = e0.elapsed_time(e1) / 50
            walls, recs = [], []
            for i in range(8):
                mark = engine.dispatch_mark()
                t0 = time.perf_counter()
                fo = engine.fused_out([q], c[None, :], n, device=dev)
                walls.append(1e3 * (time.perf_counter() - t0))
                recs.extend(engine.dispatches_since(mark))
            rec = recs[-1]
            row = {"n": n, "topology": topo, "edges": len(q.edges),
                   "mask_host_ms": mask_host, "mask_ms": mask_ms,
                   "mask_bound_ms": 1e3 * ((1 << n) + 4 * n)
                   / HBM_BYTES_PER_S,
                   "mask_bitwise": same_mask,
                   "out_ms": statistics.median(walls[3:]),
                   "out_ms_first": walls[0],
                   "graphed": rec.graphed, "sweep_pairs": rec.sweep_pairs,
                   "sweep_sets": rec.sweep_sets,
                   "execute_ms": 1e3 * rec.execute_s,
                   "host_ms": 1e3 * (rec.prepare_s + rec.readback_s
                                     + rec.trees_s)}
            if n <= a.host_max_n:
                t0 = time.perf_counter()
                dp, tree = dpccp_with_tree(q, c, mode="out")
                row["dpccp_ms"] = 1e3 * (time.perf_counter() - t0)
                row["dpccp_bitwise"] = (
                    fo.couts[0].hex() == float(dp[-1]).hex()
                    and fo.dp[0].tobytes() == np.asarray(dp).tobytes()
                    and str(fo.trees[0]) == str(tree))
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{a.tag}.json").write_text(json.dumps(
        {"card": name, "rows": rows}, indent=1))
    bad = [r for r in rows if not r["mask_bitwise"]
           or not r.get("dpccp_bitwise", True)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
