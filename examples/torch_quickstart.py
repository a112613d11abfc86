"""Quickstart on the PyTorch port: optimal join ordering with DPconv.

    python3 examples/torch_quickstart.py              # card
    python3 examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``: a 12-relation clique query with
random (submultiplicative) cardinalities — the paper's worst case —
optimized under every supported cost function, printing the optimal
bushy join trees.  Tensor code runs on ``--device`` (CUDA by default);
the numpy baselines (DPsub, the DPccp enumerator) run on the host.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core.dpconv import optimize  # noqa: E402
from repro_torch.core.querygraph import (clique,  # noqa: E402
                                         make_cardinalities, random_sparse)


def main(device: str) -> None:
    n = 12
    q = clique(n)
    card = make_cardinalities(q, seed=42)
    print(f"query: clique of {n} relations, cardinalities in "
          f"[{card.min():.0f}, {card.max():.0f}], device {device}\n")

    for cost, method in [("max", "dpconv"), ("out", "dpsub"),
                         ("cap", "dpconv"), ("smj", "dpsub")]:
        t0 = time.perf_counter()
        res = optimize(q, card, cost=cost, method=method,
                       extract_tree=(cost != "smj"), device=device)
        dt = time.perf_counter() - t0
        print(f"C_{cost:3s} [{method:6s}]  optimum = {res.cost:14,.0f}   "
              f"({dt:.2f}s)")
        if res.tree is not None:
            print(f"   plan: {res.tree}")
            print(f"   peak intermediate = {res.tree.cost_max(card):,.0f}, "
                  f"total = {res.tree.cost_out(card):,.0f}\n")

    # the paper's host loop with the early-exit feasibility probes
    t0 = time.perf_counter()
    res = optimize(q, card, cost="max", early_exit=True, device=device)
    print(f"C_max early exit: optimum {res.cost:,.0f} in "
          f"{res.meta['passes']} passes ({time.perf_counter() - t0:.2f}s)\n")

    # approximate C_out: (1+eps) guarantee, W-independent running time
    exact = optimize(q, card, cost="out", method="dpsub",
                     extract_tree=False, device=device).cost
    for eps in (0.5, 0.1):
        t0 = time.perf_counter()
        res = optimize(q, card, cost="out", method="approx", eps=eps,
                       device=device)
        print(f"C_out approx eps={eps}: {res.cost:,.0f} "
              f"(ratio {res.cost / exact:.4f}, "
              f"{time.perf_counter() - t0:.2f}s)")

    # sparse (JOB-like) graph: DPccp enumerates only connected pairs
    qs = random_sparse(14, 4, seed=1)
    cs = make_cardinalities(qs, seed=1)
    res = optimize(qs, cs, cost="out", method="dpccp", device=device)
    print(f"\nsparse 14-relation query via DPccp: optimum {res.cost:,.0f} "
          f"({res.meta['ccp']} ccp pairs vs 3^14={3**14:,} subset pairs)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    main(ap.parse_args().device)
