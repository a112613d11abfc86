#!/usr/bin/env python3
"""Time the plan path's canonicalization on the host, for any tree of it.

    python3 scripts/bench_canon.py [--src DIR/src] [--label NAME]
        [--ns 12-19] [--topos clique,chain,star] [--reps 5]
        [--out F] [--check F] [--ref]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so an unpacked older commit and this one can be timed in one
process each, in turns.  For each topology and n, on the paper's
cardinalities (``make_cardinalities``, seed = n), it prints the median
over ``--reps`` of:

* ``canon_ms``: one ``service.canon.canonicalize`` (what a plan's
  admission pays before its solve);
* ``probe_ms``: the n + 1 ``subset_signature`` calls of one
  value-fragment probe or harvest (the full set and every
  leave-one-out subset, ``service.layercache``);

and ``digest``, a SHA-256 over every key, permutation and canonical
table those calls returned.  ``--check F`` reads an earlier run's
``--out`` file and fails unless every shared case has the same digest:
two trees give the same bytes.  ``--ref`` holds the keys, permutations
and tables to the JAX reference's (``repro.service.canon``, on the CPU)
byte for byte; the reference is not timed.

Needs no card; without ``--ref`` it imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import platform
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ns(spec: str) -> list:
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def _median_ms(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _masks(n: int) -> list:
    full = (1 << n) - 1
    return [full] + [full ^ (1 << i) for i in range(n)]


def _digest(form, subsets) -> str:
    h = hashlib.sha256()
    h.update(f"{form.key};{form.perm};{form.q.edges}".encode())
    h.update(form.card.tobytes())
    for s in subsets:
        h.update(f"{s.key};{s.rels};{s.perm}".encode())
    return h.hexdigest()


def _check_ref(qg, card, form, subsets) -> None:
    from repro.core.querygraph import QueryGraph as RefQueryGraph
    from repro.service import canon as ref_canon
    rq = RefQueryGraph(qg.n, tuple(qg.edges), tuple(qg.hyperedges))
    want = ref_canon.canonicalize(rq, card)
    if (want.key, want.perm, want.q.edges) != \
            (form.key, form.perm, form.q.edges) \
            or want.card.tobytes() != form.card.tobytes():
        raise SystemExit(f"FAIL: canonical form differs from the "
                         f"reference at n={qg.n}")
    for mask, s in zip(_masks(qg.n), subsets):
        r = ref_canon.subset_signature(rq, card, mask)
        if (r.key, r.rels, r.perm) != (s.key, s.rels, s.perm):
            raise SystemExit(f"FAIL: subset signature of {mask:#x} "
                             f"differs from the reference at n={qg.n}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ns", default="12-19")
    ap.add_argument("--topos", default="clique,chain,star")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="append one JSON line a case")
    ap.add_argument("--check", help="an earlier --out file to hold the "
                                    "digests to")
    ap.add_argument("--ref", action="store_true",
                    help="hold the bytes to the JAX reference's")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core import querygraph
    from repro_torch.service import canon
    if not Path(canon.__file__).resolve().is_relative_to(src):
        print(f"FAIL: imported {canon.__file__}, not from {src}")
        return 1
    stats = getattr(canon, "stats", None)
    earlier = {}
    if args.check:
        for line in Path(args.check).read_text().splitlines():
            row = json.loads(line)
            earlier[(row["topo"], row["n"])] = row["digest"]
    cpu = platform.processor() or platform.machine()
    print(f"# {args.label}: {src}; {cpu}, python "
          f"{platform.python_version()}")
    print(f"{'topo':>7} {'n':>3} {'canon_ms':>10} {'probe_ms':>10}  digest")
    bad = 0
    rows = []
    for topo in args.topos.split(","):
        make = getattr(querygraph, topo)
        for n in _ns(args.ns):
            qg = make(n)
            card = querygraph.make_cardinalities(qg, seed=n)
            masks = _masks(n)
            form = canon.canonicalize(qg, card)
            subsets = [canon.subset_signature(qg, card, m) for m in masks]
            before = stats() if stats else None
            canon_ms = _median_ms(lambda: canon.canonicalize(qg, card),
                                  args.reps)
            probe_ms = _median_ms(
                lambda: [canon.subset_signature(qg, card, m)
                         for m in masks], args.reps)
            row = {"label": args.label, "topo": topo, "n": n,
                   "canon_ms": canon_ms, "probe_ms": probe_ms,
                   "digest": _digest(form, subsets)}
            if stats:
                after = stats()
                row["canon"] = {k: after[k] - before[k] for k in after}
            if args.ref:
                _check_ref(qg, card, form, subsets)
            prev = earlier.get((topo, n))
            if prev is not None and prev != row["digest"]:
                print(f"FAIL: {topo} n={n} digest differs from {args.check}")
                bad += 1
            rows.append(row)
            print(f"{topo:>7} {n:>3} {canon_ms:>10.3f} {probe_ms:>10.3f}  "
                  f"{row['digest'][:16]}")
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
