"""Medians, quartile spreads and correctness of runs kept by
``series.py``.

    python3 planbench/tools/spread.py FILE.jsonl [FILE.jsonl ...]

Each file is one set.  Per cell, traced or not, and per metric it prints
each set's count, median and spread (the quartile distance over the
median, ``statistics.quantiles(values, n=4)``), the spread of the set
without its run farthest from the median, and over all sets the widest
spread and the wider of the two medians' distance; then the runs that
were not correct, and the largest reading of each check.
"""
from __future__ import annotations

import collections
import json
import statistics
import sys


def spread(xs) -> float:
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / med if med else float("nan")


def trimmed(xs) -> list:
    med = statistics.median(xs)
    far = max(range(len(xs)), key=lambda j: abs(xs[j] - med))
    return [x for j, x in enumerate(xs) if j != far]


def main(paths) -> int:
    sets = []
    for p in paths:
        runs = [json.loads(line) for line in open(p) if line.strip()]
        sets.append((p, runs))
    by = collections.defaultdict(lambda: collections.defaultdict(dict))
    bad = []
    checks = collections.defaultdict(float)
    for p, runs in sets:
        for r in runs:
            res = r.get("result")
            key = (r["workload"], r["trace"])
            if res is None or not res.get("correct"):
                bad.append((p, r["workload"], r["seed"], r["rc"],
                            None if res is None else res.get("checks")))
            if res is None:
                continue
            for k, c in res.get("checks", {}).items():
                checks[(r["workload"], k)] = max(checks[(r["workload"], k)],
                                                 c["value"])
            for m, v in res["metrics"].items():
                by[key][m].setdefault(p, []).append(v["value"])
    for key in sorted(by, key=str):
        print(f"== {key[0]} trace={key[1]}")
        for m, per in sorted(by[key].items()):
            cells = []
            spreads = []
            meds = []
            for p, xs in per.items():
                if len(xs) >= 2:
                    s = spread(xs)
                    st = spread(trimmed(xs)) if len(xs) >= 3 else s
                    spreads.append(s)
                    cells.append(f"n={len(xs)} med={statistics.median(xs):.6g}"
                                 f" spread={s:.4f} trim={st:.4f}")
                else:
                    cells.append(f"n=1 v={xs[0]:.6g}")
                meds.append(statistics.median(xs))
            extra = ""
            if len(meds) == 2:
                extra = f" medians_gap={abs(meds[1] - meds[0]) / meds[0]:.4f}"
            widest = max(spreads) if spreads else float("nan")
            print(f"  {m:36s} widest={widest:.4f}{extra} | "
                  + " | ".join(cells))
    print("not correct:", bad if bad else "none")
    for k in sorted(checks):
        print(f"largest {k[0]} {k[1]} = {checks[k]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
