"""What decides ``correct``: every answer compared with the plain
reference.

For every answered request of the window the reference solves the query
it stands for, and three numbers are compared with the configuration's
limits:

* ``cost_gap``   the largest relative distance of a served cost from the
                 reference's optimum;
* ``tree_gap``   the largest relative distance of a served tree's own cost
                 from that optimum (a tree that is not a plan of the query
                 reads infinite);
* ``unanswered`` the requests that got no exact answer: refused, failed,
                 degraded to a best-effort plan, or never answered.

A run is correct when each number is at most its limit.
"""
from __future__ import annotations

import collections
import math

QUERIES_PER_SOLVE = 64       # same-n queries the reference solves at once


def solve_refs(ref_mod, refs: dict, keys, semantics: dict, device,
               dtype=None) -> dict:
    """Reference solves of the named queries: ``{(ref, cost): solution}``."""
    import torch
    dtype = dtype or torch.float64
    groups = collections.defaultdict(list)
    for key in sorted(set(keys)):
        ref, cost = key
        groups[(refs[ref][0], cost)].append(key)
    out = {}
    for (n, cost), ks in sorted(groups.items()):
        for lo in range(0, len(ks), QUERIES_PER_SOLVE):
            part = ks[lo:lo + QUERIES_PER_SOLVE]
            sols = ref_mod.solve([refs[k[0]] for k in part], cost, semantics,
                                 device=device, dtype=dtype)
            out.update(zip(part, sols))
    return out


def compare(ref_mod, outcomes: list, sols: dict, answers=None) -> dict:
    """The three numbers of the module docstring: the gaps over the
    answered ``outcomes``, the unanswered over all of them.  ``answers``
    replaces the served ones (the control): ``{i: (cost, tree)}``."""
    cost_gap = tree_gap = 0.0
    for o in outcomes:
        r = o.req
        if answers is not None:
            cost, tree = answers[r.i]
        elif o.answered:
            cost, tree = o.cost, o.tree
        else:
            continue
        sol = sols[(r.ref, r.cost)]
        cg, tg = ref_mod.judge(cost, tree, sol, r.n)
        cost_gap = max(cost_gap, cg)
        tree_gap = max(tree_gap, tg)
    unanswered = sum(not o.answered for o in outcomes)
    return {"cost_gap": cost_gap, "tree_gap": tree_gap,
            "unanswered": float(unanswered)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number beside its limit."""
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
