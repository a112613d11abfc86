"""The plain reference of exact join ordering, for large queries with no
cross products: ``joinorder.py``'s textbook DPsub, with the connected
sets of each query found by torch operations on the solve's device
(``connected_sets``) in place of its numpy pass over the 2^n sets, which
takes over a second a query at n = 19.

It imports torch and numpy only, nothing of the program.  The DP, the
plan extraction, the tree cost and ``judge`` are ``joinorder.py``'s own
functions, loaded from the file beside this one, so both cells are
judged by one DP; only ``connected_sets``, ``excludes_cross_products``
and ``solve``'s ``out`` branch, which use it, are defined here.
``solve(..., dtype=torch.float32)`` is the control: the same DP one
precision below the configuration's.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch


def _joinorder():
    """``joinorder.py`` beside this file, under the name the harness
    loads it by (one module, whichever loads it first)."""
    path = Path(__file__).resolve().parent / "joinorder.py"
    key = "planbench_references_joinorder"
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


_jo = _joinorder()
popcounts = _jo.popcounts
dp_table = _jo.dp_table
extract_tree = _jo.extract_tree
tree_cost = _jo.tree_cost
judge = _jo.judge


def connected_sets(n: int, edge_lists, device="cpu") -> torch.Tensor:
    """(Q, 2^n) bool on ``device``, one row a query of ``edge_lists``:
    the set induces a connected subgraph of that query (the empty set
    does not).  The fixpoint reach = (reach | neighbours(reach)) & S from
    each set's lowest relation, until no row changes."""
    Q = len(edge_lists)
    adj = torch.zeros((Q, n), dtype=torch.int64, device=device)
    for i, edges in enumerate(edge_lists):
        for u, v in edges:
            adj[i, u] |= 1 << v
            adj[i, v] |= 1 << u
    S = torch.arange(1 << n, dtype=torch.int64, device=device)
    reach = (S & -S).expand(Q, -1).clone()
    for _ in range(n):
        grow = torch.zeros_like(reach)
        for j in range(n):
            grow |= torch.where(((reach >> j) & 1).bool(), adj[:, j:j + 1],
                                0)
        new = reach | (grow & S)
        if torch.equal(new, reach):
            break
        reach = new
    out = reach == S
    out[:, 0] = False
    return out


def excludes_cross_products(cost: str, n: int, edges, semantics: dict,
                            connected: "bool | None" = None) -> bool:
    """Whether ``out`` plans of this query must avoid cross products
    (``connected``: whether the query is connected, if already known)."""
    if cost != "out":
        return False
    dens = 2.0 * len(edges) / (n * (n - 1)) if n > 1 else 1.0
    if dens > float(semantics["out_connected_max_density"]):
        return False
    if connected is None:
        connected = bool(connected_sets(n, [edges])[0, -1])
    return bool(connected)


def solve(queries: list, cost: str, semantics: dict, device="cpu",
          dtype=torch.float64) -> list:
    """Reference solves of same-``n`` queries ``[(n, edges, card)]`` under
    ``cost``, as ``joinorder.solve`` gives them; ``out`` finds the
    connected sets of all the queries in one ``connected_sets`` call."""
    if cost != "out":
        return _jo.solve(queries, cost, semantics, device, dtype)
    n = queries[0][0]
    cards = torch.as_tensor(np.stack([q[2] for q in queries]),
                            device=device).to(dtype)
    pc = torch.as_tensor(popcounts(n), device=device)
    conn = connected_sets(n, [q[1] for q in queries], device)
    rows = []
    for i, q in enumerate(queries):
        if excludes_cross_products("out", q[0], q[1], semantics,
                                   connected=bool(conn[i, -1])):
            rows.append(conn[i] | (pc == 1))
        else:
            rows.append(torch.ones(1 << n, dtype=torch.bool, device=device))
    allowed = torch.stack(rows)
    dp_h = dp_table(cards, n, "out", excluded=~allowed).cpu().numpy()
    cards_h = cards.cpu().numpy()
    al = allowed.cpu().numpy()
    return [{"opt": float(dp_h[i, -1]), "dp": dp_h[i], "card": cards_h[i],
             "allowed": al[i], "mode": "out"} for i in range(len(queries))]
