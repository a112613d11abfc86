"""Data-pipeline join planning with DPconv (counterpart of
``repro.planner.datajoin``).

Realistic framework scenario: assembling a training mixture joins several
metadata tables (example -> document -> source -> license -> quality
score -> dedup cluster ...).  On a preprocessing cluster the join order
determines peak worker memory (C_max) and total shuffle traffic (C_out).
The pipeline calls DPconv to plan these joins; C_cap gives the least
traffic among peak-memory-optimal plans.

Tables are modelled by row counts + per-join-key selectivities (the same
cardinality model as ``repro_torch.core.querygraph``); ``plan_joins``
solves on the device ``optimize`` is given, and ``execute`` runs the
joins on numpy record arrays on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.querygraph import QueryGraph
from repro_torch.core.dpconv import optimize
from repro_torch.core.jointree import JoinTree


@dataclasses.dataclass(frozen=True)
class Table:
    name: str
    key_cols: tuple            # column names usable as join keys
    n_rows: int


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    left: int                  # table index
    right: int
    col: str
    selectivity: float         # |L join R| / (|L| * |R|)


def build_graph(tables: list, joins: list) -> tuple:
    """-> (QueryGraph, card table) for the pipeline's join problem.

    The log contributions of each subset are summed with ``math.fsum``,
    which is exactly rounded and therefore order-invariant, so the table
    is *label-order invariant*: registering the same pipeline with tables
    in a different order yields a byte-exact permutation of the same
    cardinalities — which is what lets the plan server's
    isomorphism-invariant cache key (``service.canon``) recognize it as
    the same query.
    """
    n = len(tables)
    edges = tuple(sorted({(min(j.left, j.right), max(j.left, j.right))
                          for j in joins}))
    q = QueryGraph(n, edges)
    size = 1 << n
    card = np.ones(size, np.float64)
    logs = np.log([max(t.n_rows, 1) for t in tables])
    for mask in range(1, size):
        contrib = [float(logs[i]) for i in range(n) if (mask >> i) & 1]
        contrib += [float(np.log(max(j.selectivity, 1e-300)))
                    for j in joins
                    if (mask >> j.left) & 1 and (mask >> j.right) & 1]
        lv = math.fsum(contrib)
        card[mask] = float(np.exp(max(lv, 0.0)))
    return q, card


def plan_joins(tables: list, joins: list, cost: str = "cap", server=None,
               device=None):
    """Plan the pipeline's joins on ``device`` (CUDA unless given).  With
    ``server`` the request runs through the plan-serving path (cache +
    router + batched solver on the server's device, see
    ``repro_torch.service``); re-planning the same pipeline — or the
    same pipeline with tables listed in a different order — is then a
    cache hit."""
    q, card = build_graph(tables, joins)
    if server is not None:
        return server.plan_one(q, card, cost=cost), card
    return optimize(q, card, cost=cost, device=device), card


def execute(tables_data: list, joins: list, tree: JoinTree) -> np.ndarray:
    """Run the planned join tree on numpy structured arrays (demo/tests).
    Join condition between two sides: all JoinSpec edges crossing them."""
    def run(t: JoinTree):
        if t.is_leaf:
            i = t.mask.bit_length() - 1
            return tables_data[i], {i}
        lhs, lset = run(t.left)
        rhs, rset = run(t.right)
        conds = [j for j in joins
                 if (j.left in lset and j.right in rset)
                 or (j.right in lset and j.left in rset)]
        if not conds:                       # cross product
            li = np.repeat(np.arange(len(lhs)), len(rhs))
            ri = np.tile(np.arange(len(rhs)), len(lhs))
        else:
            j0 = conds[0]
            lk = lhs[j0.col]
            rk = rhs[j0.col]
            order = np.argsort(rk, kind="stable")
            pos_l = np.searchsorted(rk[order], lk, side="left")
            pos_r = np.searchsorted(rk[order], lk, side="right")
            li = np.repeat(np.arange(len(lhs)), pos_r - pos_l)
            ri = order[np.concatenate(
                [np.arange(a, b) for a, b in zip(pos_l, pos_r)])] \
                if len(lhs) else np.zeros(0, np.int64)
            for j in conds[1:]:
                keep = lhs[j.col][li] == rhs[j.col][ri]
                li, ri = li[keep], ri[keep]
        merged = {}
        for name in lhs.dtype.names:
            merged[name] = lhs[name][li]
        for name in rhs.dtype.names:
            if name not in merged:
                merged[name] = rhs[name][ri]
        out = np.empty(len(li), dtype=[(k, merged[k].dtype)
                                       for k in merged])
        for k, v in merged.items():
            out[k] = v
        return out, lset | rset

    res, _ = run(tree)
    return res
