"""Best-effort algorithms from the paper's related work (Sec. 10.3).

* GOO — Greedy Operator Ordering (Fegaras 1998): repeatedly join the pair
  with the smallest result cardinality.  O(n^3)-ish here (paper: with a
  heap, O(n log n)); no optimality guarantee — the gap to the exact
  optimum is exactly the paper's motivation for fast exact algorithms.

* IKKBZ (Ibaraki & Kameda 1984, Krishnamurthy/Boral/Zaniolo 1986) —
  optimal LEFT-DEEP plans for TREE query graphs in polynomial time, for
  ASI cost functions.  We implement the classic C_out-style instantiation
  (cost = sum of intermediate cardinalities under the independence/
  selectivity model).  For every candidate root: build the precedence
  tree, repeatedly normalize wedges by merging child chains in rank order
  (rank ρ = (T−1)/C), concatenate, and take the best root.  Validated
  against a left-deep-restricted exact DP (`dpsub_leftdeep`).

* ``dpsub_leftdeep`` — exact left-deep DP (the relevant oracle): linear
  join trees only, no cross products.

A copy of ``repro.core.best_effort`` (numpy only): the port never imports
``repro``, whose ``core`` package turns on JAX at import.  Keep the two
in step; ``tests/test_torch_costs.py`` holds them equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitset import layer_indices, popcounts
from repro_torch.core.querygraph import QueryGraph
from repro_torch.core.jointree import JoinTree

_INF = float("inf")


# --------------------------------------------------------------------- GOO
def goo(q: QueryGraph, card: np.ndarray,
        allow_cross: bool = True) -> JoinTree:
    """Greedy Operator Ordering: merge the pair with the smallest joint
    cardinality at every step."""
    active = [(1 << i, JoinTree(1 << i)) for i in range(q.n)]
    while len(active) > 1:
        best = None
        for a in range(len(active)):
            for b in range(a + 1, len(active)):
                ma, mb = active[a][0], active[b][0]
                if not allow_cross and not q.can_join(ma, mb):
                    continue
                m = ma | mb
                if best is None or card[m] < best[0]:
                    best = (card[m], a, b)
        if best is None:        # disconnected remainder: allow cross
            best = (card[active[0][0] | active[1][0]], 0, 1)
        _, a, b = best
        node = JoinTree(active[a][0] | active[b][0], active[a][1],
                        active[b][1])
        active = [x for i, x in enumerate(active) if i not in (a, b)]
        active.append((node.mask, node))
    return active[0][1]


# ---------------------------------------------------------- left-deep DP
def dpsub_leftdeep(q: QueryGraph, card: np.ndarray,
                   connected_only: bool = True) -> np.ndarray:
    """Exact left-deep C_out DP: DP[S] = min_{i in S} DP[S\\i] + c(S).

    The oracle for IKKBZ (optimal left-deep on tree graphs)."""
    n = q.n
    size = 1 << n
    pc = popcounts(n)
    conn = q.connected_mask() if connected_only else None
    dp = np.full(size, _INF)
    dp[pc == 1] = 0.0
    for k in range(2, n + 1):
        for s in layer_indices(n)[k]:
            s = int(s)
            if conn is not None and not conn[s]:
                continue
            best = _INF
            m = s
            while m:
                bit = m & -m
                rest = s & ~bit
                if dp[rest] < best and (
                        conn is None or q.can_join(rest, bit)):
                    v = dp[rest]
                    if v < best:
                        best = v
                m &= m - 1
            if np.isfinite(best):
                dp[s] = best + card[s]
    return dp


# ------------------------------------------------------------------ IKKBZ
@dataclasses.dataclass
class _Chain:
    """A sequence of relations with aggregated (T, C) for rank ordering.

    T = product of (base_i * selectivity to its precedence parent);
    C = accumulated C_out-style cost of appending the sequence."""
    rels: list
    T: float
    C: float

    @property
    def rank(self) -> float:
        return (self.T - 1.0) / self.C if self.C > 0 else -_INF

    def concat(self, other: "_Chain") -> "_Chain":
        return _Chain(self.rels + other.rels, self.T * other.T,
                      self.C + self.T * other.C)


def ikkbz(q: QueryGraph, base: np.ndarray, sel: dict,
          card: np.ndarray) -> tuple:
    """Optimal left-deep order for a TREE query graph (ASI C_out cost).

    Returns (order list, left-deep JoinTree).  Raises on cyclic graphs.
    """
    n = q.n
    if len(q.edges) != n - 1 or not q.is_connected(q.full_mask):
        raise ValueError("IKKBZ requires a (connected) tree query graph")
    adj: dict = {i: [] for i in range(n)}
    for u, v in q.edges:
        adj[u].append(v)
        adj[v].append(u)

    def sel_of(u, v):
        return sel[(u, v) if (u, v) in sel else (v, u)]

    def solve_root(root: int) -> tuple:
        parent = {root: None}
        order = [root]
        stack = [root]
        children: dict = {i: [] for i in range(n)}
        while stack:
            u = stack.pop()
            for w in adj[u]:
                if w not in parent:
                    parent[w] = u
                    children[u].append(w)
                    stack.append(w)
                    order.append(w)

        # chain for a single relation under its precedence parent
        def unit(i) -> _Chain:
            t = float(base[i]) * (sel_of(i, parent[i])
                                  if parent[i] is not None else 1.0)
            return _Chain([i], t, t)

        # normalize bottom-up: each node's subtree becomes a sorted list
        # of chains (rank-ascending) that must start with the node itself
        def norm(i) -> list:
            merged: list = []
            for ch in children[i]:
                merged.extend(norm(ch))
            merged.sort(key=lambda c: c.rank)
            head = unit(i)
            out = [head]
            for c in merged:
                # wedge normalization: a chain whose rank is smaller than
                # its predecessor must be merged into it
                while out and c.rank < out[-1].rank:
                    c = out.pop().concat(c)
                out.append(c)
            return out

        chains = norm(root)
        seq: list = []
        for c in chains:
            seq.extend(c.rels)
        # cost of the left-deep plan in the ASI model equals the DP cost
        mask = 1 << seq[0]
        cost = 0.0
        for r in seq[1:]:
            mask |= 1 << r
            cost += card[mask]
        return cost, seq

    best_cost, best_seq = _INF, None
    for root in range(n):
        cost, seq = solve_root(root)
        if cost < best_cost:
            best_cost, best_seq = cost, seq
    tree = JoinTree(1 << best_seq[0])
    for r in best_seq[1:]:
        tree = JoinTree(tree.mask | (1 << r), tree, JoinTree(1 << r))
    return best_seq, tree
