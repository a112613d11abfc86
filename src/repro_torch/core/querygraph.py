"""Query graphs and the cardinality model used by the paper's evaluation.

A query graph ``Q = (V, E)`` has ``n`` relations (bit positions ``0..n-1``)
and join edges between pairs of relations.  Non-inner joins are modelled as
binary join *hyperedges* ``h = (A, B)`` connecting two sets of relations
(Moerkotte & Neumann 2008), see paper Sec. 3.1.

Cardinalities follow the classic selectivity model, which automatically
satisfies the paper's evaluation constraint (Sec. 9)

    c(S) <= c(S1) * c(S2)   for every disjoint split S = S1 ∪ S2,

because every crossing-edge selectivity is <= 1:

    c(S) = prod_{i in S} base_i * prod_{e subset of S} sigma_e.

A copy of ``repro.core.querygraph`` (numpy only): the port never imports
``repro``, whose ``core`` package turns on JAX at import.  Keep the two
in step; ``tests/test_torch_*.py`` hold them equal.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.bitset import lattice_map


@dataclasses.dataclass(frozen=True)
class QueryGraph:
    """Immutable query (hyper)graph over ``n`` relations."""

    n: int
    edges: tuple  # tuple of (u, v) int pairs, u < v
    hyperedges: tuple = ()  # tuple of (A_mask, B_mask) int pairs

    # ---------------------------------------------------------------- masks
    @property
    def full_mask(self) -> int:
        return (1 << self.n) - 1

    def edge_masks(self) -> np.ndarray:
        """(n_edges,) int64 array; each entry has the two endpoint bits set."""
        if not self.edges:
            return np.zeros(0, dtype=np.int64)
        return np.array([(1 << u) | (1 << v) for u, v in self.edges],
                        dtype=np.int64)

    def adjacency(self) -> np.ndarray:
        """adj[i] = bitmask of neighbours of relation i (simple edges only)."""
        adj = np.zeros(self.n, dtype=np.int64)
        for u, v in self.edges:
            adj[u] |= 1 << v
            adj[v] |= 1 << u
        return adj

    # --------------------------------------------------------- connectivity
    def neighbors_of_set(self, mask: int) -> int:
        """Union of neighbours of all relations in ``mask`` (excl. mask)."""
        adj = self.adjacency()
        out = 0
        m = int(mask)
        j = 0
        while m:
            if m & 1:
                out |= int(adj[j])
            m >>= 1
            j += 1
        # hyperedges: if A ⊆ mask, B's relations become reachable, and v.v.
        for a, b in self.hyperedges:
            if (a & mask) == a:
                out |= b
            if (b & mask) == b:
                out |= a
        return out & ~int(mask)

    def is_connected(self, mask: int) -> bool:
        mask = int(mask)
        if mask == 0:
            return False
        lowest = mask & -mask
        reach = lowest
        while True:
            grow = (self.neighbors_of_set(reach) & mask)
            if grow == 0:
                break
            reach |= grow
        return reach == mask

    def connected_mask(self) -> np.ndarray:
        """Boolean (2^n,) array: connected_mask()[S] == S induces a connected
        subgraph.  Vectorized fixpoint BFS over the whole lattice."""
        n = self.n
        size = 1 << n
        S = np.arange(size, dtype=np.int64)
        adj = self.adjacency()
        # frontier = lowest set bit of S
        reach = S & -S
        for _ in range(n):
            grow = np.zeros(size, dtype=np.int64)
            for j in range(n):
                hasj = ((reach >> j) & 1).astype(bool)
                grow[hasj] |= adj[j]
            for a, b in self.hyperedges:
                asub = (reach & a) == a
                bsub = (reach & b) == b
                grow[asub] |= b
                grow[bsub] |= a
            new = reach | (grow & S)
            if np.array_equal(new, reach):
                break
            reach = new
        out = reach == S
        out[0] = False
        return out

    def can_join(self, s1: int, s2: int) -> bool:
        """True iff there is a (hyper)edge connecting disjoint sets s1, s2."""
        if s1 & s2:
            return False
        for u, v in self.edges:
            if ((s1 >> u) & 1 and (s2 >> v) & 1) or \
               ((s2 >> u) & 1 and (s1 >> v) & 1):
                return True
        for a, b in self.hyperedges:
            if ((a & s1) == a and (b & s2) == b) or \
               ((a & s2) == a and (b & s1) == b):
                return True
        return False


# ------------------------------------------------------------- constructors
def clique(n: int) -> QueryGraph:
    return QueryGraph(n, tuple((u, v) for u in range(n)
                               for v in range(u + 1, n)))


def chain(n: int) -> QueryGraph:
    return QueryGraph(n, tuple((i, i + 1) for i in range(n - 1)))


def star(n: int) -> QueryGraph:
    return QueryGraph(n, tuple((0, i) for i in range(1, n)))


def cycle(n: int) -> QueryGraph:
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    return QueryGraph(n, tuple(sorted(tuple(sorted(e)) for e in edges)))


def grid(rows: int, cols: int) -> QueryGraph:
    """rows × cols grid graph; relation index of cell (r, c) is r*cols+c.
    Cyclic/clustered OLAP-style topology between chain and clique."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                edges.append((i, i + 1))
            if r + 1 < rows:
                edges.append((i, i + cols))
    return QueryGraph(rows * cols, tuple(sorted(edges)))


def random_sparse(n: int, extra_edges: int, seed: int = 0) -> QueryGraph:
    """JOB-like sparse graph: a random spanning tree plus ``extra_edges``."""
    rng = np.random.default_rng(seed)
    edges = set()
    perm = rng.permutation(n)
    for i in range(1, n):
        u = int(perm[rng.integers(0, i)])
        v = int(perm[i])
        edges.add((min(u, v), max(u, v)))
    all_pairs = [(u, v) for u in range(n) for v in range(u + 1, n)
                 if (u, v) not in edges]
    rng.shuffle(all_pairs)
    for e in all_pairs[:extra_edges]:
        edges.add(e)
    return QueryGraph(n, tuple(sorted(edges)))


# -------------------------------------------------------------- relabeling
def permute_mask(mask: int, perm: Sequence[int]) -> int:
    """Apply a relation relabeling to a bitmask: bit i moves to perm[i]."""
    out = 0
    m = int(mask)
    i = 0
    while m:
        if m & 1:
            out |= 1 << perm[i]
        m >>= 1
        i += 1
    return out


def relabel(q: QueryGraph, perm: Sequence[int]) -> QueryGraph:
    """The isomorphic query graph with relation i renamed to perm[i]."""
    edges = tuple(sorted(tuple(sorted((perm[u], perm[v])))
                         for u, v in q.edges))
    hyper = tuple(sorted((permute_mask(a, perm), permute_mask(b, perm))
                         for a, b in q.hyperedges))
    return QueryGraph(q.n, edges, hyper)


def permute_card(card: np.ndarray, n: int, perm: Sequence[int]) -> np.ndarray:
    """Cardinality table of the relabeled query: out[perm(S)] = card[S].

    Pure gather — values are moved, never recomputed, so two tables that
    differ only by a relabeling stay byte-identical after canonicalization
    (this is what makes the plan-cache key exact).  Gathered through the
    inverse relabeling's lattice map: ``out[T] = card[perm^-1(T)]``.
    """
    inv = [0] * n
    for i in range(n):
        inv[int(perm[i])] = i
    return np.asarray(card)[lattice_map([1 << j for j in inv])]


# ------------------------------------------------------------ cardinalities
def make_cardinalities(
    q: QueryGraph,
    seed: int = 0,
    base_range: tuple = (1e2, 1e6),
    selectivity_range: tuple = (1e-4, 1.0),
    cap: float = 1e8,
    return_model: bool = False,
):
    """Dense (2^n,) float64 cardinality function over the subset lattice.

    Uses the selectivity model, guaranteeing submultiplicativity
    ``c(S) <= c(S1) c(S2)`` (see module docstring).  Values are clipped to
    [1, cap]; clipping preserves submultiplicativity for values >= 1.
    Values stay un-rounded floats: rounding to integers can break strict
    submultiplicativity at the margin, and no algorithm here needs
    integrality (the exact C_out embedding uses its own small-integer
    instances in tests).

    Missing edges carry selectivity 1, i.e. the returned function also prices
    cross-products — exactly what DPconv needs to optimize with cross-products
    "out of the box" (paper Sec. 3.1).
    """
    n = q.n
    size = 1 << n
    rng = np.random.default_rng(seed)
    log_base = rng.uniform(np.log(base_range[0]), np.log(base_range[1]), n)
    emasks = q.edge_masks()
    log_sel = rng.uniform(np.log(selectivity_range[0]),
                          np.log(selectivity_range[1]), len(emasks))

    S = np.arange(size, dtype=np.int64)
    logc = np.zeros(size, dtype=np.float64)
    for j in range(n):
        logc += ((S >> j) & 1) * log_base[j]
    # chunk the (2^n, n_edges) membership test to bound memory
    chunk = max(1, (1 << 22) // max(1, len(emasks)))
    for lo in range(0, size, chunk):
        hi = min(size, lo + chunk)
        inside = (S[lo:hi, None] & emasks[None, :]) == emasks[None, :]
        logc[lo:hi] += inside @ log_sel
    card = np.exp(np.clip(logc, 0.0, np.log(cap)))
    card[0] = 1.0
    if return_model:
        base = np.exp(log_base)
        sel = {tuple(e): float(np.exp(ls))
               for e, ls in zip(q.edges, log_sel)}
        return card, base, sel
    return card


def paper_clique_instance(n: int, seed: int = 0) -> tuple:
    """Clique query + random cardinalities <= 100M, as in paper Sec. 9."""
    q = clique(n)
    return q, make_cardinalities(q, seed=seed, cap=1e8)
