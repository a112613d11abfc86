"""Query graphs and cardinalities of the benchmark's own (numpy only).

A frozen copy of the input makers that the plan service's generator uses
(chain, star, cycle, grid, clique and JOB-like random sparse graphs over
``n`` relations, the selectivity model of the DPconv paper's Sec. 9), so
that a change to the program cannot change the inputs.  A graph is plain
data: ``(n, edges)`` with ``edges`` a sorted tuple of ``(u, v)``, u < v.

Cardinalities follow the selectivity model

    c(S) = prod_{i in S} base_i * prod_{(u, v) in E, u, v in S} sel_uv,

clipped to ``[1, cap]``, with ``c({}) = 1``.  Every selectivity is at most
1, so ``c(S) <= c(S1) c(S2)`` for every split.  ``cardinalities`` builds
``log c`` by a recurrence on the highest relation of each set (about
2^(n+1) additions, a few milliseconds at n = 19), not by a membership
matrix, so a stream of hundreds of large queries is made in set-up time
that stays short.
"""
from __future__ import annotations

import numpy as np

TOPOLOGIES = ("chain", "star", "cycle", "grid", "clique", "sparse")

# the generator's grid shapes (rows, cols), smallest first
GRIDS = ((2, 3), (2, 4), (3, 3), (2, 5), (3, 4), (2, 6), (3, 5), (2, 7),
         (4, 4), (3, 6))


def chain(n: int) -> tuple:
    return tuple((i, i + 1) for i in range(n - 1))


def star(n: int) -> tuple:
    return tuple((0, i) for i in range(1, n))


def cycle(n: int) -> tuple:
    return tuple(sorted(chain(n) + ((0, n - 1),)))


def clique(n: int) -> tuple:
    return tuple((u, v) for u in range(n) for v in range(u + 1, n))


def grid(rows: int, cols: int) -> tuple:
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                edges.append((i, i + 1))
            if r + 1 < rows:
                edges.append((i, i + cols))
    return tuple(sorted(edges))


def random_sparse(n: int, extra_edges: int,
                  rng: np.random.Generator) -> tuple:
    """JOB-like sparse graph: a random spanning tree plus ``extra_edges``
    other edges."""
    perm = rng.permutation(n)
    edges = set()
    for i in range(1, n):
        u = int(perm[rng.integers(0, i)])
        v = int(perm[i])
        edges.add((min(u, v), max(u, v)))
    rest = [(u, v) for u in range(n) for v in range(u + 1, n)
            if (u, v) not in edges]
    order = rng.permutation(len(rest))
    for j in order[:extra_edges]:
        edges.add(rest[int(j)])
    return tuple(sorted(edges))


def grid_shapes(lo: int, hi: int) -> list:
    """The grid shapes whose relation count lies in ``[lo, hi]``."""
    return [g for g in GRIDS if lo <= g[0] * g[1] <= hi]


def make_edges(topology: str, n: int, rng: np.random.Generator) -> tuple:
    """The edges of one graph of ``topology`` over ``n`` relations (for a
    grid, ``n`` must be a grid's size: see ``grid_shapes``)."""
    if topology == "chain":
        return chain(n)
    if topology == "star":
        return star(n)
    if topology == "cycle":
        return cycle(n)
    if topology == "clique":
        return clique(n)
    if topology == "grid":
        for r, c in GRIDS:
            if r * c == n:
                return grid(r, c)
        raise ValueError(f"no grid of {n} relations")
    if topology == "sparse":
        return random_sparse(n, int(rng.integers(0, n)), rng)
    raise ValueError(f"unknown topology {topology!r}")


def density(n: int, edges) -> float:
    return 2.0 * len(edges) / (n * (n - 1)) if n > 1 else 1.0


def cardinalities(n: int, edges, rng: np.random.Generator,
                  base_range=(1e2, 1e6), selectivity_range=(1e-4, 1.0),
                  cap: float = 1e8) -> np.ndarray:
    """Dense (2^n,) float64 cardinality table under the selectivity model
    (module docstring), drawn from ``rng``: log-uniform base sizes, then
    log-uniform selectivities in edge order."""
    log_base = rng.uniform(np.log(base_range[0]), np.log(base_range[1]), n)
    log_sel = rng.uniform(np.log(selectivity_range[0]),
                          np.log(selectivity_range[1]), len(edges))
    w = np.zeros((n, n))                 # w[h, u]: log sel of edge (u, h)
    for (u, v), ls in zip(edges, log_sel):
        w[v, u] = ls
    logc = np.zeros(1 << n)
    for h in range(n):
        # sets whose highest relation is h: T | 1 << h for T < 2^h, with
        # log c = log c(T) + base_h + the selectivities of h's edges in T
        inner = np.zeros(1 << h)
        for u in range(h):
            inner[1 << u:2 << u] = inner[:1 << u] + w[h, u]
        logc[1 << h:2 << h] = logc[:1 << h] + log_base[h] + inner
    card = np.exp(np.clip(logc, 0.0, np.log(cap)))
    card[0] = 1.0
    return card
