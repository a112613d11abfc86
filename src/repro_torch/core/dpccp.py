"""DPccp — Moerkotte & Neumann (2006): DP over connected-subgraph /
connected-complement pairs (ccp), reaching the Ono–Lohman lower bound.

For sparse query graphs (chains, JOB-like) #ccp << 3^n and DPccp wins; for
cliques it degenerates to DPsub's enumeration (paper Sec. 9).  We use it as
the sparse-graph baseline (Fig. 5 analogue) and as an independent oracle:
on connected graphs *without* cross products its optimum must match the
connected-restricted DPsub.

Pure-Python bitset enumeration, faithful to the published pseudocode
(EnumerateCsg / EnumerateCsgRec / EnumerateCmp).

A copy of ``repro.core.dpccp`` (numpy only): the port never imports
``repro``, whose ``core`` package turns on JAX at import.  Keep the two
in step; ``tests/test_torch_costs.py`` holds them equal.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitset import popcount_int
from repro_torch.core.querygraph import QueryGraph
from repro_torch.core import jointree

_INF = float("inf")


def _neighbors(q: QueryGraph, adj: np.ndarray, s: int, forbidden: int) -> int:
    out = 0
    m = s
    j = 0
    while m:
        if m & 1:
            out |= int(adj[j])
        m >>= 1
        j += 1
    return out & ~s & ~forbidden


def _subsets_desc(mask: int):
    """Non-empty submasks of mask."""
    s = mask
    while s:
        yield s
        s = (s - 1) & mask


def enumerate_csg_cmp_pairs(q: QueryGraph):
    """Yield all ccp pairs (S1, S2) in a valid DP order."""
    n = q.n
    adj = q.adjacency()
    pairs = []

    def enum_csg_rec(s: int, x: int, emit):
        nbr = _neighbors(q, adj, s, x)
        if not nbr:
            return
        for sp in _subsets_desc(nbr):
            emit(s | sp)
        for sp in _subsets_desc(nbr):
            enum_csg_rec(s | sp, x | nbr, emit)

    csgs = []
    for i in range(n - 1, -1, -1):
        b_i = (1 << (i + 1)) - 1
        csgs.append(1 << i)
        enum_csg_rec(1 << i, b_i, csgs.append)

    for s1 in csgs:
        min_bit = (s1 & -s1).bit_length() - 1
        b_min = (1 << (min_bit + 1)) - 1
        x = b_min | s1
        nbr = _neighbors(q, adj, s1, x)
        bits = [j for j in range(n) if (nbr >> j) & 1]
        for i in reversed(bits):
            s2 = 1 << i
            pairs.append((s1, s2))
            b_i_n = ((1 << (i + 1)) - 1) & nbr
            enum_csg_rec(s2, x | b_i_n,
                         lambda c, s1=s1: pairs.append((s1, c)))
    # DP-valid order: by total size of the pair
    pairs.sort(key=lambda p: popcount_int(p[0] | p[1]))
    return pairs


def connectivity_masks(q: QueryGraph) -> np.ndarray:
    """The DPccp search space as a dense bitset tensor: the boolean
    (2^n,) connected-subset indicator the fused connected-C_out lattice
    program consumes (``lattice.build_out_program``).

    A split ``(T, S\\T)`` of a connected ``S`` is a csg/cmp pair iff both
    halves are connected — the crossing join edge is implied, since any
    partition of a connected subgraph is crossed by an edge — so this
    single mask *is* the whole search space: the per-layer valid-split
    masks are gathers of it (``conn[subs] & conn[comps]``).

    Restricted to simple-edge graphs, exactly like the csg/cmp
    enumerator above (``_neighbors`` walks the simple-edge adjacency);
    hyperedge queries must stay on the full-lattice pipelines.
    """
    if q.hyperedges:
        raise ValueError("DPccp connectivity masks are simple-edge only; "
                         "hyperedge queries take the full-lattice paths")
    return q.connected_mask()


def ccp_pair_count(conn: np.ndarray, n: int) -> int:
    """#ccp computed from the connected-subset mask alone: unordered
    pairs of disjoint connected sets whose union is connected.  Must
    equal ``len(enumerate_csg_cmp_pairs(q))`` — the property harness's
    oracle check that the mask tensors describe exactly the enumerated
    DPccp search space.
    """
    conn = np.asarray(conn, bool)
    assert conn.shape == (1 << n,)
    total = 0
    for s in np.nonzero(conn)[0]:
        s = int(s)
        if popcount_int(s) < 2:
            continue
        total += sum(1 for t in _subsets_desc(s)
                     if t != s and conn[t] and conn[s & ~t])
    assert total % 2 == 0
    return total // 2


def dpccp(q: QueryGraph, card: np.ndarray, mode: str = "out",
          prune_gamma: float | None = None) -> tuple:
    """Returns (dp_table, n_ccp).  dp over connected sets only; no cross
    products (exactly the DPccp search space)."""
    n = q.n
    size = 1 << n
    dp = np.full(size, _INF)
    for i in range(n):
        dp[1 << i] = 0.0
    cnt = 0
    for s1, s2 in enumerate_csg_cmp_pairs(q):
        cnt += 1
        u = s1 | s2
        if mode == "max":
            val = max(card[u], dp[s1], dp[s2])
        else:
            # (dp[s1] + dp[s2]) first: addition commutes exactly in IEEE,
            # so the result is invariant to which side the enumeration
            # calls s1 — relabeled (isomorphic) instances then produce
            # bit-identical DP values, which the plan-serving cache's
            # exact-parity guarantee relies on.
            val = (dp[s1] + dp[s2]) + card[u]
        if prune_gamma is not None and card[u] > prune_gamma:
            val = _INF
        if val < dp[u]:
            dp[u] = val
    return dp, cnt


def dpccp_with_tree(q: QueryGraph, card: np.ndarray, mode: str = "out"):
    dp, _ = dpccp(q, card, mode=mode)
    if mode == "max":
        tree = jointree.extract_tree_max(dp, card, q.n)
    else:
        tree = jointree.extract_tree_out(dp, card, q.n)
    return dp, tree
