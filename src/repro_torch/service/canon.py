"""Isomorphism-invariant canonicalization of ``(QueryGraph, card)`` — a
copy of ``repro.service.canon`` (numpy only) over the port's own
``core.querygraph`` and ``core.jointree``.  Keys are SHA-256 digests of
the same canonical bytes, so they equal the reference's byte for byte.

The plan cache must recognize that two requests are *the same query up to
relation renaming*: production workloads re-issue the same join templates
with tables bound in different orders, and a cache keyed on the raw
``(edges, card)`` bytes would miss all of them.

``canonicalize`` computes a canonical relabeling ``perm`` (request label
``i`` -> canonical label ``perm[i]``) via color refinement:

1. initial vertex colors from (degree, quantized log base cardinality);
2. Weisfeiler-Lehman refinement with edge colors taken from the quantized
   log pair cardinality ``c({u, v})`` — this folds the selectivity model
   into the partition, so random-cardinality instances almost always
   refine to discrete colors in one or two rounds;
3. if ties remain, individualization-refinement: branch on the members of
   the first non-singleton class, recurse, and keep the lexicographically
   smallest canonical byte string.  The branch count is capped
   (``branch_cap``); classes that survive refinement with *equal
   cardinality tables* are automorphic in practice, so every leaf yields
   the same bytes and exploring one suffices.  If the cap ever bites on a
   non-automorphic tie the key degrades to "deterministic but not fully
   canonical" — the cache may miss, it can never wrongly hit, because the
   final key hashes the exact permuted cardinality bytes.

The canonical form carries the *exact* float64 cardinality table permuted
by ``perm`` (values are moved, never recomputed), so the SHA-256 key is
byte-exact: key equality implies the two instances are relabelings of one
another, and a cached canonical-space plan can be replayed by relabeling
its join tree back through the inverse permutation (``relabel_tree``).

Each form permutes its cardinality table once: the search keeps the
winning leaf's relabeled graph and table, and ``canonicalize`` and
``subset_signature`` hash them in place.  With one leaf (every
random-cardinality input) no byte string is built at all; with several,
each leaf builds its bytes for the comparison.  The ``canon`` provider
of a server's ``MetricsRegistry`` reads its counters (``stats()``).

``topology_signature`` additionally buckets the graph into a coarse
topology class (chain/star/cycle/clique/grid-like/tree/sparse/dense) —
the admission router keys its policy and its latency model on it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from repro_torch.core.bitset import lattice_map
from repro_torch.core.jointree import JoinTree
from repro_torch.core.querygraph import (QueryGraph, permute_card, permute_mask,
                                   relabel)
from repro_torch.obs import metrics as obs_metrics

# log-space quantization for refinement colors: coarse enough to absorb
# float noise, fine enough to separate genuinely different cardinalities
_QUANT = 1e6


# canonicalization counters, thread-safe: whole-query forms
# (canonicalize), induced sub-problem forms (subset_signature),
# individualization leaves explored, cardinality tables permuted (one a
# leaf)
_COUNTERS = {f: obs_metrics.Counter("canon." + f)
             for f in ("forms", "subset_forms", "leaves", "table_perms")}


def stats() -> dict:
    """The canonicalization counters (the server's ``canon`` provider)."""
    return {f: c.value for f, c in _COUNTERS.items()}


@dataclasses.dataclass(frozen=True)
class CanonicalForm:
    key: str                # SHA-256 hex digest of the canonical bytes
    perm: tuple             # perm[i] = canonical label of request relation i
    signature: str          # coarse topology-class signature
    q: QueryGraph           # canonical-label query graph
    card: np.ndarray        # canonical-label cardinality table

    @property
    def inverse_perm(self) -> tuple:
        inv = [0] * len(self.perm)
        for i, p in enumerate(self.perm):
            inv[p] = i
        return tuple(inv)


def _qlog(x: float) -> int:
    return int(round(math.log(max(float(x), 1e-300)) * _QUANT))


def _compress(colors: list) -> list:
    """Map arbitrary hashable colors to dense ints, order-preserving."""
    lut = {c: i for i, c in enumerate(sorted(set(colors)))}
    return [lut[c] for c in colors]


def _refine(q: QueryGraph, card: np.ndarray, colors: list) -> list:
    """WL refinement to a fixpoint, edge-colored by pair cardinalities."""
    n = q.n
    nbrs: list = [[] for _ in range(n)]
    for u, v in q.edges:
        w = _qlog(card[(1 << u) | (1 << v)])
        nbrs[u].append((v, w))
        nbrs[v].append((u, w))
    for a, b in q.hyperedges:
        # hyperedge features must be label-invariant: use side sizes and
        # quantized cardinalities, never the raw bitmasks (which change
        # under relabeling and would break key invariance)
        w = _qlog(card[a | b])
        fa = (bin(a).count("1"), _qlog(card[a]))
        fb = (bin(b).count("1"), _qlog(card[b]))
        for i in range(n):
            if (a >> i) & 1:
                nbrs[i].append((-1, (fa, fb, w)))
            if (b >> i) & 1:
                nbrs[i].append((-2, (fb, fa, w)))
    for _ in range(n):
        sigs = [(colors[i],
                 tuple(sorted((colors[j] if j >= 0 else j, w)
                              for j, w in nbrs[i])))
                for i in range(n)]
        new = _compress(sigs)
        if new == colors:
            break
        colors = new
    return colors


def _leaf(q: QueryGraph, card: np.ndarray, perm) -> tuple:
    """``(perm, qc, table, head)`` of one relabeling: the canonical bytes
    are ``head`` followed by ``table``'s float64 bytes."""
    qc = relabel(q, perm)
    table = permute_card(card, q.n, perm)
    _COUNTERS["table_perms"].inc()
    head = f"n={q.n};e={qc.edges};h={qc.hyperedges};".encode()
    return tuple(perm), qc, table, head


def _leaf_bytes(leaf: tuple) -> bytes:
    return leaf[3] + np.ascontiguousarray(leaf[2], np.float64).tobytes()


def _leaf_key(prefix: bytes, leaf: tuple) -> str:
    """SHA-256 of ``prefix`` + the leaf's canonical bytes, with no copy of
    a float64 table."""
    h = hashlib.sha256(prefix + leaf[3])
    h.update(np.ascontiguousarray(leaf[2], np.float64))
    return h.hexdigest()


def _canonical_leaf(q: QueryGraph, card: np.ndarray,
                    branch_cap: int) -> tuple:
    """Refinement + capped individualization: the leaf (``_leaf``) of
    the lexicographically smallest canonical bytes."""
    n = q.n
    deg = [bin(int(a)).count("1") for a in q.adjacency()]
    init = [(deg[i], _qlog(card[1 << i])) for i in range(n)]
    colors = _refine(q, card, _compress(init))

    best: list = [None, None]          # [bytes (from the 2nd leaf), leaf]
    leaves = [0]

    def finish(colors: list):
        order = sorted(range(n), key=lambda i: colors[i])
        perm = [0] * n
        for rank, i in enumerate(order):
            perm[i] = rank
        leaf = _leaf(q, card, perm)
        if best[1] is None:
            best[1] = leaf
            return
        if best[0] is None:
            best[0] = _leaf_bytes(best[1])
        byt = _leaf_bytes(leaf)
        if byt < best[0]:
            best[0], best[1] = byt, leaf

    def rec(colors: list):
        if leaves[0] >= branch_cap and best[1] is not None:
            return
        if len(set(colors)) == n:
            leaves[0] += 1
            _COUNTERS["leaves"].inc()
            finish(colors)
            return
        # first non-singleton class (smallest color value)
        counts: dict = {}
        for c in colors:
            counts[c] = counts.get(c, 0) + 1
        target = min(c for c, k in counts.items() if k > 1)
        members = [i for i in range(n) if colors[i] == target]
        for v in members:
            if leaves[0] >= branch_cap and best[1] is not None:
                return
            forked = [c * 2 for c in colors]
            forked[v] -= 1                     # v precedes its old class
            rec(_refine(q, card, _compress(forked)))

    rec(colors)
    return best[1]


def canonical_perm(q: QueryGraph, card: np.ndarray,
                   branch_cap: int = 64) -> tuple:
    """Canonical relabeling via refinement + capped individualization."""
    return _canonical_leaf(q, card, branch_cap)[0]


def topology_signature(q: QueryGraph) -> str:
    """Coarse topology class — the router's policy/latency-model key."""
    n, m = q.n, len(q.edges)
    degs = sorted(bin(int(a)).count("1") for a in q.adjacency())
    connected = q.is_connected(q.full_mask) if n else False
    if q.hyperedges:
        cls = "hyper"
    elif n >= 2 and m == n * (n - 1) // 2:
        cls = "clique"
    elif m == n - 1 and connected and degs[-1] == max(n - 1, 1) and n > 2:
        cls = "star"
    elif m == n - 1 and connected and degs[-1] <= 2:
        cls = "chain"
    elif m == n and all(d == 2 for d in degs):
        cls = "cycle"
    elif m == n - 1 and connected:
        cls = "tree"
    else:
        density = 2.0 * m / (n * (n - 1)) if n > 1 else 0.0
        cls = "sparse" if density <= 0.5 else "dense"
    return f"n={n}|m={m}|{cls}"


def canonicalize(q: QueryGraph, card: np.ndarray,
                 branch_cap: int = 64) -> CanonicalForm:
    leaf = _canonical_leaf(q, card, branch_cap)
    _COUNTERS["forms"].inc()
    perm, qc, cc, _ = leaf
    return CanonicalForm(
        key=_leaf_key(b"", leaf),
        perm=perm,
        signature=topology_signature(q),
        q=qc,
        card=cc,
    )


# ----------------------------------------------------- subset signatures
@dataclasses.dataclass(frozen=True)
class SubsetForm:
    """Canonical form of the sub-problem a relation subset induces.

    The layer-granular fragment cache (``service.layercache``) keys DP
    sub-tables on ``key``: two subsets of two *different* queries share a
    key exactly when their induced sub-problems — relations, edges,
    hyperedges fully inside the subset, and the cardinality table
    restricted to the subset's power set — are relabelings of one
    another.  ``dp[S]`` for ``S`` inside the subset is a pure function of
    that induced sub-problem, so a byte-exact key match means the cached
    fragment values transfer bitwise.

    ``rels`` lists the member relations in the *outer* labeling (bit
    order); ``perm`` maps compact position ``i`` (the rank of
    ``rels[i]``) to its canonical fragment label, exactly like
    ``CanonicalForm.perm`` does for whole queries.
    """
    key: str                # SHA-256 of the induced sub-problem's bytes
    rels: tuple             # outer relation indices, ascending
    perm: tuple             # compact position i -> canonical fragment label

    @property
    def r(self) -> int:
        return len(self.rels)


def induced_subproblem(q: QueryGraph, card: np.ndarray,
                       mask: int) -> "tuple[QueryGraph, np.ndarray, tuple]":
    """Restrict ``(q, card)`` to the relations in ``mask``.

    Returns ``(q_sub, card_sub, rels)``: the compactly-relabeled induced
    graph (edges with both endpoints inside, hyperedges with both sides
    inside), the ``(2^r,)`` slice of ``card`` over subsets of ``mask``
    re-indexed by compact labels, and the member relations in bit order.
    ``card_sub`` copies values — never recomputes them — so fragment
    equality stays byte-exact.
    """
    mask = int(mask)
    rels = tuple(i for i in range(q.n) if (mask >> i) & 1)
    r = len(rels)
    pos = {rel: i for i, rel in enumerate(rels)}
    edges = tuple(sorted((pos[u], pos[v]) for u, v in q.edges
                         if (mask >> u) & 1 and (mask >> v) & 1))

    def compress(m: int) -> int:
        out = 0
        for rel, i in pos.items():
            if (m >> rel) & 1:
                out |= 1 << i
        return out

    hyper = tuple(sorted((compress(a), compress(b))
                         for a, b in q.hyperedges
                         if (a | b) & mask == (a | b)))
    q_sub = QueryGraph(r, edges, hyper)
    card_sub = np.asarray(card, np.float64)[subset_expand(rels)]
    return q_sub, card_sub, rels


def subset_expand(rels: tuple) -> np.ndarray:
    """(2^r,) int64 map: compact subset index -> outer lattice index."""
    return lattice_map([1 << rel for rel in rels])


def subset_signature(q: QueryGraph, card: np.ndarray, mask: int,
                     branch_cap: int = 16) -> SubsetForm:
    """Canonical signature of the sub-problem induced by ``mask``.

    The fragment key namespaces on the subset size ``r`` and hashes the
    canonical bytes of the induced sub-problem, so it can never collide
    with a whole-query plan-cache key (different prefix) and matches
    across queries exactly on relabeled-identical induced sub-problems.
    """
    q_sub, card_sub, rels = induced_subproblem(q, card, mask)
    leaf = _canonical_leaf(q_sub, card_sub, branch_cap)
    _COUNTERS["subset_forms"].inc()
    return SubsetForm(key=_leaf_key(b"frag;", leaf), rels=rels,
                      perm=leaf[0])


def relabel_tree(tree: "JoinTree | None", perm) -> "JoinTree | None":
    """Map a join tree's relation labels through ``perm`` (bit i -> perm[i]).

    With ``CanonicalForm.inverse_perm`` this replays a cached
    canonical-space plan in the request's labeling.
    """
    if tree is None:
        return None
    return JoinTree(permute_mask(tree.mask, perm),
                    relabel_tree(tree.left, perm),
                    relabel_tree(tree.right, perm))
