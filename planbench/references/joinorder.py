"""The plain reference of exact join ordering: textbook DPsub in PyTorch.

It imports torch and numpy only, nothing of the program.  Given a query
(``n`` relations, its edges, its (2^n,) cardinality table) and a cost
function it computes the optimal value of every subset,

    max: DP[S] = max(c(S), min_T max(DP[T], DP[S \\ T]))     (C_max)
    out: DP[S] = min_T (DP[T] + DP[S \\ T]) + c(S)           (C_out)
    cap: out over the sets with c(S) <= gamma, gamma = the C_max optimum

with DP of a single relation 0 and T over the proper non-empty subsets
of S that hold its lowest relation.  ``out`` excludes cross products
(every set in a plan connected) where the configuration says so: on a
connected graph whose edge density is at most ``out_connected_max_density``.
Each value is rounded once per operation in the order above, so in
float64 the table does not depend on the order in which splits are
visited: it is the one table every exact DPsub, DPccp or DPconv in
float64 computes, bit for bit.

``judge`` reads a served answer (its cost and its join tree as nested
``(mask, left, right)`` tuples) and measures it against the table: the
relative gap of the served cost to the optimum, and the relative gap of
the served tree's own cost (summed in the DP's order) to the optimum,
infinite for a tree that is not a plan of the query under its
semantics.  ``solve(..., dtype=torch.float32)`` is the control: the same
DP one precision below the configuration's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_ELEMS = 1 << 24        # elements of one gathered (Q, sets, splits) block


def popcounts(n: int) -> np.ndarray:
    S = np.arange(1 << n, dtype=np.int64)
    pc = np.zeros(1 << n, dtype=np.int64)
    for j in range(n):
        pc += (S >> j) & 1
    return pc


def connected_sets(n: int, edges) -> np.ndarray:
    """(2^n,) bool: the set induces a connected subgraph (the empty set
    does not)."""
    adj = np.zeros(n, dtype=np.int64)
    for u, v in edges:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    S = np.arange(1 << n, dtype=np.int64)
    reach = S & -S
    for _ in range(n):
        grow = np.zeros_like(reach)
        for j in range(n):
            grow |= np.where((reach >> j) & 1, adj[j], 0)
        new = reach | (grow & S)
        if np.array_equal(new, reach):
            break
        reach = new
    out = reach == S
    out[0] = False
    return out


def excludes_cross_products(cost: str, n: int, edges, semantics: dict
                            ) -> bool:
    """Whether ``out`` plans of this query must avoid cross products."""
    if cost != "out":
        return False
    dens = 2.0 * len(edges) / (n * (n - 1)) if n > 1 else 1.0
    if dens > float(semantics["out_connected_max_density"]):
        return False
    return bool(connected_sets(n, edges)[-1])


def _splits(sets: torch.Tensor, k: int) -> torch.Tensor:
    """(m, 2^(k-1) - 1) subsets T of each k-set S that hold its lowest
    relation, T != S."""
    n_bits = int(sets.max().item()).bit_length()
    bitvals = ((sets[:, None] >> torch.arange(n_bits, device=sets.device))
               & 1) << torch.arange(n_bits, device=sets.device)
    vals = torch.sort(torch.topk(bitvals, k, dim=1).values, dim=1).values
    idx = torch.arange((1 << (k - 1)) - 1, device=sets.device)
    A = vals[:, :1].expand(-1, idx.numel()).clone()
    for j in range(k - 1):
        A += ((idx >> j) & 1)[None, :] * vals[:, j + 1:j + 2]
    return A


def dp_table(cards: torch.Tensor, n: int, mode: str,
             excluded: "torch.Tensor | None" = None) -> torch.Tensor:
    """The DP value table of a batch of same-``n`` queries, (Q, 2^n), in
    the dtype of ``cards``.  ``mode`` is ``"max"`` or ``"out"``;
    ``excluded`` (Q, 2^n) bool marks the sets no plan may hold (their
    value is infinite)."""
    Q, size = cards.shape
    dev = cards.device
    inf = torch.tensor(float("inf"), dtype=cards.dtype, device=dev)
    dp = torch.full_like(cards, float("inf"))
    pc = torch.as_tensor(popcounts(n), device=dev)
    dp[:, pc == 1] = 0
    for k in range(2, n + 1):
        layer = torch.nonzero(pc == k).flatten()
        per_set = (1 << (k - 1)) - 1
        step = max(1, CHUNK_ELEMS // (per_set * Q))
        for lo in range(0, layer.numel(), step):
            sets = layer[lo:lo + step]
            A = _splits(sets, k)
            B = sets[:, None] ^ A
            a = dp[:, A]
            b = dp[:, B]
            if mode == "max":
                best = torch.maximum(a, b).amin(dim=2)
                val = torch.maximum(best, cards[:, sets])
            else:
                best = (a + b).amin(dim=2)
                val = best + cards[:, sets]
            if excluded is not None:
                val = torch.where(excluded[:, sets], inf, val)
            dp[:, sets] = val
    return dp


def solve(queries: list, cost: str, semantics: dict, device="cpu",
          dtype=torch.float64) -> list:
    """Reference solves of same-``n`` queries ``[(n, edges, card)]`` under
    ``cost``: one dict per query with the optimum ``opt``, the value
    table ``dp``, the cardinalities ``card`` (both numpy, in ``dtype``),
    and ``allowed``, the (2^n,) bool table of the sets a plan may hold
    (None: all)."""
    n = queries[0][0]
    cards = torch.as_tensor(np.stack([q[2] for q in queries]),
                            device=device).to(dtype)
    pc = torch.as_tensor(popcounts(n), device=device)
    allowed = None
    if cost == "max":
        dp = dp_table(cards, n, "max")
    elif cost == "cap":
        gamma = dp_table(cards, n, "max")[:, -1:] * float(
            semantics.get("cap_slack", 1.0))
        allowed = (cards <= gamma) | (pc < 2)[None, :]
        dp = dp_table(cards, n, "out", excluded=~allowed)
    elif cost == "out":
        rows = []
        for q in queries:
            if excludes_cross_products("out", q[0], q[1], semantics):
                rows.append(connected_sets(n, q[1]) | (popcounts(n) == 1))
            else:
                rows.append(np.ones(1 << n, bool))
        allowed = torch.as_tensor(np.stack(rows), device=device)
        dp = dp_table(cards, n, "out", excluded=~allowed)
    else:
        raise ValueError(f"unknown cost {cost!r}")
    dp_h = dp.cpu().numpy()
    cards_h = cards.cpu().numpy()
    al = None if allowed is None else allowed.cpu().numpy()
    return [{"opt": float(dp_h[i, -1]), "dp": dp_h[i], "card": cards_h[i],
             "allowed": None if al is None else al[i], "mode":
             "max" if cost == "max" else "out"}
            for i in range(len(queries))]


def _split_options(s: int) -> np.ndarray:
    low = s & -s
    rest = [1 << j for j in range(s.bit_length()) if (s >> j) & 1
            and (1 << j) != low]
    idx = np.arange((1 << len(rest)) - 1, dtype=np.int64)
    A = np.full(idx.shape, low, dtype=np.int64)
    for j, b in enumerate(rest):
        A += ((idx >> j) & 1) * b
    return A


def extract_tree(sol: dict, n: int) -> tuple:
    """An optimal plan from a value table: at each set the first split
    that reproduces its value in the table's own arithmetic."""
    dp, card, mode = sol["dp"], sol["card"], sol["mode"]

    def build(s: int) -> tuple:
        if s & (s - 1) == 0:
            return (s,)
        A = _split_options(s)
        B = s ^ A
        if mode == "max":
            val = np.maximum(np.maximum(dp[A], dp[B]), card[s])
        else:
            val = (dp[A] + dp[B]) + card[s]
        hit = np.nonzero(val == dp[s])[0]
        if not len(hit):
            raise RuntimeError(f"no split reproduces DP[{s:b}]")
        a = int(A[hit[0]])
        return (s, build(a), build(s ^ a))
    return build((1 << n) - 1)


def tree_cost(tree: tuple, sol: dict, n: int) -> float:
    """The float64 cost of a plan under the solve's semantics (summed in
    the DP's order), or inf where it is not a plan of the query: a
    leaf that is not one relation, children that overlap or do not make
    their parent, a root that is not the whole query, or a set the
    semantics exclude."""
    card = np.asarray(sol["card"], np.float64)
    allowed = sol["allowed"]
    inf = math.inf
    if not isinstance(tree, tuple) or not tree or tree[0] != (1 << n) - 1:
        return inf

    def walk(t) -> float:
        if len(t) == 1:
            m = t[0]
            return 0.0 if m > 0 and m & (m - 1) == 0 else inf
        if len(t) != 3:
            return inf
        m, left, right = t
        if left[0] & right[0] or left[0] | right[0] != m:
            return inf
        if allowed is not None and not allowed[m]:
            return inf
        a, b = walk(left), walk(right)
        if sol["mode"] == "max":
            return max(a, b, float(card[m]))
        return (a + b) + float(card[m])
    return walk(tree)


def judge(served_cost: float, served_tree, sol: dict, n: int) -> tuple:
    """(cost gap, tree gap) of one served answer: relative distances of
    the served cost and of the served tree's cost from the optimum."""
    opt = sol["opt"]
    cost_gap = abs(float(served_cost) - opt) / opt
    tc = math.inf if served_tree is None else tree_cost(served_tree, sol, n)
    tree_gap = abs(tc - opt) / opt if math.isfinite(tc) else math.inf
    return (cost_gap if math.isfinite(cost_gap) else math.inf), tree_gap
