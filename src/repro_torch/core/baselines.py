"""The paper's competitor algorithms: DPsize, DPsub (and pruned variants).

These evaluate the DP recursion (Eq. 5) *naively* — O(3^n) for DPsub,
O(4^n) for DPsize — and serve both as benchmarks (Figs. 6–8) and as test
oracles for DPconv.

Implementation note (hardware adaptation): the C++ originals iterate
``sub = (sub - 1) & S`` per set.  Here each popcount layer is processed as
one vectorized batch: the grouped bit-deposit trick (``submask_table``)
yields a (2^k, C(n,k)) submask matrix per layer, so the whole layer reduces
to gathers + a min-reduction — numpy-speed instead of Python-speed, while
performing exactly the textbook O(3^n) operation count.

Like DPsub in the paper these optimize over ALL splits (cross products
priced by ``card``); pass ``connected`` to restrict to connected subgraphs
(the DPsub variant used for sparse graphs).

A copy of ``repro.core.baselines`` (numpy only): the port never imports
``repro``, whose ``core`` package turns on JAX at import.  Keep the two
in step; ``tests/test_torch_costs.py`` holds them equal.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitset import layer_indices, popcounts, submask_table
from repro_torch.core import jointree

_INF = np.float64(np.inf)


def _layer_blocks(n: int, k: int, masks: np.ndarray, chunk_elems: int = 1 << 24):
    """Yield (sets_chunk, submask_chunk) with bounded memory."""
    per_set = 1 << k
    sets_per_chunk = max(1, chunk_elems // per_set)
    for lo in range(0, len(masks), sets_per_chunk):
        sets = masks[lo : lo + sets_per_chunk]
        yield lo, sets, submask_table(sets, k)  # (2^k, m)


def dpsub(card: np.ndarray, n: int, mode: str = "out",
          prune_gamma: float | None = None,
          connected: np.ndarray | None = None) -> np.ndarray:
    """DPsub over the full lattice.  Returns the DP value table (2^n,).

    mode = "out" : DP[S] = c(S) + min_T (DP[T] + DP[S\\T])        (C_out)
    mode = "max" : DP[S] = max(c(S), min_T max(DP[T], DP[S\\T]))  (C_max)
    mode = "smj" : DP[S] = min_T (DP[T] + σ(T) + DP[S\\T] + σ(S\\T)),
                   σ = c·log2(c) — sort-merge-join cost, Eq. 9.  This is the
                   additively-separable cost the paper's Sec. 3.5 "sinks"
                   into the DP entries.
    prune_gamma  : C_cap second pass — sets with c(S) > gamma are infeasible
                   (paper Sec. 8: prune intermediate sizes above the optimal
                   C_max value).
    connected    : optional boolean (2^n,) mask; non-connected sets skipped.
    """
    size = 1 << n
    dp = np.full(size, _INF)
    pc = popcounts(n)
    dp[pc == 1] = 0.0
    sink = None
    if mode == "smj":
        sink = card * np.log2(np.maximum(card, 2.0))
        sink[0] = _INF                              # exclude empty side
    layers = layer_indices(n)
    for k in range(2, n + 1):
        masks = layers[k]
        if connected is not None:
            masks = masks[connected[masks]]
        if len(masks) == 0:
            continue
        for lo, sets, subs in _layer_blocks(n, k, masks):
            comps = sets[None, :] & ~subs               # (2^k, m)
            a = dp[subs]
            b = dp[comps]
            if mode == "max":
                combo = np.maximum(a, b)
            elif mode == "smj":
                combo = a + sink[subs] + b + sink[comps]
            else:
                combo = a + b
            # T = 0 / T = S rows carry dp[0] = inf -> excluded automatically
            best = np.min(combo, axis=0)
            if mode == "max":
                val = np.maximum(best, card[sets])
            elif mode == "smj":
                val = best
            else:
                val = best + card[sets]
            if prune_gamma is not None:
                val = np.where(card[sets] <= prune_gamma, val, _INF)
            dp[sets] = val
    return dp


def dpsub_out(card, n, **kw):
    return dpsub(card, n, mode="out", **kw)


def dpsub_max(card, n, **kw):
    return dpsub(card, n, mode="max", **kw)


def dpsize(card: np.ndarray, n: int, mode: str = "out") -> np.ndarray:
    """Selinger-style DPsize: combine layer pairs (k1, k2), k1 + k2 = k.

    O(4^n)-ish set-pair enumeration (disjointness checked, not exploited),
    faithful to the original enumeration order.  Benchmark/oracle only —
    use small n.
    """
    size = 1 << n
    dp = np.full(size, _INF)
    pc = popcounts(n)
    dp[pc == 1] = 0.0
    layers = layer_indices(n)
    for k in range(2, n + 1):
        best = np.full(size, _INF)
        for k1 in range(1, k // 2 + 1):
            k2 = k - k1
            s1 = layers[k1]
            s2 = layers[k2]
            # all pairs; keep disjoint ones
            u = s1[:, None] | s2[None, :]
            disjoint = (s1[:, None] & s2[None, :]) == 0
            if mode == "max":
                combo = np.maximum(dp[s1][:, None], dp[s2][None, :])
            else:
                combo = dp[s1][:, None] + dp[s2][None, :]
            combo = np.where(disjoint, combo, _INF)
            np.minimum.at(best, u.ravel(), combo.ravel())
        sel = layers[k]
        if mode == "max":
            dp[sel] = np.maximum(best[sel], card[sel])
        else:
            dp[sel] = best[sel] + card[sel]
    return dp


# ------------------------------------------------------------------- trees
def dpsub_with_tree(card: np.ndarray, n: int, mode: str = "out",
                    **kw) -> tuple:
    dp = dpsub(card, n, mode=mode, **kw)
    if mode == "max":
        tree = jointree.extract_tree_max(dp, card, n)
    else:
        tree = jointree.extract_tree_out(dp, card, n)
    return dp, tree
