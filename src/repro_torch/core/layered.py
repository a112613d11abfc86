"""Layered dynamic programming (paper Sec. 5) — the host-loop
instantiation (counterpart of ``repro.core.layered``).

The recursion lives in ``core.lattice.feasibility_layers``; this module
is the per-pass instantiation the host-loop solvers and the ``dp_fn``
hooks use: one call is one feasibility pass on one transform tier
(``lattice.transforms``), whose ranked convolution takes each middle
layer.  It also holds the paper's early-exit pass
(``layered_feasibility_early_exit``), which reads each layer on the host
and stops as soon as no larger set can be feasible.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lattice
from repro_torch.core.bitset import popcounts


def direct_layer_feasible(dp: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Indicator over layer-k sets: exists a proper split T with
    dp[T] > 0 and dp[S\\T] > 0.  Returns (m,) in dp's dtype, {0,1},
    aligned with ``layer_indices(n)[k]``."""
    _, subs, comps = lattice.direct_layer_tables(n, k, dp.device)
    prod = dp[subs] * dp[comps]              # (m, 2^k)
    # T = empty / T = S contribute nothing: dp[empty] = 0
    return (prod.sum(dim=1) > 0.5).to(dp.dtype)


def layered_feasibility_dp(
    gate: torch.Tensor,
    n: int,
    direct_layers: int = 4,
    final_layer_shortcut: bool = True,
    tier: str = "f64",
) -> torch.Tensor:
    """Boolean DP over the lattice: a set S (|S| >= 2) is *feasible* iff
    gate[S] and it splits into two disjoint feasible parts; singletons
    are feasible.  Returns the (..., 2^n) feasibility table in the tier's
    dtype — float64 for ``"f64"``, int32 for the kernel tier ``"cuda"``
    (zeta, Moebius and the ranked convolution through ``kernels.ops``;
    it takes a batched gate) — into which the gate is cast.
    """
    tfm = lattice.transforms(tier)
    gate = gate.to(tfm.dtype)
    dp, _, feas = lattice.feasibility_layers(
        gate, n, direct_layers, tfm, final_layer_shortcut)
    if final_layer_shortcut and direct_layers < n:
        dp[..., -1] = feas.to(tfm.dtype)
    return dp


# --------------------------------------------------------------------------
# Incremental pass with early exit.
#
# Soundness of the abort: any feasible set of size k splits into parts
# (a, k-a) whose larger part has size in [ceil(k/2), k-1].  So if every
# layer in that window is empty, layer k, and inductively every layer
# above it, is empty, and V is infeasible.  Infeasible gamma probes of
# Alg. 3's search typically die within a few layers.
# --------------------------------------------------------------------------
def _one_layer_step(Z, dp, gate, n: int, k: int, direct_layers: int,
                    tfm: lattice.Transforms):
    """Layer k of the recursion on ``tfm``'s tier: returns ``(dp,
    any_new)``, where ``any_new`` is a 0-d bool tensor (at k = n: V is
    feasible).  ``Z[k]`` is written in place for k < n."""
    pc = lattice.popcounts_on(n, dp.device)
    dtype = dp.dtype
    if k <= direct_layers:
        layer_full = lattice.direct_layer_full(dp, gate, n, k, pc, dtype)
    else:
        acc = tfm.ranked_conv(Z, k)
        if k == n:
            count_v = lattice.moebius_at_v(acc, pc, n)
            feas_v = (count_v > 0.5).to(dtype) * gate[..., -1]
            dp[..., -1] = feas_v
            return dp, feas_v > 0.5
        h = tfm.mobius(acc, out=acc)
        layer_full = torch.where(pc == k, (h > 0.5).to(dtype) * gate,
                                 torch.zeros((), dtype=dtype,
                                             device=dp.device))
    dp = dp + layer_full
    if k < n:
        tfm.zeta(layer_full, out=Z[k])
    return dp, torch.any(layer_full > 0.5)


def layered_feasibility_early_exit(gate: torch.Tensor, n: int,
                                   direct_layers: int = 4) -> bool:
    """Feasibility of the full set V under the (2^n,) f64 ``gate``, with
    the dyadic-window abort: a host loop over layers, one host sync per
    layer.  The ranked-zeta buffer ``Z`` is updated in place."""
    size = 1 << n
    dev = gate.device
    tfm = lattice.transforms("f64")
    pc = lattice.popcounts_on(n, dev)
    dp = (pc == 1).to(torch.float64)
    Z = torch.zeros((n + 1, size), dtype=torch.float64, device=dev)
    tfm.zeta(dp, out=Z[1])
    nonempty = [True] * 2 + [False] * (n - 1)     # indexed by layer size
    for k in range(2, n + 1):
        lo = (k + 1) // 2
        if not any(nonempty[lo:k]):
            return False                          # provably dead above
        dp, any_new = _one_layer_step(Z, dp, gate, n, k, direct_layers,
                                      tfm)
        if k == n:
            return bool(any_new)
        nonempty[k] = bool(any_new)
    return bool(dp[..., -1] > 0.5)


# --------------------------------------------------------------------------
# numpy reference for tests (naive O(3^n) feasibility DP, small n)
# --------------------------------------------------------------------------
def feasibility_dp_ref(gate: np.ndarray, n: int) -> np.ndarray:
    size = 1 << n
    pc = popcounts(n)
    dp = np.zeros(size)
    dp[pc == 1] = 1.0
    for s in range(size):
        if pc[s] < 2:
            continue
        ok = False
        t = (s - 1) & s
        while t:
            if dp[t] > 0 and dp[s & ~t] > 0:
                ok = True
                break
            t = (t - 1) & s
        dp[s] = 1.0 if (ok and gate[s] > 0) else 0.0
    return dp
