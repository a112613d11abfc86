"""Layered dynamic programming (paper Sec. 5) — the host-loop
instantiation (counterpart of ``repro.core.layered``).

The recursion lives in ``core.lattice.feasibility_layers``; this module
is the per-pass instantiation the host-loop solvers and the ``dp_fn``
hooks use: one call is one feasibility pass, unrolled over static layers
so that the ranked-convolution kernel can take each middle layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lattice
from repro_torch.core.bitset import popcounts
from repro_torch.core.zeta import mobius, zeta


def layered_feasibility_dp(
    gate: torch.Tensor,
    n: int,
    direct_layers: int = 4,
    final_layer_shortcut: bool = True,
    zeta_fn=zeta,
    mobius_fn=mobius,
    ranked_conv_fn=None,
) -> torch.Tensor:
    """Boolean DP over the lattice: a set S (|S| >= 2) is *feasible* iff
    gate[S] and it splits into two disjoint feasible parts; singletons
    are feasible.  Returns the (..., 2^n) feasibility table in the gate's
    dtype — float64 for the f64 tier, int32 for the kernel tier.

    ``zeta_fn``/``mobius_fn`` select the transform backend (default: the
    f64 butterflies; ``kernels.ops.zeta_batch_op``/``mobius_batch_op`` for
    the kernel tier; both take ``out=``) and ``ranked_conv_fn`` optionally routes the
    middle-layer convolutions to ``kernels.ops.ranked_conv_op``.
    """
    tfm = lattice.Transforms("host", zeta_fn, mobius_fn, gate.dtype,
                             ranked_conv=ranked_conv_fn)
    dp, _, feas = lattice.feasibility_layers(
        gate, n, direct_layers, tfm, final_layer_shortcut)
    if final_layer_shortcut and direct_layers < n:
        dp[..., -1] = feas.to(gate.dtype)
    return dp


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
