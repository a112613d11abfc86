"""Fast subset convolution in the (+, ·) ring (paper Sec. 4, Lst. 2) —
counterpart of ``repro.core.fsc``.

``h(S) = Σ_{T ⊆ S} f(T) g(S \\ T)`` for all S, in O(2^n n^2) ring ops:

  ① rank-split f and g by popcount,
  ② zeta-transform every rank slice,
  ③ ranked (sequence) convolution point-wise over the lattice,
  ④ Moebius transform rank-wise,
  ⑤ gather rank r = |S| back into a flat table.

PyTorch ops on the tensors' device.  With {0,1} inputs every
intermediate is an integer below 2^{2n}, so float64 is exact to n = 26.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.zeta import lattice_bits, mobius, zeta


def rank_split(f: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """(2^n,) -> (n+1, 2^n) ranked table; slice r holds f on |S| = r,
    else 0."""
    n = lattice_bits(f.shape[-1])
    ranks = torch.arange(n + 1, dtype=pc.dtype, device=pc.device)[:, None]
    return torch.where(pc[None, :] == ranks, f[None, :],
                       torch.zeros((), dtype=f.dtype, device=f.device))


def subset_convolve(f: torch.Tensor, g: torch.Tensor,
                    pc: torch.Tensor) -> torch.Tensor:
    """Exact subset convolution of two (2^n,) tables in the (+,·) ring.
    ``pc`` is the (2^n,) popcount table."""
    n = lattice_bits(f.shape[-1])
    zf = zeta(rank_split(f, pc))          # (n+1, 2^n)
    zg = zeta(rank_split(g, pc))
    # ③ ranked convolution: zh[r] = Σ_{d<=r} zf[d] * zg[r-d]
    zh = []
    for r in range(n + 1):
        acc = torch.zeros_like(zf[0])
        for d in range(r + 1):
            acc = acc + zf[d] * zg[r - d]
        zh.append(acc)
    h_ranked = mobius(torch.stack(zh))    # ④
    # ⑤ gather h(S) = h_ranked[|S|, S]
    return torch.gather(h_ranked, 0, pc[None, :].to(torch.int64))[0]


def subset_convolve_ref(f, g) -> np.ndarray:
    """O(3^n) oracle (numpy, small n only)."""
    f = np.asarray(f)
    g = np.asarray(g)
    size = f.shape[-1]
    out = np.zeros_like(f)
    for s in range(size):
        t = s
        while True:
            out[s] += f[t] * g[s & ~t]
            if t == 0:
                break
            t = (t - 1) & s
    return out
