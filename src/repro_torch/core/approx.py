"""(1+eps)-approximate C_out (paper Sec. 7) — counterpart of
``repro.core.approx``.

Layered scale-and-round: each DP layer's (min,+) subset convolution is
approximated by

  for each magnitude class m (covering results in (2^{m-1}, 2^m]):
      quantize admitted values (<= 2^m) with step s_m = eps' 2^{m-1},
      run the EXACT FFT-embedded FSC on the small-integer exponents
      (coefficient dimension D = O(1/eps'), independent of W),
      rescale the min exponent by s_m;
  take the best class.

Ceil-rounding makes every class an over-estimate, and the class matching
the true optimum's magnitude over-estimates by <= 2 s_m <= 2 eps' * true,
so each layer is a (1+2 eps')-approximation; with eps' = eps / (3 (n-1))
the composed factor is (1+2eps')^{n-1} <= 1+eps for eps <= 1.

The quantization and class bookkeeping are numpy, as in the reference;
the lattice transforms and the inverse FFT are PyTorch complex128 ops on
the caller's device.  Coefficients are integers read through ``> 0.5``,
so the value equals the reference's whatever FFT library rounds them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.bitset import popcounts
from repro_torch.core.engine import host_cards
from repro_torch.core.zeta import mobius, zeta
from repro_torch.device import resolve_device


def approx_out(card, n: int, eps: float = 0.25, cost: str = "out",
               device=None):
    """(1+eps)-approximate C_out (or C_smj) optimum on ``device`` (CUDA
    unless given).  Returns (value, dp_table).

    Guarantee: true_opt <= value <= (1+eps) * true_opt.

    cost = "smj" is the paper's Sec. 3.5 extension: the additively-
    separable sort-merge term σ = c·log2(c) is *sunk* into each DP entry
    before the convolution (FSC(DP + σ)), and no own-term is added after.
    """
    if eps <= 0:
        raise ValueError("eps must be positive")
    dev = resolve_device(device)
    size = 1 << n
    pc = popcounts(n)
    card = host_cards(card)
    if cost == "smj":
        sink = card * np.log2(np.maximum(card, 2.0))
        own = np.zeros(size)
    elif cost == "out":
        sink = np.zeros(size)
        own = card
    else:
        raise ValueError(cost)

    eps_p = eps / (3.0 * max(n - 1, 1))
    d_slots = int(math.ceil(2.0 / eps_p)) + 2     # exponents per class
    fft_len = 1
    while fft_len < 2 * d_slots + 1:
        fft_len *= 2
    n_freq = fft_len // 2 + 1

    dp = np.zeros(size, np.float64)               # approximate DP values
    dp[pc == 0] = np.inf
    dp[pc >= 2] = np.inf                          # not yet computed

    def ranked_class_conv(k: int, m: int) -> np.ndarray:
        """Approx min_{T} v[T]+v[S\\T], v = dp + sink, for |S|=k in class
        m; inf where no admitted split exists."""
        s_m = eps_p * (2.0 ** (m - 1))
        lim = 2.0 ** m
        v = dp + sink
        admit = v <= lim
        q = np.ceil(np.where(admit, v, 0.0) / s_m)        # integer exponents
        q = np.minimum(q, d_slots - 1)
        phase = np.exp(-2j * np.pi * np.outer(q, np.arange(n_freq))
                       / fft_len)
        phase = np.where(admit[:, None], phase, 0.0)
        acc = torch.zeros((size, n_freq), dtype=torch.complex128,
                          device=dev)
        zf = {}
        for d in range(1, k):
            layer = (pc == d) & admit
            ph = torch.as_tensor(np.where(layer[:, None], phase, 0.0),
                                 device=dev)
            zf[d] = zeta(ph.T).T
        for d in range(1, (k - 1) // 2 + 1):
            acc = acc + zf[d] * zf[k - d]
        acc = acc * 2.0
        if k % 2 == 0:
            acc = acc + zf[k // 2] * zf[k // 2]
        h = mobius(acc.T).T
        coeffs = torch.fft.irfft(h, n=fft_len, dim=-1).cpu().numpy()
        present = coeffs > 0.5
        has = present.any(axis=-1)
        minexp = np.argmax(present, axis=-1)
        return np.where(has, minexp * s_m, np.inf)

    vmax_layer = (card[pc >= 2].max() if n >= 2 else 1.0) + sink.max()
    for k in range(2, n + 1):
        vv = dp + sink
        finite = vv[np.isfinite(vv) & (vv > 0)]
        lo_val = max(finite.min() if finite.size else 1.0, 1e-9)
        hi_val = (finite.max() if finite.size else 1.0) * 2 + vmax_layer * k
        m_lo = int(math.floor(math.log2(max(lo_val, 1e-9))))
        m_hi = int(math.ceil(math.log2(hi_val))) + 1
        best = np.full(size, np.inf)
        for m in range(m_lo, m_hi + 1):
            best = np.minimum(best, ranked_class_conv(k, m))
        sel = pc == k
        dp[sel] = best[sel] + own[sel]
    return float(dp[size - 1]), dp
