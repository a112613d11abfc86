"""DPconv[out] — exact C_out via the polynomial-embedding technique
(paper Sec. 3.2 / 3.3): O(2^n n^2 · W n log(W n)).  Counterpart of
``repro.core.dpconv_out``.

The (min,+) semiring has no additive inverses, so FSC cannot run in it
directly.  The embedding maps value v to the monomial x^v; subset
convolution then runs in the ordinary (+,·) ring over polynomial values,
where "+ at the exponent level" realizes the semiring ⊗ and "smallest
exponent with a non-zero coefficient" realizes the min.

Polynomials live in the Fourier domain throughout: the lattice zeta
transform and the coefficient-axis FFT are linear, so they commute —
each ranked slice is stored as rfft(ζ(x^{DP})) and the ranked
convolution is a pointwise complex multiply.  complex128 on the
caller's device (``torch.fft``); cuFFT and pocketfft round differently,
but every coefficient is an integer read through ``> 0.5``, so the DP
table is exact and equal to the reference's.  Not practical for large
W (paper Sec. 9.1): the coefficient axis is the value range.

Requires integral cardinalities (exponents index coefficient slots).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import jointree
from repro_torch.core.bitset import popcounts
from repro_torch.core.engine import host_cards
from repro_torch.core.lattice import popcounts_on
from repro_torch.core.zeta import mobius, zeta
from repro_torch.device import resolve_device


def dpconv_out(card, n: int, extract_tree: bool = False, device=None):
    """Exact C_out optimum via FFT-embedded FSC on ``device`` (CUDA unless
    given).  ``card`` must hold non-negative integers (small W!).
    Returns (optimum, dp_table[, tree]); the table is int64."""
    dev = resolve_device(device)
    size = 1 << n
    card = host_cards(card)
    card_i = card.astype(np.int64)
    if not np.array_equal(card_i, card):
        raise ValueError("dpconv_out requires integral cardinalities")
    pc = popcounts(n)
    w = int(card_i[pc >= 2].max()) if n >= 2 else 0
    dmax = w * max(n - 1, 1) + 1          # max possible DP value + 1
    fft_len = 1
    while fft_len < 2 * dmax + 1:
        fft_len *= 2

    pc_t = popcounts_on(n, dev)
    card_t = torch.as_tensor(card_i, device=dev)

    # Fourier-domain ranked zeta table: ZF[d] = rfft(zeta(x^{DP on layer d}))
    n_freq = fft_len // 2 + 1
    ZF = torch.zeros((n + 1, size, n_freq), dtype=torch.complex128,
                     device=dev)
    dp = torch.zeros(size, dtype=torch.int64, device=dev)   # exponents
    freqs = torch.arange(n_freq, dtype=torch.float64, device=dev)
    czero = torch.zeros((), dtype=torch.complex128, device=dev)

    def embed_layer(dp_vals, layer_mask):
        """rfft of x^{dp} on the layer, zeros elsewhere; then lattice
        zeta.  rfft of a one-hot at exponent e is exp(-2πi·f·e/fft_len)."""
        phase = torch.exp(-2j * math.pi * freqs[None, :]
                          * dp_vals[:, None].to(torch.float64) / fft_len)
        phase = torch.where(layer_mask[:, None], phase, czero)
        return zeta(phase.T).T            # zeta over the lattice axis

    ZF[1] = embed_layer(dp, pc_t == 1)
    for k in range(2, n + 1):
        acc = torch.zeros((size, n_freq), dtype=torch.complex128,
                          device=dev)
        for d in range(1, (k - 1) // 2 + 1):
            acc = acc + ZF[d] * ZF[k - d]
        acc = acc * 2.0
        if k % 2 == 0:
            acc = acc + ZF[k // 2] * ZF[k // 2]
        h = mobius(acc.T).T               # Moebius over the lattice axis
        coeffs = torch.fft.irfft(h, n=fft_len, dim=-1)   # (size, fft_len)
        present = (coeffs > 0.5).to(torch.uint8)
        # min exponent with a non-zero coefficient (first maximum)
        minexp = torch.argmax(present, dim=-1)
        layer = pc_t == k
        dp = dp + torch.where(layer, minexp + card_t, 0)
        if k < n:
            ZF[k] = embed_layer(dp, layer)

    dp_np = dp.cpu().numpy()
    opt = int(dp_np[size - 1])
    if extract_tree:
        dpf = dp_np.astype(np.float64)
        dpf[pc == 0] = np.inf
        tree = jointree.extract_tree_out(dpf, card_i.astype(np.float64), n)
        return opt, dp_np, tree
    return opt, dp_np
