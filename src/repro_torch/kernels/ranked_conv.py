"""Layer-k ranked convolution kernel for Hopper: wrapper of
``csrc/ranked_conv.cu``.

Replaces ``repro/kernels/ranked_conv.py::_ranked_conv_kernel`` (launched
by ``ranked_conv_pallas``).  From a ranked zeta table Z of shape
(n+1, ..., 2^n) it computes, elementwise over the lattice with the batch
axes folded in,

    acc = 2 Σ_{d=1}^{⌊(k-1)/2⌋} Z[d] Z[k-d]  (+ Z[k/2]^2 if k is even),

of shape (..., 2^n).  Bound by memory: rank slices 1..k-1 are read once
and the result written once; the kernel keeps the sum in registers and
takes k at run time.  No fallback for small tables: every shape launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def ranked_conv_cuda(Z: torch.Tensor, k: int) -> torch.Tensor:
    if Z.device.type != "cuda":
        raise ValueError("ranked_conv_cuda takes a CUDA tensor")
    code = build.dtype_code(Z)
    nranks = Z.shape[0]
    if not 1 <= k < nranks:
        raise ValueError(f"layer k={k} outside [1, {nranks - 1}]")
    Z = Z.contiguous()
    out = torch.empty(Z.shape[1:], dtype=Z.dtype, device=Z.device)
    rest = out.numel()
    if rest == 0:
        return out
    err = build.library().repro_ranked_conv(
        Z.data_ptr(), out.data_ptr(), rest, nranks, int(k), code,
        Z.get_device(), build.current_stream(Z))
    build.check(err, "ranked_conv")
    build.count_launch("ranked_conv")
    return out
