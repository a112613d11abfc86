"""Zeta and Moebius transforms over the subset lattice (paper Sec. 4) —
the f64 tier of the port.

Yates' butterfly (Lst. 1 of the paper) on the LAST axis of a batched
tensor: pass ``j`` views the lattice as (high, 2, low) and adds the
bit-j = 0 hyperplane into the bit-j = 1 hyperplane.  O(2^n n) adds, done
with PyTorch ops on the caller's device.  This is ``repro.core.zeta``'s
``zeta``/``mobius`` (the reference's "xla" tier, which was never a Pallas
kernel): on float64 feasibility counts it is exact to n = 26, so every
addition order gives the same bits.
"""
from __future__ import annotations

import torch


def lattice_bits(size: int) -> int:
    """n for a lattice axis of 2^n elements."""
    n = int(size).bit_length() - 1
    if size < 1 or (1 << n) != size:
        raise ValueError(f"lattice size {size} is not a power of two")
    return n


def butterfly(f: torch.Tensor, sign: int, stages: "range | None" = None,
              out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Zeta (``sign`` = +1) or Moebius (-1) over the last axis, into
    ``out`` (contiguous, same shape; may be ``f``) or a fresh tensor.
    Integer dtypes wrap like two's-complement hardware.  ``stages``
    limits the pass to those bits (default: all n)."""
    size = f.shape[-1]
    n = lattice_bits(size)
    batch = tuple(f.shape[:-1])
    if out is None:
        f = f.clone(memory_format=torch.contiguous_format)
    else:
        if out.shape != f.shape or not out.is_contiguous():
            raise ValueError("out must be contiguous, of the input's shape")
        f = out.copy_(f)
    for j in (range(n) if stages is None else stages):
        g = f.view(batch + (size // (2 << j), 2, 1 << j))
        if sign > 0:
            g[..., 1, :] += g[..., 0, :]
        else:
            g[..., 1, :] -= g[..., 0, :]
    return f


def zeta(f: torch.Tensor, out: "torch.Tensor | None" = None
         ) -> torch.Tensor:
    """(ζf)(S) = Σ_{T ⊆ S} f(T), on the last axis."""
    return butterfly(f, 1, out=out)


def mobius(f: torch.Tensor, out: "torch.Tensor | None" = None
           ) -> torch.Tensor:
    """(μf)(S) = Σ_{T ⊆ S} (-1)^{|S\\T|} f(T); inverse of ``zeta``."""
    return butterfly(f, -1, out=out)
