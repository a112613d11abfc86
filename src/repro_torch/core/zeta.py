"""Zeta and Moebius transforms over the subset lattice (paper Sec. 4) —
the plain version of the port's float64 tier (which runs the CUDA
kernels of ``kernels.ops`` on a card, bitwise these) and the transforms
of every direct caller.

Yates' butterfly (Lst. 1 of the paper) on the LAST axis of a batched
tensor: pass ``j`` views the lattice as (high, 2, low) and adds the
bit-j = 0 hyperplane into the bit-j = 1 hyperplane.  O(2^n n) adds, done
with PyTorch ops on the caller's device.  This is ``repro.core.zeta``'s
``zeta``/``mobius`` (the reference's "xla" tier, which was never a Pallas
kernel): on float64 feasibility counts it is exact to n = 26, so every
addition order gives the same bits.  ``butterfly`` takes any dtype that
adds, complex128 included (the Fourier-domain tables of
``core.dpconv_out`` and ``core.approx``).

Also here, as in the reference: ``zeta_matmul``/``mobius_matmul``, the
Kronecker-factor form (two dense products with Z^{⊗h} and Z^{⊗l}, Z =
[[1,0],[1,1]]), which the reference computes with ``jnp.einsum`` outside
any Pallas kernel; and ``zeta_np``/``mobius_np``, the O(3^n) numpy
definitions (test oracles only).
"""
from __future__ import annotations

import functools

import numpy as np
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


# -------------------------------------------------------------- kron matmul
@functools.lru_cache(maxsize=32)
def _kron_factor(bits: int, inverse: bool) -> np.ndarray:
    """Z^{⊗bits} (or its inverse) as a dense (2^bits, 2^bits) matrix:
    M[a, b] = 1 iff b ⊆ a (zeta); the inverse has sign (-1)^{|a\\b|}."""
    size = 1 << bits
    a = np.arange(size)[:, None]
    b = np.arange(size)[None, :]
    subset = (a & b) == b
    if not inverse:
        return subset.astype(np.float64)
    diff = a & ~b
    signs = (-1.0) ** np.vectorize(lambda x: bin(x).count("1"))(diff)
    return np.where(subset, signs, 0.0)


def _kron_transform(f: torch.Tensor, inverse: bool,
                    split: "int | None") -> torch.Tensor:
    size = f.shape[-1]
    n = lattice_bits(size)
    if split is None:
        split = n // 2
    lo_bits, hi_bits = split, n - split
    m_lo = torch.as_tensor(_kron_factor(lo_bits, inverse), dtype=f.dtype,
                           device=f.device)
    m_hi = torch.as_tensor(_kron_factor(hi_bits, inverse), dtype=f.dtype,
                           device=f.device)
    batch = tuple(f.shape[:-1])
    g = f.reshape(batch + (1 << hi_bits, 1 << lo_bits))
    # index S = hi * 2^lo + lo  ->  row-major (hi, lo)
    g = torch.einsum("Hh,...hl->...Hl", m_hi, g)
    g = torch.einsum("Ll,...hl->...hL", m_lo, g)
    return g.reshape(batch + (size,))


def zeta_matmul(f: torch.Tensor, split: "int | None" = None
                ) -> torch.Tensor:
    """Zeta transform as two Kronecker-factor products."""
    return _kron_transform(f, False, split)


def mobius_matmul(f: torch.Tensor, split: "int | None" = None
                  ) -> torch.Tensor:
    """Moebius transform as two Kronecker-factor products."""
    return _kron_transform(f, True, split)


# ------------------------------------------------------------ numpy oracles
def zeta_np(f: np.ndarray) -> np.ndarray:
    """Reference O(3^n) definition — test oracle only (small n!)."""
    size = f.shape[-1]
    out = np.zeros_like(f)
    for s in range(size):
        t = s
        acc = f[..., 0] * 0
        while True:
            acc = acc + f[..., t]
            if t == 0:
                break
            t = (t - 1) & s
        out[..., s] = acc
    return out


def mobius_np(f: np.ndarray) -> np.ndarray:
    size = f.shape[-1]
    out = np.zeros_like(f)
    for s in range(size):
        t = s
        acc = f[..., 0] * 0
        while True:
            sign = -1.0 if bin(s & ~t).count("1") % 2 else 1.0
            acc = acc + sign * f[..., t]
            if t == 0:
                break
            t = (t - 1) & s
        out[..., s] = acc
    return out
