"""Zeta/Moebius transform kernel for Hopper: wrapper of ``csrc/zeta.cu``.

Replaces ``repro/kernels/zeta_pallas.py``: ``_local_kernel`` (launched by
``_local_pass``) and ``_pair_kernel`` (launched by ``_pair_pass``), with
the ``zeta_pallas`` host contract (leading axes fold into the row axis,
butterflies never cross a 2^n element).

A transform over n bits follows ``launch_plan(n)``: one ``zeta_cluster``
launch takes the low min(n, 15) bits — a 4096-element tile per block,
bits 12..14 across a thread block cluster of ``cluster_size(n)`` blocks
through distributed shared memory — reading and writing every element
once; the bits >= 15 follow in ``zeta_high`` launches of at most
``HIGH_BITS`` bits each, in place.  A ``zeta_high`` launch over b bits
reads the table once and writes the share 1 - 2^-b of it (its bound),
where one launch per bit read it b times: each thread keeps one 16-byte
column of the b bits' 2^b rows in registers.  The int32 tier ends at
n = 15, so the main path makes one launch per transform.  The output
may be the input (``out=f``), and may be a contiguous slice of a larger
buffer (a ranked buffer's slot).  Every n >= 0 launches on a CUDA
tensor.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.zeta import lattice_bits
from repro_torch.kernels import build

TILE_BITS = 12          # one block's tile: 4096 elements, 16 KB
CLUSTER_BITS = 3        # at most 8 blocks per cluster (the portable size)
LOW_BITS = TILE_BITS + CLUSTER_BITS   # bits one zeta_cluster launch takes
HIGH_BITS = 5           # bits one zeta_high launch takes (kHighMaxBits)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int) -> tuple:
    """The launches of an n-bit transform, in order: ``(kernel, lo, hi)``
    applies bits ``lo..hi-1``."""
    low = min(n, LOW_BITS)
    return (("zeta_cluster", 0, low),) + tuple(
        ("zeta_high", lo, min(lo + HIGH_BITS, n))
        for lo in range(low, n, HIGH_BITS))


def cluster_size(n: int) -> int:
    """Blocks per cluster of the ``zeta_cluster`` launch at n bits."""
    return 1 << max(min(n, LOW_BITS) - TILE_BITS, 0)


def launch_cluster(x: torch.Tensor, out: torch.Tensor, bits: int,
                   sign: int) -> None:
    """One ``zeta_cluster`` launch: the low ``bits`` (<= 15) bits of every
    2^bits row of ``x`` into ``out`` (same shape, contiguous, on the
    card; ``out`` may be ``x``)."""
    err = build.library().repro_zeta_cluster(
        x.data_ptr(), out.data_ptr(), x.numel(), bits, sign,
        build.dtype_code(x), x.get_device(), build.current_stream(x))
    build.check(err, "zeta_cluster")
    build.count_launch("zeta_cluster")


def launch_high(x: torch.Tensor, lo: int, hi: int, sign: int,
                out: "torch.Tensor | None" = None) -> None:
    """One ``zeta_high`` launch: butterfly stages ``lo..hi-1`` (at most
    ``HIGH_BITS``) of every 2^hi block of ``x``, into ``out`` (same
    shape, contiguous, on the card) or, by default, in place.  The
    transform launches in place; ``out`` serves the parity checks, which
    hold the kernel's out-of-place store to its plain version too."""
    if out is None:
        out = x
    err = build.library().repro_zeta_high(
        x.data_ptr(), out.data_ptr(), x.numel(), lo, hi, sign,
        build.dtype_code(x), x.get_device(), build.current_stream(x))
    build.check(err, "zeta_high")
    build.count_launch("zeta_high")


def zeta_cuda(f: torch.Tensor, inverse: bool = False,
              out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Zeta (or Moebius, ``inverse=True``) over the last axis of a CUDA
    tensor of int32 or float32, into ``out`` (contiguous, same shape and
    dtype; may be ``f``) or a new tensor."""
    if f.device.type != "cuda":
        raise ValueError("zeta_cuda takes a CUDA tensor")
    build.dtype_code(f)
    n = lattice_bits(f.shape[-1])
    f = f.contiguous()
    if out is None:
        out = torch.empty_like(f)
    elif (out.shape != f.shape or out.dtype != f.dtype
          or out.device != f.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor of the input's "
                         "shape, dtype and device")
    if f.numel() == 0:
        return out
    sign = -1 if inverse else 1
    for kernel, lo, hi in launch_plan(n):
        if kernel == "zeta_cluster":
            launch_cluster(f, out, hi, sign)
        else:
            launch_high(out, lo, hi, sign)
    return out
