"""Zeta/Moebius transform kernel for Hopper: wrapper of ``csrc/zeta.cu``.

Replaces ``repro/kernels/zeta_pallas.py``: ``_local_kernel`` (launched by
``_local_pass``) and ``_pair_kernel`` (launched by ``_pair_pass``), with
the ``zeta_pallas`` host contract (leading axes fold into the row axis,
butterflies never cross a 2^n element).

A transform over n bits of elements of E bytes (4: int32, float32; 8:
float64) follows ``launch_plan(n, E)``: one ``zeta_cluster`` launch takes
the low min(n, LOW_BITS[E]) bits — a 16 KB tile per block (4096
elements at 4 bytes, 2048 at 8), the bits above it across a thread block
cluster of ``cluster_size(n, E)`` blocks through distributed shared
memory — reading and writing every element once; the bits above follow
in ``zeta_high`` launches of at most ``HIGH_BITS`` bits each, in place.
A ``zeta_high`` launch over b bits reads the table once and writes the
share 1 - 2^-b of it (its bound), where one launch per bit read it b
times: each thread keeps one 16-byte column of the b bits' 2^b rows in
registers.  The int32 tier ends at n = 15, so it makes one launch per
transform; the float64 tier (``core.lattice.transforms``) makes one up
to n = 14 and two at n = 15..19 (its large cliques, n = 16..19).  The
output may be the input (``out=f``), and may be a contiguous slice of a
larger buffer (a ranked buffer's slot).  Every n >= 0 launches on a CUDA
tensor.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.zeta import lattice_bits
from repro_torch.kernels import build

# by element size: one block's 16 KB tile (Tile<T>::kBits in the source)
TILE_BITS = {4: 12, 8: 11}
CLUSTER_BITS = 3        # at most 8 blocks per cluster (the portable size)
# bits one zeta_cluster launch takes, by element size
LOW_BITS = {e: b + CLUSTER_BITS for e, b in TILE_BITS.items()}
HIGH_BITS = 5           # bits one zeta_high launch takes (kHighMaxBits)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, itemsize: int = 4) -> tuple:
    """The launches of an n-bit transform of ``itemsize``-byte elements,
    in order: ``(kernel, lo, hi)`` applies bits ``lo..hi-1``."""
    low = min(n, LOW_BITS[itemsize])
    return (("zeta_cluster", 0, low),) + tuple(
        ("zeta_high", lo, min(lo + HIGH_BITS, n))
        for lo in range(low, n, HIGH_BITS))


def cluster_size(n: int, itemsize: int = 4) -> int:
    """Blocks per cluster of the ``zeta_cluster`` launch at n bits."""
    return 1 << max(min(n, LOW_BITS[itemsize]) - TILE_BITS[itemsize], 0)


def launch_cluster(x: torch.Tensor, out: torch.Tensor, bits: int,
                   sign: int) -> None:
    """One ``zeta_cluster`` launch: the low ``bits`` (at most
    ``LOW_BITS`` of the element size) bits of every 2^bits row of ``x``
    into ``out`` (same shape, contiguous, on the card; ``out`` may be
    ``x``)."""
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
    tensor of int32, float32 or float64, into ``out`` (contiguous, same
    shape and dtype; may be ``f``) or a new tensor."""
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
    for kernel, lo, hi in launch_plan(n, f.element_size()):
        if kernel == "zeta_cluster":
            launch_cluster(f, out, hi, sign)
        else:
            launch_high(out, lo, hi, sign)
    return out
