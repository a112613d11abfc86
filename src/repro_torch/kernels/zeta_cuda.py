"""Zeta/Moebius transform kernel for Hopper: wrapper of ``csrc/zeta.cu``.

Replaces ``repro/kernels/zeta_pallas.py``: ``_local_kernel`` (launched by
``_local_pass``) and ``_pair_kernel`` (launched by ``_pair_pass``), with
the ``zeta_pallas`` host contract (leading axes fold into the row axis,
butterflies never cross a 2^n element).

A transform over n bits is one ``zeta_local`` launch (the low
b = min(n, 12) bits of every 2^b tile, in shared memory) and n - b
``zeta_pair`` launches (one bit each, in place).  Both are bound by
memory: the whole transform moves 8 bytes per element at best (read
once, write once); the pair stages each read the table again.  Unlike
the TPU kernel there is no fallback below n = 11: every n launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.zeta import lattice_bits
from repro_torch.kernels import build

TILE_BITS = 12


def launch_local(x: torch.Tensor, out: torch.Tensor, tile_bits: int,
                 sign: int) -> None:
    """One ``zeta_local`` launch: low ``tile_bits`` bits of ``x`` into
    ``out`` (same shape, contiguous, on the card)."""
    lib = build.library()
    err = lib.repro_zeta_local(
        x.data_ptr(), out.data_ptr(), x.numel(), tile_bits, sign,
        build.dtype_code(x), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "zeta_local")
    build.count_launch("zeta_local")


def launch_pair(x: torch.Tensor, bit: int, sign: int) -> None:
    """One ``zeta_pair`` launch: butterfly stage ``bit``, in place."""
    lib = build.library()
    err = lib.repro_zeta_pair(
        x.data_ptr(), x.numel(), bit, sign, build.dtype_code(x),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "zeta_pair")
    build.count_launch("zeta_pair")


def zeta_cuda(f: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Zeta (or Moebius, ``inverse=True``) over the last axis of a CUDA
    tensor of int32 or float32; returns a new tensor."""
    if f.device.type != "cuda":
        raise ValueError("zeta_cuda takes a CUDA tensor")
    build.dtype_code(f)
    n = lattice_bits(f.shape[-1])
    f = f.contiguous()
    out = torch.empty_like(f)
    if f.numel() == 0:
        return out
    sign = -1 if inverse else 1
    b = min(n, TILE_BITS)
    launch_local(f, out, b, sign)
    for j in range(b, n):
        launch_pair(out, j, sign)
    return out
