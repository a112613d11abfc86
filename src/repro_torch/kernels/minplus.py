"""The (min,+) layer sweep kernel for Hopper: wrapper of
``csrc/minplus.cu``.

One ``minplus_layer`` launch evaluates one layer k of the float64
(min,+) recursion of ``core.lattice`` over every row of a (rows, 2^n)
value table, in place: the C_cap pass 2 (``minplus_value_layers``) and
the connected C_out sweep (``minplus_connected_layers``), seeded or not;
a connected sweep also counts its valid splits (#ccp) on the card.
A group of lanes takes one (row, set), skips it when the gate is off
and otherwise enumerates the set's splits by bit deposit, so no split
table exists; the sets of a layer are a slice of one int32 list of the
2^n masks ordered by popcount (``layer_sets``).  Values are bitwise
those of the gather sweep, which stays the plain version on CPU
tensors.  Every layer k >= 2 launches on a CUDA tensor.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.bitset import layer_indices
from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def layer_offsets(n: int) -> tuple:
    """``offsets[k]``: where layer k's sets begin in ``layer_sets(n)``
    (``offsets[n + 1] = 2^n``)."""
    out = [0]
    for k in range(n + 1):
        out.append(out[-1] + math.comb(n, k))
    return tuple(out)


def layer_sets(n: int) -> np.ndarray:
    """The 2^n masks of an n-relation lattice ordered by popcount (layer
    by layer, ascending within a layer), int32."""
    return np.concatenate(layer_indices(n)).astype(np.int32)


def _ptr(t: "torch.Tensor | None") -> "int | None":
    return None if t is None else t.data_ptr()


def minplus_layer(dp: torch.Tensor, card: torch.Tensor, ok: torch.Tensor,
                  sets: torch.Tensor, n: int, k: int,
                  conn: "torch.Tensor | None" = None,
                  seed_vals: "torch.Tensor | None" = None,
                  seed_ok: "torch.Tensor | None" = None,
                  pairs: "torch.Tensor | None" = None) -> None:
    """Layer ``k`` of the sweep into ``dp`` (rows, 2^n) float64, in
    place, for the layer's ``sets`` (int32 masks of popcount ``k``, on
    the card): ``dp[S] = seed_vals[S]`` where ``seed_ok[S]``, +inf where
    ``ok[S]`` is off, else ``(min_T dp[T] + dp[S^T]) + card[S]`` over the
    splits T that hold S's lowest relation (and, with ``conn``, have
    both sides connected).  Every table is (rows, 2^n) and contiguous on
    ``dp``'s card; ``ok``/``conn``/``seed_ok`` are bool.  ``pairs`` (a
    one-element int64 tensor on that card, read only with ``conn``)
    gains the splits the layer found valid in the sets it evaluated,
    counted by the kernel."""
    if dp.device.type != "cuda":
        raise ValueError("minplus_layer takes CUDA tensors")
    rows = dp.numel() >> n
    for t in (dp, card, ok, conn, seed_vals, seed_ok):
        if t is not None and (t.shape != dp.shape or not t.is_contiguous()
                              or t.device != dp.device):
            raise ValueError("every table must be a contiguous tensor of "
                             f"dp's shape {tuple(dp.shape)} on its card")
    if dp.dtype != torch.float64 or card.dtype != torch.float64:
        raise TypeError("the (min,+) sweep runs in float64")
    if pairs is not None and (pairs.dtype != torch.int64
                              or pairs.numel() != 1
                              or pairs.device != dp.device):
        raise ValueError("pairs must be one int64 element on dp's card")
    err = build.library().repro_minplus_layer(
        dp.data_ptr(), card.data_ptr(), ok.data_ptr(), _ptr(conn),
        _ptr(seed_vals), _ptr(seed_ok), sets.data_ptr(), _ptr(pairs), rows,
        sets.numel(), n, k, dp.get_device(), build.current_stream(dp))
    build.check(err, "minplus_layer")
    build.count_launch("minplus_layer")
