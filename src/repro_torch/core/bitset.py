"""Subset-lattice utilities shared by every DP algorithm in the core.

Sets of relations are encoded as bitmasks (Python ints / numpy int64 /
jnp int64).  The full lattice over ``n`` relations is the dense array index
range ``[0, 2**n)``.

A copy of ``repro.core.bitset`` (numpy only): the port never imports
``repro``, whose ``core`` package turns on JAX at import.  Keep the two
in step; ``tests/test_torch_*.py`` hold them equal.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def popcounts(n: int) -> np.ndarray:
    """popcounts(n)[S] == |S| for every S in [0, 2**n).  Cached per n."""
    size = 1 << n
    pc = np.zeros(size, dtype=np.int32)
    for j in range(n):
        bit = 1 << j
        pc[bit : 2 * bit] = pc[:bit] + 1
        # doubling: pc[0:2^(j+1)] correct after this step
    # The doubling above fills progressively: after j, prefix of length 2^(j+1)
    return pc


@functools.lru_cache(maxsize=64)
def layer_indices(n: int) -> tuple:
    """layer_indices(n)[k] = sorted int64 array of all masks with popcount k."""
    pc = popcounts(n)
    return tuple(
        np.nonzero(pc == k)[0].astype(np.int64) for k in range(n + 1)
    )


def lattice_map(targets) -> np.ndarray:
    """(2^r,) int64 map ``m`` with ``m[S]`` = OR of ``targets[i]`` over the
    bits ``i`` of ``S``, for ``r = len(targets)``.

    Built by bit doubling: ``m[2^i : 2^(i+1)] = m[:2^i] | targets[i]``, so
    2^r writes in all.  ``targets[i] = 1 << perm[i]`` gives a relabeling
    map, ``1 << rels[i]`` a compact-to-outer subset map.
    """
    m = np.zeros(1 << len(targets), np.int64)
    for i, t in enumerate(targets):
        half = 1 << i
        np.bitwise_or(m[:half], int(t), out=m[half:2 * half])
    return m


def bits_of(mask: int) -> list[int]:
    """Positions of the set bits of ``mask`` (ascending)."""
    out = []
    j = 0
    m = int(mask)
    while m:
        if m & 1:
            out.append(j)
        m >>= 1
        j += 1
    return out


def submasks(mask: int) -> np.ndarray:
    """All 2^|mask| submasks of ``mask`` (including 0 and mask itself).

    Vectorized bit-deposit: enumerate all 0/1 patterns over the set bits.
    """
    bits = bits_of(mask)
    k = len(bits)
    if k == 0:
        return np.zeros(1, dtype=np.int64)
    vals = np.array([1 << b for b in bits], dtype=np.int64)
    patt = ((np.arange(1 << k, dtype=np.int64)[:, None] >> np.arange(k)) & 1)
    return patt @ vals


def submask_table(masks: np.ndarray, k: int) -> np.ndarray:
    """For an array of masks each with popcount ``k``: (2^k, len(masks))
    matrix whose column j enumerates all submasks of masks[j].

    This is the grouped bit-deposit trick that lets DPsub process a whole
    popcount layer with a single matmul instead of a per-set Python loop.
    """
    m = masks.astype(np.int64)
    cnt = len(m)
    # bit positions per mask: (cnt, k)
    bitvals = np.zeros((cnt, k), dtype=np.int64)
    for j, mask in enumerate(m):
        bs = bits_of(int(mask))
        bitvals[j] = [1 << b for b in bs]
    patt = ((np.arange(1 << k, dtype=np.int64)[:, None] >> np.arange(k)) & 1)
    return patt @ bitvals.T  # (2^k, cnt)


def popcount_int(mask: int) -> int:
    return bin(int(mask)).count("1")
