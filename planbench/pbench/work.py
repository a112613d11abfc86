"""The yardstick of the lattice programs' work, and the chip's peaks.

``program_work`` is a frozen copy of the port's work model of one
whole-solve program call (``repro_torch.core.engine.program_work`` as of
the benchmark's first version): operations and bytes from the call's
shapes and its search rounds, each input of a step read once and each
output written once.  It counts the work the solve needs, so it reads
the same whatever implements it (fused kernels, a CUDA graph, fewer
launches); only a change of the algorithm's own steps would change it,
and that needs a new version here, not an edit.

``least_time`` is the larger of the two bounds of one call: operations
over the peak of the tier's arithmetic, bytes over the memory rate.  A
feasibility pass (the ``max`` programs, and pass 1 of ``cap``) does well
under one operation per byte (about 0.4), far below the ridge point (10
to 20 operations a byte), so bytes bound it; the (min,+) sweep of an
``out`` program does some 20 operations a byte, so operations bound it.
The peaks are the data sheet's largest for the arithmetic (a 32-bit
integer add counted at the float32 rate, a float64 add or min at the
float64 rate), so a share of the bound never reads high.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12        # CUDA cores, counted at the float32 rate
F64_OPS_PER_S = 34e12          # CUDA cores, float64 (no tensor cores)


def program_work(n: int, B: int, C: int, cost: str, tier: str,
                 gamma_batch: int, rounds: int, extract: bool,
                 direct_layers: int = 4) -> tuple:
    """``(operations, bytes)`` of one program call of ``B`` rows at
    lattice size ``n`` with ``C`` candidate columns, ``rounds`` search
    rounds, ``cost`` one of ``max``/``cap``/``cap_conn``/``out`` (with an
    optional ``_seeded`` suffix) and ``tier`` ``cuda`` (int32 tables) or
    ``f64``:

    * a zeta/Moebius transform of a (rows, 2^n) table: rows 2^(n-1) n
      adds, its table read and written once;
    * a feasibility pass: a zeta for each direct layer 2..dl, then for
      each middle layer the scan-form convolution (3 operations per slot
      and cell over n // 2 slots, the ranked buffer read, the layer
      written), a Moebius and a zeta; the final layer one more
      convolution (and a Moebius with the extraction table).  A search
      round runs one over B G rows, the seed verification over 2B, the
      extraction over B; direct-layer gathers add 2 sum_k C(n,k) 2^k;
    * a (min,+) sweep: 2 operations per split (add, min), 3 with the
      connectivity mask, over sum_k C(n,k) 2^k splits per row; its
      tables read and the value table written once;
    * the extraction scan: 2n - 1 slots, 8 operations per cell and slot;
    * the program's own inputs and outputs, once.
    """
    N = 1 << n
    seeded = cost.endswith("_seeded")
    base = cost[:-len("_seeded")] if seeded else cost
    s = 4 if tier == "cuda" and base != "out" else 8
    dl = min(direct_layers, n - 1)
    D = max(n // 2, 1)
    mid = max(n - 1 - dl, 0)
    direct = sum(math.comb(n, k) << k for k in range(2, dl + 1))

    def feas(rows: int, full: bool) -> tuple:
        t = max(dl - 1, 0) + 2 * mid + (1 if full else 0)
        ops = rows * (t * (N // 2) * n + (mid + 1) * 3 * D * N
                      + 2 * direct)
        nbytes = rows * s * N * (2 * t + (mid + 1) * (n + 2))
        return ops, nbytes

    ops = nbytes = 0
    if base in ("max", "cap", "cap_conn"):
        search = rounds - (1 if seeded and rounds else 0)
        for rows, k, full in ((B * gamma_batch, search, False),
                              (2 * B, 1 if seeded and rounds else 0,
                               False),
                              (B, 1 if extract and base == "max" else 0,
                               True)):
            o, b = feas(rows, full)
            ops += k * o
            nbytes += k * b
        nbytes += 8 * B * (N + C + 2)            # cards, cand, lo0, hi0
    if base in ("cap", "cap_conn", "out"):
        splits = sum(math.comb(n, k) << k for k in range(2, n + 1))
        conn = base != "cap"
        ops += B * splits * (3 if conn else 2)
        nbytes += B * N * (8 + (1 if conn else 0) + 8)
        if base == "out":
            nbytes += 8 * B * N                  # cards
            if seeded:
                nbytes += 9 * B * N              # seed values and mask
    if extract:
        ops += B * (2 * n - 1) * 8 * N
        nbytes += 8 * B * N + 2 * 4 * B * (2 * n - 1)   # dp; nodes, lidx
    nbytes += 8 * B * (2 if base in ("cap", "cap_conn") else 1)  # optima
    return float(ops), float(nbytes)


def least_time(n: int, B: int, C: int, cost: str, tier: str,
               gamma_batch: int, rounds: int, extract: bool,
               direct_layers: int = 4) -> tuple:
    """``(seconds, bound)``: the least time of one program call on the
    chip, the larger of its operations over the tier's peak and its
    bytes over the memory rate, and which of the two (``ops`` or
    ``bytes``) it is."""
    ops, nbytes = program_work(n, B, C, cost, tier, gamma_batch, rounds,
                               extract, direct_layers)
    base = cost.split("_")[0]
    peak = INT32_OPS_PER_S if tier == "cuda" and base == "max" \
        else F64_OPS_PER_S
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops > t_bytes else (t_bytes, "bytes")
