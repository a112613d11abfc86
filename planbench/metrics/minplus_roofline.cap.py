"""The (min,+) sweep kernel's share of its roofline, %: the least time
of the window's sweeps over the kernel's device time in the window.

The work of one program call's sweep, counted here and not in the frozen
``pbench/work.py``: 2 operations (an add and a min) per split over all
(2^(k-1) - 1) C(n,k) splits of layers k = 2..n, gate or no gate, and per
row the cardinalities, the gate (and the connectivity mask of a
connected sweep) read once and the value table read once and written
once.  Least time = max(operations / the float64 peak, bytes / the
memory rate), summed over the window's dispatch records whose program
sweeps (``cap``, ``cap_conn``, ``out``, seeded or not).  The kernel's
device time is the trace's time in kernels named
``minplus_layer_kernel``.  None where the trace holds no such kernel (a
program without it) or the window made no record.
"""
import math

from pbench import work

KERNEL = "minplus_layer_kernel"
SWEEPS = ("cap", "cap_conn", "out")


def sweep_work(n: int, B: int, cost: str) -> tuple:
    """``(operations, bytes)`` of the sweep of one program call of ``B``
    rows at lattice size ``n``; (0, 0) for a program without one."""
    base = cost[:-len("_seeded")] if cost.endswith("_seeded") else cost
    if base not in SWEEPS:
        return 0.0, 0.0
    splits = sum(math.comb(n, k) * ((1 << (k - 1)) - 1)
                 for k in range(2, n + 1))
    per_set = 8 + 1 + (1 if base != "cap" else 0) + 8 + 8
    return float(2 * B * splits), float(B * (1 << n) * per_set)


def least_s(n: int, B: int, cost: str) -> float:
    ops, nbytes = sweep_work(n, B, cost)
    return max(ops / work.F64_OPS_PER_S, nbytes / work.HBM_BYTES_PER_S)


def kernel_s(run):
    """The device time of the sweep kernel in the window, or None."""
    dt = run.devtrace
    if dt is None:
        return None
    t = sum(b - a for a, b, name, k in dt.ops if k and KERNEL in name)
    return t if t > 0 else None


def roofline_pct(run):
    t = kernel_s(run)
    if t is None or run.dispatches is None or not run.dispatches.records:
        return None
    least = sum(least_s(r.n, r.B, r.cost) for r in run.dispatches.records)
    return 100.0 * least / t


def share_pct(run):
    """The sweep kernel's share of the window's device kernel time."""
    t = kernel_s(run)
    if t is None or run.devtrace.kernel_s <= 0:
        return None
    return 100.0 * t / run.devtrace.kernel_s


def read(run):
    return roofline_pct(run)
