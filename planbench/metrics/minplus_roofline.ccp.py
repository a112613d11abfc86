"""The (min,+) sweep kernel's share of its roofline on connected C_out,
%, counted by the work any DPccp does: the least time of the window's
``out`` sweeps over the kernel's device time in the window.

The work of one ``out`` program call's sweep, counted here: 2 operations
(an add and a min) per csg/cmp pair, the record's ``sweep_pairs`` (the
valid splits the sweep found, both halves connected: the #ccp of its
rows, counted on the device), and per row and set the cardinality (8
bytes), the connectivity mask (1), the value table read (8) and written
(8) once, with a seeded call's seed values (8) and flags (1).  Least
time = max(operations / the float64 peak, bytes / the memory rate),
summed over the window's records whose cost is ``out`` (seeded or not).
Every split a kernel tries and finds invalid is its own cost, not work:
the share does not rise when the kernel skips faster, only when it
wastes less.  The kernel's device time is the trace's time in kernels
named ``minplus_layer_kernel``.  None where the trace holds no such
kernel, the window made no ``out`` record, or the records carry no
``sweep_pairs`` (a program that does not count them).
"""
from pbench import work

KERNEL = "minplus_layer_kernel"


def ccp_work(n: int, B: int, pairs: int, seeded: bool) -> tuple:
    """``(operations, bytes)`` of one ``out`` call's sweep over ``B``
    rows at lattice size ``n`` that found ``pairs`` csg/cmp pairs."""
    per_set = 8 + 1 + 8 + 8 + (9 if seeded else 0)
    return float(2 * pairs), float(B * (1 << n) * per_set)


def least_s(n: int, B: int, pairs: int, seeded: bool) -> float:
    ops, nbytes = ccp_work(n, B, pairs, seeded)
    return max(ops / work.F64_OPS_PER_S, nbytes / work.HBM_BYTES_PER_S)


def kernel_s(run):
    """The device time of the sweep kernel in the window, or None."""
    dt = run.devtrace
    if dt is None:
        return None
    t = sum(b - a for a, b, name, k in dt.ops if k and KERNEL in name)
    return t if t > 0 else None


def read(run):
    t = kernel_s(run)
    if t is None or run.dispatches is None:
        return None
    recs = [r for r in run.dispatches.records
            if r.cost in ("out", "out_seeded")]
    if not recs:
        return None
    least = 0.0
    for r in recs:
        pairs = getattr(r, "sweep_pairs", None)
        if pairs is None:
            return None
        least += least_s(r.n, r.B, pairs, r.cost == "out_seeded")
    return 100.0 * least / t
