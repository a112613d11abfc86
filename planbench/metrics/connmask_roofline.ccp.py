"""The connected-subset mask kernel's share of its roofline, %: the
least time of the masks the window's connected programs built over the
kernel's device time in the window.

The work of one call of a connected program (``out`` or ``cap_conn``,
seeded or not), counted here: its ``B`` rows' masks written once, one
byte a set (``B * 2^n``), and their adjacency read once, ``n`` int32
bitmasks a row (``4 * B * n``); no arithmetic counts.  Least time =
bytes / the memory rate, summed over the window's dispatch records of
those costs.  The kernel's device time is the trace's time in kernels
named ``connmask_kernel``.  None where the trace holds no such kernel (a
program that builds the masks on the host) or the window made no
connected record.
"""
from pbench import work

KERNEL = "connmask_kernel"
CONNECTED = ("out", "cap_conn")


def mask_bytes(n: int, B: int) -> float:
    """Bytes of one call's masks: written once, adjacency read once."""
    return float(B * (1 << n) + 4 * B * n)


def kernel_s(run):
    """The device time of the mask kernel in the window, or None."""
    dt = run.devtrace
    if dt is None:
        return None
    t = sum(b - a for a, b, name, k in dt.ops if k and KERNEL in name)
    return t if t > 0 else None


def read(run):
    t = kernel_s(run)
    if t is None or run.dispatches is None:
        return None
    least = sum(mask_bytes(r.n, r.B) / work.HBM_BYTES_PER_S
                for r in run.dispatches.records
                if r.cost.replace("_seeded", "") in CONNECTED)
    return 100.0 * least / t if least > 0 else None
