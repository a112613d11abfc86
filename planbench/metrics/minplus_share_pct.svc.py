"""The (min,+) sweep kernel's share of the window's device kernel time
in the plan service's cells, % (``minplus_roofline.cap.py``); None where
the trace holds no such kernel."""
from pbench import registry

_SWEEP = registry._module("metrics", "minplus_roofline.cap")


def read(run):
    return _SWEEP.share_pct(run)
