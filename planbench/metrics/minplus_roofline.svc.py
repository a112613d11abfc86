"""The (min,+) sweep kernel's share of its roofline, %, in the plan
service's cells (the arithmetic: ``minplus_roofline.cap.py``)."""
from pbench import registry

_SWEEP = registry._module("metrics", "minplus_roofline.cap")


def read(run):
    return _SWEEP.roofline_pct(run)
