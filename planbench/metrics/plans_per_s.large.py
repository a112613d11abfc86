"""Exact plans of large queries answered within the window, per second
of it (one client: one over the mean wall time of a plan)."""
from pbench import readers


def read(run):
    return readers.plans_per_s(run)
