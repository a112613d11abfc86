"""Exact plans answered within the window, per second of it: the plan
service held at its clients' load, so its capacity."""
from pbench import readers


def read(run):
    return readers.plans_per_s(run)
