"""Requests per batch the runtime formed in the window (RuntimeStats)."""
from pbench import readers


def read(run):
    return readers.batch_occupancy(run)
