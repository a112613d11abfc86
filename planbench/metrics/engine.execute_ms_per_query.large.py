"""Engine execute time of the window's dispatches per query they solved, ms."""
from pbench import readers


def read(run):
    return readers.execute_ms_per_query(run)
