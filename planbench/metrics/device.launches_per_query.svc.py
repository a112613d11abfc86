"""Device kernel launches in the traced window per query the engine solved."""
from pbench import readers


def read(run):
    return readers.launches_per_query(run)
