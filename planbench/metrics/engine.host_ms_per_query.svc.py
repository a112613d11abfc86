"""The engine's host time around the window's program calls (prep and
uploads, readback, join trees), per query they solved, ms."""
from pbench import spans


def read(run):
    return spans.engine_host_ms_per_query(run)
