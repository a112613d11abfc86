"""95th percentile of the runtime's queue_wait spans in the window, ms."""
from pbench import readers


def read(run):
    return readers.queue_wait_ms_p95(run)
