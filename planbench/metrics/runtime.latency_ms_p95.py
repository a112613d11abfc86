"""95th percentile of the window's request latencies from send to
delivery, ms (a failed request reads infinite)."""
from pbench import readers


def read(run):
    return readers.latency_percentile(run, 95)
