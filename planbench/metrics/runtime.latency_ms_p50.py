"""Median of the window's request latencies from send to delivery, ms."""
from pbench import readers


def read(run):
    return readers.latency_percentile(run, 50)
