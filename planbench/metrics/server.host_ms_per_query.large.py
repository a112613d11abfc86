"""The front end's host spans in the window (admit with canonicalize,
probe and route; seed; extract; respond), per query solved, ms."""
from pbench import spans


def read(run):
    return spans.front_end_ms_per_query(run)
