"""Median of the runtime's lane_wait spans in the window (hand-off to a
lane's executor until the lane begins the work), ms."""
from pbench import spans


def read(run):
    return spans.span_p50_ms(run, "lane_wait")
