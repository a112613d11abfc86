"""Host time inside the window's program calls not blocked on the
device (the launch loop), per query they solved, ms."""
from pbench import spans


def read(run):
    return spans.launch_ms_per_query(run)
