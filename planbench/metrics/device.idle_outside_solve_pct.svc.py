"""Share of the device's idle time in the traced window that lies
outside every program call of the engine's dispatch records, %."""
from pbench import spans


def read(run):
    return spans.idle_outside_solve_pct(run)
