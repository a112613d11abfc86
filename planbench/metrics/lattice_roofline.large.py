"""The lattice programs' share of their bytes roofline over the window's device kernel time, %."""
from pbench import readers


def read(run):
    return readers.lattice_roofline_pct(run)
