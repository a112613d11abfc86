"""Share of the (min,+) sweep's sets that its gate let through, %: the
window's dispatch records' ``sweep_sets`` (sets of layers 2..n, over the
rows, that passed c(S) <= slack * gamma*, counted on the device) over
their ``sweep_total`` (all the sets of those layers times the rows).
None where the records carry no such fields (a program without them) or
no record swept."""


def read(run):
    if run.dispatches is None or not run.dispatches.records:
        return None
    live = total = 0
    for r in run.dispatches.records:
        t = getattr(r, "sweep_total", None)
        s = getattr(r, "sweep_sets", None)
        if t is None or s is None:
            return None
        live += s
        total += t
    return 100.0 * live / total if total else None
