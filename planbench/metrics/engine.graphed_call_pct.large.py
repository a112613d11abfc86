"""Share of the window's program calls (the engine's dispatch records)
that replayed the program's CUDA graphs, %.  None where the records
carry no ``graphed`` flag (a program without CUDA graphs)."""


def read(run):
    if run.dispatches is None or not run.dispatches.records:
        return None
    flags = [getattr(r, "graphed", None) for r in run.dispatches.records]
    if any(f is None for f in flags):
        return None
    return 100.0 * sum(1 for f in flags if f) / len(flags)
