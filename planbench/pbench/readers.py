"""The arithmetic of the metric readers under ``metrics/``.  Each reader
is ``read(run) -> float | None``; None means the run had nothing to read
and the metric is left out of the result line."""
from __future__ import annotations

from pbench import stats, work


def latency_percentile(run, p: float):
    return stats.percentile([o.latency * 1e3 for o in run.outcomes], p)


def plans_per_s(run) -> float:
    """Exact plans answered within the window, over its seconds.  A
    request in flight when the window closes counts for the share of its
    time that lay inside the window, so the rate is all the work of all
    the window's time, not a count of whole plans."""
    end = run.notes.get("window_end", run.seconds)
    done = 0.0
    for o in run.outcomes:
        if not o.answered:
            continue
        if o.done <= end:
            done += 1.0
        elif o.due < end:
            done += (end - o.due) / (o.done - o.due)
    return done / run.seconds


def queue_wait_ms_p95(run):
    return stats.percentile([o.queue_wait * 1e3 for o in run.outcomes
                             if o.queue_wait is not None], 95)


def batch_occupancy(run):
    batches = run.delta(run.rt_before, run.rt_after, "batches")
    if not batches:
        return None
    return run.delta(run.rt_before, run.rt_after, "batched_items") / batches


def _queries(run) -> int:
    return run.delta(run.eng_before, run.eng_after, "queries")


def execute_ms_per_query(run):
    q = _queries(run)
    if not q or run.dispatches is None:
        return None
    return 1e3 * sum(r.execute_s for r in run.dispatches.records) / q


def lattice_roofline_pct(run):
    """The lattice programs' least time (the frozen work model's bound of
    each call of the window, with its own rows and rounds) as a share of
    the window's device kernel time."""
    if run.dispatches is None or not run.dispatches.records:
        return None
    kernel_s = run.devtrace.kernel_s
    if kernel_s <= 0:
        return None
    G = int(run.config["batch_policy"].get("gamma_batch", 1))
    least = sum(work.least_time(r.n, r.B, r.C, r.cost, r.backend, G,
                                r.rounds, True)[0]
                for r in run.dispatches.records)
    return 100.0 * least / kernel_s


def idle_pct(run):
    dt = run.devtrace
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)


def launches_per_query(run):
    q = _queries(run)
    if not q or run.devtrace is None:
        return None
    return run.devtrace.launches / q
