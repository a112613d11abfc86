"""The program's own host spans and the host split of its dispatch
records, read over a traced run's window.

The program keeps a process-wide span log (``repro_torch.obs.trace
.SPAN_LOG``), filled while a ``torch.profiler`` session is active: each
closed span as ``(name, request id, parent name, t0_ns, t1_ns, thread
name)`` on ``time.time_ns()``'s clock, the clock the device trace's
window (``run.devtrace.t0_ns``/``t1_ns``) is taken on.  Its dispatch
records carry ``queries``, ``prepare_s``, ``launch_s``, ``sync_s``,
``readback_s``, ``trees_s`` and the call's ``t0_ns``/``t1_ns`` on the
same clock.

Every reader returns None where there is nothing to read: an untraced
run, a program without the span log or without those record fields, a
window with no such span, or a log that dropped an entry of the window.

Only ``program.py`` imports the program; the log is taken from the
module it loaded (``sys.modules``), never imported here.
"""
from __future__ import annotations

import sys

from pbench import stats

TRACE_MODULE = "repro_torch.obs.trace"

HOST_FIELDS = ("queries", "prepare_s", "launch_s", "sync_s", "readback_s",
               "trees_s", "t0_ns", "t1_ns")
# the front end's own phases, each a host span of one request; admit
# holds its canonicalize, probe and route
FRONT_END = ("admit", "seed", "extract", "respond")


def log_window(run) -> "list | None":
    """The span log's entries that lie inside the traced window."""
    dt = run.devtrace
    if dt is None or dt.t1_ns <= dt.t0_ns:
        return None
    log = getattr(sys.modules.get(TRACE_MODULE), "SPAN_LOG", None)
    if log is None:
        return None
    return log.window(dt.t0_ns, dt.t1_ns)


def durations_ms(entries, names) -> list:
    return [(e[4] - e[3]) * 1e-6 for e in entries if e[0] in names]


def records(run) -> "list | None":
    """The window's dispatch records, where they carry the host split."""
    if run.dispatches is None or not run.dispatches.records:
        return None
    recs = run.dispatches.records
    if not all(hasattr(r, f) for r in recs[:1] for f in HOST_FIELDS):
        return None
    return recs


def per_query_ms(recs, seconds) -> "float | None":
    q = sum(r.queries for r in recs)
    return 1e3 * seconds / q if q else None


def span_p50_ms(run, name: str) -> "float | None":
    entries = log_window(run)
    if entries is None:
        return None
    return stats.percentile(durations_ms(entries, (name,)), 50)


def launch_ms_per_query(run) -> "float | None":
    recs = records(run)
    if recs is None:
        return None
    return per_query_ms(recs, sum(r.launch_s for r in recs))


def engine_host_ms_per_query(run) -> "float | None":
    recs = records(run)
    if recs is None:
        return None
    return per_query_ms(recs, sum(r.prepare_s + r.readback_s + r.trees_s
                                  for r in recs))


def front_end_ms_per_query(run) -> "float | None":
    recs, entries = records(run), log_window(run)
    if recs is None or entries is None:
        return None
    ms = durations_ms(entries, FRONT_END)
    if not ms:
        return None
    return per_query_ms(recs, 1e-3 * sum(ms))


def idle_outside_solve_pct(run) -> "float | None":
    """The share of the device's idle time in the window that lies
    outside every dispatch record's program call."""
    recs, dt = records(run), run.devtrace
    if recs is None or dt is None or dt.window_s <= 0:
        return None
    w = dt.window_s
    busy = [(a, b) for a, b, _, _ in dt.ops]
    calls = [(max(0.0, (r.t0_ns - dt.t0_ns) * 1e-9),
              min(w, (r.t1_ns - dt.t0_ns) * 1e-9)) for r in recs]
    calls = [(a, b) for a, b in calls if b > a]
    idle = w - stats.union_length(busy)
    if idle <= 0:
        return None
    outside = w - stats.union_length(busy + calls)
    return 100.0 * outside / idle
