"""The readers of the program's host spans and of its dispatch records'
host split (``pbench/spans.py``): on a traced CPU run of each cell, and
their arithmetic on made-up windows, including a program that keeps
neither (every reader then reads None and raises nothing)."""
import math
import types

import pytest

from _planbench_util import run_small

from pbench import spans
from repro_torch.obs import trace

NEW = {
    "plansvc.fresh": ("runtime.lane_wait_ms_p50",
                      "engine.launch_ms_per_query.svc",
                      "engine.host_ms_per_query.svc",
                      "server.host_ms_per_query.svc",
                      "device.idle_outside_solve_pct.svc"),
    "plansvc.bigjoin": ("engine.launch_ms_per_query.large",
                        "engine.host_ms_per_query.large",
                        "server.host_ms_per_query.large",
                        "device.idle_outside_solve_pct.large"),
}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_run_reports_every_new_metric(workload):
    rc, res, err = run_small(workload, trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    m = res["metrics"]
    for name in NEW[workload]:
        assert name in m, name
        assert math.isfinite(m[name]["value"]) and m[name]["value"] >= 0
    pct = m[NEW[workload][-1]]["value"]
    assert 0.0 <= pct <= 100.0
    ex = m["engine.execute_ms_per_query." + workload.split(".")[1]
           .replace("fresh", "svc").replace("bigjoin", "large")]["value"]
    launch = m[NEW[workload][-4]]["value"]
    assert launch <= ex + 1e-9          # launch_s is a part of execute_s
    if workload == "plansvc.fresh":
        assert m["runtime.lane_wait_ms_p50"]["value"] \
            <= m["runtime.latency_ms_p50"]["value"]


# ------------------------------------------------------- made-up windows
def _rec(t0_ns, t1_ns, queries=2, launch=0.5, prep=0.1, back=0.05,
         trees=0.05):
    return types.SimpleNamespace(queries=queries, prepare_s=prep,
                                 launch_s=launch, sync_s=0.2,
                                 readback_s=back, trees_s=trees,
                                 t0_ns=t0_ns, t1_ns=t1_ns)


def _run(recs, ops=(), t0_ns=10 ** 9, window_s=10.0):
    dt = types.SimpleNamespace(t0_ns=t0_ns,
                               t1_ns=t0_ns + int(window_s * 1e9),
                               window_s=window_s, ops=list(ops))
    return types.SimpleNamespace(
        devtrace=dt, dispatches=types.SimpleNamespace(records=recs))


def test_idle_outside_solve_is_a_share_of_idle_time():
    s = 10 ** 9
    # device busy 1..2 s and 5..6 s; calls cover 0.5..3 s and 4..6 s
    ops = [(1.0, 2.0, "k", True), (5.0, 6.0, "k", True)]
    recs = [_rec(s + s // 2, 4 * s), _rec(5 * s, 7 * s)]
    # idle 8 s; outside the calls and the busy time: 0..0.5, 3..4, 6..10
    assert spans.idle_outside_solve_pct(_run(recs, ops)) == \
        pytest.approx(100.0 * 5.5 / 8.0)


def test_per_query_sums_over_the_window_records():
    recs = [_rec(0, 1, queries=1, launch=0.2), _rec(0, 1, queries=3,
                                                    launch=0.6)]
    run = _run(recs)
    assert spans.launch_ms_per_query(run) == pytest.approx(200.0)
    # prep, readback and trees: 0.2 s a record over 4 queries
    assert spans.engine_host_ms_per_query(run) == pytest.approx(100.0)


def test_span_log_window_reads_and_refuses_a_lossy_window():
    log = trace.SpanLog(capacity=4)
    for i in range(3):
        log.append("lane_wait", i, "request", 100 + 10 * i, 105 + 10 * i)
    assert [e[1] for e in log.window(100, 200)] == [0, 1, 2]
    assert [e[1] for e in log.window(105, 200)] == [1, 2]
    log.append("seed", 3, "request", 140, 141)
    log.append("seed", 4, "request", 150, 151)    # drops entry 0
    assert log.dropped == 1 and log.last_dropped_ns == 105
    assert log.window(100, 200) is None
    assert [e[1] for e in log.window(106, 200)] == [1, 2, 3, 4]


def test_readers_read_span_log_over_the_trace_window(monkeypatch):
    log = trace.SpanLog()
    monkeypatch.setattr(trace, "SPAN_LOG", log)
    s = 10 ** 9
    for i, (a, b) in enumerate([(1.0, 1.5), (2.0, 2.1), (3.0, 4.0)]):
        log.append("lane_wait", i, "request", s + int(a * s),
                   s + int(b * s))
        log.append("admit", i, "request", s + int(a * s),
                   s + int(a * s) + 10 ** 6)
    log.append("lane_wait", 9, "request", 0, 10)   # before the window
    run = _run([_rec(0, 1, queries=3)])
    assert spans.span_p50_ms(run, "lane_wait") == pytest.approx(500.0)
    assert spans.front_end_ms_per_query(run) == pytest.approx(1.0)
    assert spans.span_p50_ms(run, "dispatch") is None


def test_readers_read_none_where_the_program_keeps_nothing(monkeypatch):
    old = _run([types.SimpleNamespace(execute_s=1.0, B=1)])
    for fn in (spans.launch_ms_per_query, spans.engine_host_ms_per_query,
               spans.front_end_ms_per_query, spans.idle_outside_solve_pct):
        assert fn(old) is None
    monkeypatch.delattr(trace, "SPAN_LOG")
    assert spans.span_p50_ms(_run([]), "lane_wait") is None
    assert spans.front_end_ms_per_query(_run([_rec(0, 1)])) is None
    untraced = types.SimpleNamespace(devtrace=None, dispatches=None)
    assert spans.span_p50_ms(untraced, "lane_wait") is None
    assert spans.idle_outside_solve_pct(untraced) is None
