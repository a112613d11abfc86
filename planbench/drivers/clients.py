"""Closed loop of K clients: ``clients`` planner sessions each hand the
plan service's wall-clock runtime (``submit``/``poll``, the worker-thread
executor that ``plan_async`` drives) one query and send their next when
its answer is delivered, so the service always holds K requests and the
window measures the plans it answers at that load.  A request's latency
runs from send to delivery.

At the window's close the clients stop sending; the requests still in
flight are awaited for up to ``LATE_S`` seconds (one that never comes
counts as failed) and count for the share of their time that lay inside
the window.  The counters and the trace are read once they are in, so
that reading a trace delays no delivery: a traced window runs on by that
wait.
"""
from __future__ import annotations

import time

from pbench import program
from pbench.runstate import Outcome

LATE_S = 60.0
POLL_S = 1e-3          # longest sleep between two polls of the runtime
READ_S = 0.25          # how often a traced run reads the dispatch ring
PREFILL_PER_S = 40.0   # queries made in set-up per second of window


def _wait(rt, t_deadline: float) -> float:
    nxt = rt.next_event_time()
    t = t_deadline if nxt is None else min(t_deadline, nxt)
    return min(max(t - rt.clock.now(), 0.0), POLL_S)


def _settle(o: Outcome, ticket, t0: float) -> None:
    """Fill ``o`` from its delivered ticket."""
    if not ticket.refused and ticket.response is not None:
        resp = ticket.response
        o.done = ticket.completed_at - t0
        o.status = resp.status
        o.cost = float(resp.cost)
        o.tree = program.tree_tuple(resp.tree)
    else:
        o.status = "error"
    qw = ticket.spans.get("queue_wait")
    if qw is not None and qw.t1 is not None:
        o.queue_wait = qw.duration


def drive(run) -> None:
    srv = program.make_server(run.config, run.device)
    rt = program.make_runtime(srv, run.trace)
    run.system = program.System(server=srv, runtime=rt)
    run.notes["prewarm"] = program.prewarm(srv, run.mix["classes"])
    run.mark("prewarm")
    k = int(run.mix["clients"])
    more = run.traffic.more
    queue = [next(more) for _ in range(int(PREFILL_PER_S * run.seconds)
                                       + k)]
    plans = [program.plan_request(r) for r in queue]
    run.notes["made_in_window"] = 0
    clock = rt.clock
    live = []                       # (outcome, ticket) in flight
    sent = 0

    def send(t0: float) -> None:
        nonlocal sent
        if sent < len(queue):
            req, plan = queue[sent], plans[sent]
        else:
            req = next(more)
            plan = program.plan_request(req)
            run.notes["made_in_window"] += 1
        sent += 1
        o = Outcome(req=req, due=clock.now() - t0)
        live.append((o, rt.submit(plan)))
        run.outcomes.append(o)

    run.open_window()
    t0 = clock.now()
    end = t0 + run.seconds
    for _ in range(k):
        send(t0)
    next_read = t0 + READ_S
    late_end = end + LATE_S
    while live:
        rt.poll()
        now = clock.now()
        done = [x for x in live if x[1].done]
        if done:
            live[:] = [x for x in live if not x[1].done]
            for o, ticket in done:
                _settle(o, ticket, t0)
                if now < end:
                    send(t0)
        if run.trace and now >= next_read:
            run.dispatches.read()
            next_read = now + READ_S
        if now >= late_end:
            break
        time.sleep(_wait(rt, end if now < end else late_end))
    run.notes["drain_s"] = clock.now() - end
    run.close_window()
    run.notes["window_end"] = run.seconds
    run.notes["unfinished"] = len(live)
