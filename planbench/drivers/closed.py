"""Closed loop: one client hands the plan service one query at a time
through ``PlanServer.plan_one`` and sends the next when the answer is
back, as an optimizer process planning the queries it is given does.  A
request's latency runs from send to answer.  The request in flight when
the window closes is finished, and counts for the share of its time that
lay inside the window.
"""
from __future__ import annotations

import time

from pbench import program
from pbench.runstate import Outcome

PREFILL_PER_S = 5.0     # queries made in set-up per second of window


def drive(run) -> None:
    srv = program.make_server(run.config, run.device)
    run.system = program.System(server=srv)
    run.notes["prewarm"] = program.prewarm(srv, run.mix["classes"])
    run.mark("prewarm")
    more = run.traffic.more
    queue = [next(more) for _ in range(int(PREFILL_PER_S * run.seconds) + 4)]
    run.notes["made_in_window"] = 0
    t0 = run.open_window()
    end = t0 + run.seconds
    j = 0
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if j < len(queue):
            req = queue[j]
        else:
            req = next(more)
            run.notes["made_in_window"] += 1
        j += 1
        o = Outcome(req=req, due=time.perf_counter() - t0)
        resp = program.plan_one(srv, req)
        o.done = time.perf_counter() - t0
        o.status = resp.status
        o.cost = float(resp.cost)
        o.tree = program.tree_tuple(resp.tree)
        run.outcomes.append(o)
        if run.trace:
            run.dispatches.read()
    run.close_window()
    run.notes["window_end"] = run.seconds
