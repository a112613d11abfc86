"""Closed loop as ``closed`` (one client hands ``PlanServer.plan_one`` one
query at a time), for a deployment whose queries the card's engine
answers.  Before anything is built or timed, the server's router names
the engine that would answer each class of the mix at its largest n
(``Router.engine_tag``); a program that would hand a class to the host
pipeline does not run this deployment, and the run ends with exit code 4,
having measured nothing.
"""
from __future__ import annotations

import sys

from pbench import program

NOT_THIS_DEPLOYMENT = 4


def host_classes(srv, classes) -> list:
    """``(cost, n)`` of each class whose largest n the server's router
    would send to the host engine."""
    out = []
    for cls in classes:
        n = int(cls["n"][1])
        tag = srv.router.engine_tag("dpconv", n, cost=cls["cost"])
        if tag.split(":")[0] == "host":
            out.append((cls["cost"], n))
    return out


def drive(run) -> None:
    off_card = host_classes(program.make_server(run.config, run.device),
                            run.mix["classes"])
    if off_card:
        print(f"planbench: {run.cell['name']}: the program answers "
              f"{', '.join(f'{c} at n = {n}' for c, n in off_card)} on the "
              f"host, not on the card: it does not run configuration "
              f"{run.cell['config']}", file=sys.stderr)
        raise SystemExit(NOT_THIS_DEPLOYMENT)
    run.bench.driver("closed").drive(run)
