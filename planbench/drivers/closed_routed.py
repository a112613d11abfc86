"""Closed loop as ``closed`` (one client hands ``PlanServer.plan_one`` one
query at a time), for a deployment whose queries the card's engine
answers, whatever method the router picks for them.  Before anything is
built or timed, one generated query of each class and topology of the
mix, at the class's largest n, goes through the server's router
(``Router.route``), and the router names the engine of the route it
gives (``Router.engine_tag``); a program that would hand one of them to
the host (or to no engine of the card) does not run this deployment, and
the run ends with exit code 4, having measured nothing.
"""
from __future__ import annotations

import sys

import numpy as np

from pbench import graphs, program

NOT_THIS_DEPLOYMENT = 4


class _Query:
    """A generated request in the shape ``program.plan_request`` reads."""

    def __init__(self, n: int, edges: tuple, card, cost: str):
        self.n, self.edges, self.card, self.cost = n, edges, card, cost
        self.i = 0


def probes(mix: dict, seed: int = 0) -> list:
    """``(cost, topology, n, query)`` for each class and topology of the
    mix, at the class's largest n (a grid at the largest grid size in
    the class's range)."""
    rng = np.random.default_rng(seed)
    out = []
    for cls in mix["classes"]:
        lo, hi = cls["n"]
        for topo in mix["topologies"]:
            n = hi
            if topo == "grid":
                shapes = graphs.grid_shapes(lo, hi)
                if not shapes:
                    continue
                n = max(r * c for r, c in shapes)
            edges = graphs.make_edges(topo, n, rng)
            card = graphs.cardinalities(n, edges, rng)
            out.append((cls["cost"], topo, n,
                        _Query(n, edges, card, cls["cost"])))
    return out


def host_classes(srv, mix: dict) -> list:
    """``(cost, topology, n)`` of each probe whose route the server's
    router would not answer on the card."""
    out = []
    for cost, topo, n, query in probes(mix):
        q = program.plan_request(query).q
        route = srv.router.route(q, cost)
        tag = srv.router.engine_tag(route.method, n, lane=route.lane,
                                    cost=cost)
        if tag.split(":")[0] in ("host", ""):
            out.append((cost, topo, n))
    return out


def drive(run) -> None:
    off_card = host_classes(program.make_server(run.config, run.device),
                            run.mix)
    if off_card:
        print(f"planbench: {run.cell['name']}: the program answers "
              f"{', '.join(f'{c} on {t}({n})' for c, t, n in off_card)} "
              f"off the card: it does not run configuration "
              f"{run.cell['config']}", file=sys.stderr)
        raise SystemExit(NOT_THIS_DEPLOYMENT)
    run.bench.driver("closed").drive(run)
