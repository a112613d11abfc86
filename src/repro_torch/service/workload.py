"""Diverse request-stream generation for the plan server (a copy of
``repro.service.workload``: the same generator draws the same stream
from the same seed).

Production plan traffic is *repetitive with variation*: a finite set of
query templates (dashboards, ORM-generated joins, pipeline stages) is
re-issued at high rate, often with relations bound in a different order,
sprinkled with genuinely fresh ad-hoc queries.  The generator models
exactly that:

* a **template pool** of (topology, n, cardinality-regime) queries drawn
  from chain / star / cycle / grid / clique / JOB-like random-sparse
  graphs across selectivity regimes;
* a **Zipf-ish popularity** distribution over templates (hot dashboards
  dominate), with a ``fresh_frac`` of never-seen queries;
* a ``relabel_frac`` of repeats issued under a *random relation
  relabeling* — semantically the same query, byte-wise a different one;
  this is the traffic the isomorphism-invariant cache key exists for;
* a cost-function mix and occasional tight ``latency_budget`` requests
  that exercise the router's deadline fallback;
* **Poisson arrivals** at ``rate`` requests/second.

The **replay lane** (``einsum_replay_pool``, ``make_einsum_workload``)
drives the same model with contraction logs of the einsum planner, which
the port does not carry yet: both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.querygraph import (QueryGraph, chain, clique, cycle, grid,
                                   make_cardinalities, permute_card,
                                   random_sparse, relabel, star)
from repro_torch.service.server import PlanRequest

TOPOLOGIES = ("chain", "star", "cycle", "grid", "clique", "sparse")

# cardinality regimes: (base_range, selectivity_range) of the selectivity
# model — OLTP-ish small tables, warehouse-scale, and highly-selective
REGIMES = {
    "oltp": ((1e2, 1e4), (1e-3, 1.0)),
    "warehouse": ((1e4, 1e7), (1e-5, 1e-1)),
    "selective": ((1e2, 1e6), (1e-6, 1e-3)),
}

_GRIDS = [(2, 3), (2, 4), (3, 3), (2, 5), (3, 4), (2, 6), (3, 5), (2, 7),
          (4, 4), (3, 6)]


@dataclasses.dataclass
class WorkloadSpec:
    n_requests: int = 200
    seed: int = 0
    n_range: tuple = (6, 12)
    topologies: tuple = TOPOLOGIES
    cost_mix: tuple = (("max", 0.65), ("out", 0.20), ("cap", 0.10),
                       ("smj", 0.05))
    pool_size: int = 16          # number of hot templates
    fresh_frac: float = 0.10     # brand-new queries (always cache misses)
    relabel_frac: float = 0.5    # repeats issued under a random relabeling
    zipf_a: float = 1.5          # template popularity skew
    rate: float = 200.0          # Poisson arrival rate, requests/second
    budget_frac: float = 0.0     # fraction with tight latency budgets
    budget_s: float = 2e-4
    # SLO-class mix for the async runtime: (name, weight) pairs naming
    # classes in runtime.RuntimeConfig.slo_classes.  Empty (default)
    # assigns no class — and draws nothing from the RNG, so existing
    # workload streams reproduce bit-for-bit.
    slo_mix: tuple = ()


def make_query(rng: np.random.Generator, spec: WorkloadSpec,
               topology: "str | None" = None
               ) -> "tuple[QueryGraph, np.ndarray, str]":
    """One (query graph, cardinality table, topology-name) sample."""
    lo, hi = spec.n_range
    topo = topology or str(rng.choice(list(spec.topologies)))
    n = int(rng.integers(lo, hi + 1))
    if topo == "chain":
        q = chain(n)
    elif topo == "star":
        q = star(n)
    elif topo == "cycle":
        q = cycle(max(n, 3))
    elif topo == "clique":
        q = clique(n)
    elif topo == "grid":
        fits = [(r, c) for r, c in _GRIDS if lo <= r * c <= hi]
        r, c = fits[int(rng.integers(len(fits)))] if fits else (2, max(
            lo // 2, 2))
        q = grid(r, c)
    elif topo == "sparse":
        q = random_sparse(n, extra_edges=int(rng.integers(0, n)),
                          seed=int(rng.integers(2 ** 31)))
    else:
        raise ValueError(f"unknown topology {topo!r}")
    regime = REGIMES[str(rng.choice(list(REGIMES)))]
    card = make_cardinalities(q, seed=int(rng.integers(2 ** 31)),
                              base_range=regime[0],
                              selectivity_range=regime[1])
    return q, card, topo


def make_workload(spec: "WorkloadSpec | None" = None
                  ) -> "list[PlanRequest]":
    spec = spec or WorkloadSpec()
    rng = np.random.default_rng(spec.seed)
    pool = [make_query(rng, spec) for _ in range(spec.pool_size)]
    # Zipf-ish popularity over the pool
    weights = 1.0 / np.arange(1, spec.pool_size + 1) ** spec.zipf_a
    weights /= weights.sum()
    costs = [c for c, _ in spec.cost_mix]
    cost_p = np.array([p for _, p in spec.cost_mix])
    cost_p /= cost_p.sum()
    slos, slo_p = _slo_dist(spec)

    reqs: list = []
    clock = 0.0
    for i in range(spec.n_requests):
        clock += float(rng.exponential(1.0 / spec.rate))
        if rng.random() < spec.fresh_frac:
            q, card, _topo = make_query(rng, spec)
        else:
            q, card, _topo = pool[int(rng.choice(spec.pool_size,
                                                 p=weights))]
            if rng.random() < spec.relabel_frac:
                perm = rng.permutation(q.n)
                q = relabel(q, perm)
                card = permute_card(card, q.n, perm)
        cost = str(rng.choice(costs, p=cost_p))
        budget = (spec.budget_s if rng.random() < spec.budget_frac
                  else None)
        reqs.append(PlanRequest(q=q, card=card, cost=cost,
                                latency_budget=budget, arrival=clock,
                                req_id=i,
                                slo=_draw_slo(rng, slos, slo_p)))
    return reqs


def _slo_dist(spec: WorkloadSpec):
    if not spec.slo_mix:
        return None, None
    names = [s for s, _ in spec.slo_mix]
    p = np.array([w for _, w in spec.slo_mix], np.float64)
    return names, p / p.sum()


def _draw_slo(rng, slos, slo_p):
    if slos is None:
        return None
    return str(rng.choice(slos, p=slo_p))


# ------------------------------------------------------------ replay lane
def einsum_replay_pool(include_model_traces: bool = True,
                       logger=None) -> list:
    """The replay lane's contraction pool: needs the einsum planner."""
    raise NotImplementedError("the einsum replay lane needs the planner "
                              "(planner/einsum_path), not ported yet")


def make_einsum_workload(spec: "WorkloadSpec | None" = None,
                         contractions=None) -> "list[PlanRequest]":
    """Request stream replayed from einsum contraction logs: needs the
    einsum planner."""
    raise NotImplementedError("the einsum replay lane needs the planner "
                              "(planner/einsum_path), not ported yet")
