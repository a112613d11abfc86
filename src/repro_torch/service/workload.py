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

Next to the synthetic generator sits the **replay lane**
(``make_einsum_workload``): the same popularity/relabel/arrival model
driven by *real contraction logs* from ``repro_torch.planner.einsum_path``
(``ContractionLog``, or its canned model-stack trace) instead of
synthetic templates — einsum traffic has systematically different
cardinality structure (heavily repeated index sizes, star/chain tensor
networks), which is exactly what the cache keys, candidate tables and
the router's topology buckets should be exercised with.
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
    """The replay lane's contraction pool.

    The canned model-stack trace (``einsum_path.builtin_trace``) plus
    traces logged from the ``train/steps`` model planners for one config
    per family (dense, MoE, SSM) — per-layer attention cores,
    attention+projection chains, gated MLPs, chunked-CE, decode-step
    attention, MoE routing, SSM scans (``model_planner_trace``).  The
    model traces are deliberately repetitive with shared sub-structure
    across templates, which is exactly the traffic the layer-fragment
    cache exists for; the replay benchmark's ``reuse`` row is measured
    on this pool.
    """
    from repro_torch.models.common import ModelConfig
    from repro_torch.planner.einsum_path import builtin_trace, \
        model_planner_trace

    cs = list(builtin_trace())
    if not include_model_traces:
        return cs
    for cfg in (
        ModelConfig(name="replay-dense", family="dense", n_layers=2,
                    d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                    vocab_size=4096),
        ModelConfig(name="replay-moe", family="moe", n_layers=2,
                    d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                    vocab_size=4096, n_experts=8, top_k=2),
        ModelConfig(name="replay-ssm", family="ssm", n_layers=2,
                    d_model=256, n_heads=0, n_kv_heads=0, d_ff=512,
                    vocab_size=4096, ssm_state=16, head_dim=64),
    ):
        cs.extend(model_planner_trace(cfg, logger=logger))
    return cs


def make_einsum_workload(spec: "WorkloadSpec | None" = None,
                         contractions=None) -> "list[PlanRequest]":
    """Request stream replayed from einsum contraction logs.

    ``contractions`` is a list of ``einsum_path.Contraction`` (e.g. a
    loaded ``ContractionLog.records``); default is the canned model-stack
    trace (``einsum_path.builtin_trace``).  The stream model matches the
    synthetic generator — Zipf template popularity, ``relabel_frac``
    repeats under random operand relabelings (the same contraction with
    tensors registered in another order), a ``fresh_frac`` of
    size-jittered variants (the same template at a different model
    scale), cost mix, budgets and Poisson arrivals — but every template
    is a real contraction, so cardinality tables carry the repeated
    index products and tensor-network topologies of real traffic.
    """
    from repro_torch.planner.einsum_path import (builtin_trace, cardinalities,
                                           query_graph)

    spec = spec or WorkloadSpec()
    rng = np.random.default_rng(spec.seed)
    cs = list(contractions) if contractions is not None else \
        builtin_trace()
    cs = [c for c in cs if c.n >= 2]
    pool = [(c, query_graph(c), cardinalities(c)) for c in cs]
    weights = 1.0 / np.arange(1, len(pool) + 1) ** spec.zipf_a
    weights /= weights.sum()
    costs = [c for c, _ in spec.cost_mix]
    cost_p = np.array([p for _, p in spec.cost_mix])
    cost_p /= cost_p.sum()
    slos, slo_p = _slo_dist(spec)

    def fresh_variant(c):
        """The same template at a jittered scale: one index dim scaled
        by a power of two — a new cardinality table, same topology."""
        ix = str(rng.choice(sorted(c.sizes)))
        factor = int(rng.choice([2, 4]))
        sizes = {**c.sizes, ix: max(c.sizes[ix] * factor, 2)}
        c2 = dataclasses.replace(c, sizes=sizes)
        return query_graph(c2), cardinalities(c2)

    reqs: list = []
    clock = 0.0
    for i in range(spec.n_requests):
        clock += float(rng.exponential(1.0 / spec.rate))
        c, q, card = pool[int(rng.choice(len(pool), p=weights))]
        if rng.random() < spec.fresh_frac:
            q, card = fresh_variant(c)
        elif rng.random() < spec.relabel_frac:
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
