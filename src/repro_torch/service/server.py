"""The plan server of the port: micro-batched, cached, policy-routed join
ordering (counterpart of ``repro.service.server``).

Request lifecycle, as in the reference:

1. **canonicalize** — the request's ``(QueryGraph, card)`` is relabeled
   to canonical form; isomorphic requests collapse to one cache identity.
2. **route** — the admission policy picks (method, lane, params) from
   ``(n, density, cost fn, latency budget)``.
3. **cache** — lookup on ``(canonical key, cost, method, params)``; a hit
   replays the cached canonical plan through the request's inverse
   permutation and skips planning.
4. **seed** — a miss asks the layer cache for a warm start (a cached
   C_max optimum for the max/cap search, cached sub-table values for the
   out sweep).
5. **solve** — batch-lane misses are stacked by ``(n, cost)`` and solved
   by the ``BatchedSolver`` on the server's device; single-lane misses
   run the routed core algorithm directly.  Solved plans go into the
   plan cache in canonical space, exact ones feed the layer cache, and
   trees are relabeled back.

``plan_one`` and the micro-batch seam ``_process`` are ported.  Stream
serving and the awaitable front end need the serving runtime, and the
prewarm calls need the ahead-of-time compiled buckets of the reference;
those methods raise ``NotImplementedError`` until a later slice ports
them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import best_effort
from repro_torch.core import engine as engine_mod
from repro_torch.core.dpconv import optimize
from repro_torch.core.querygraph import QueryGraph
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.service import router as router_mod
from repro_torch.service.batch import BatchedSolver, BatchPolicy
from repro_torch.service.cache import CachedPlan, PlanCache
from repro_torch.service.canon import (CanonicalForm, canonicalize,
                                       relabel_tree)
from repro_torch.service.layercache import LayerCache
from repro_torch.service.router import Route, Router

_RUNTIME_SLICE = ("needs the serving runtime (service.runtime), which is "
                  "not ported yet")


# ---------------------------------------------------------------- requests
@dataclasses.dataclass
class PlanRequest:
    q: QueryGraph
    card: np.ndarray
    cost: str = "max"
    latency_budget: "float | None" = None
    arrival: float = 0.0
    req_id: int = 0
    # SLO class name of the serving runtime (None = best effort)
    slo: "str | None" = None
    # no-cross-products flag (meaningful for cost="cap"): pass 2 runs on
    # the DPccp search space, routed and cached as the "cap_conn" lane
    connected: bool = False
    # opt-in provenance on the response's ``explain`` dict
    explain: bool = False
    # tenant id for per-tenant quotas (None is unmetered)
    tenant: "str | None" = None


@dataclasses.dataclass
class PlanResponse:
    req_id: int
    cost: float
    tree: object
    meta: dict
    route: Route
    cache_hit: bool
    latency: float = 0.0
    explain: "dict | None" = None
    # "exact" (bit-identical to the exact solve), "degraded" (certified
    # best-effort: the GOO lane, meta carries the cost certificate) or
    # "error" (typed refusal in ``error``)
    status: str = "exact"
    error: "Exception | None" = None


# --------------------------------------------------------------- telemetry
class LatencyHistogram:
    """Log-bucketed latency histogram (1us .. ~17min) with exact
    percentiles from retained samples."""

    BUCKETS_PER_DECADE = 4

    def __init__(self):
        self._samples: list = []

    def record(self, seconds: float) -> None:
        self._samples.append(float(seconds))

    @property
    def count(self) -> int:
        return len(self._samples)

    def percentile(self, p: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), p))

    def buckets(self) -> "list[tuple[float, int]]":
        """(upper_bound_seconds, count) pairs for non-empty log buckets."""
        if not self._samples:
            return []
        out: dict = {}
        for s in self._samples:
            k = int(np.ceil(np.log10(max(s, 1e-6))
                            * self.BUCKETS_PER_DECADE))
            out[k] = out.get(k, 0) + 1
        return [(10 ** (k / self.BUCKETS_PER_DECADE), c)
                for k, c in sorted(out.items())]

    def summary(self) -> dict:
        return {"count": self.count,
                "p50_ms": round(self.percentile(50) * 1e3, 3),
                "p90_ms": round(self.percentile(90) * 1e3, 3),
                "p99_ms": round(self.percentile(99) * 1e3, 3)}


@dataclasses.dataclass
class ServeStats:
    served: int = 0
    batches: int = 0
    deadline_fallbacks: int = 0
    wall_s: float = 0.0
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    @property
    def plans_per_s(self) -> float:
        return self.served / self.wall_s if self.wall_s > 0 else 0.0


# ------------------------------------------------------------------ server
class PlanServer:
    """Plan cache, router, layer cache and batched solver on ``device``
    (CUDA unless given; without a card ``device=None`` raises).

    The reference's ``max_wait``, ``trace``, ``lanes`` and ``replica_id``
    configure the serving runtime and the cluster; they are not accepted
    here until those are ported."""

    def __init__(self,
                 cache_capacity: int = 4096,
                 max_batch: int = 16,
                 router: "Router | None" = None,
                 batch_policy: "BatchPolicy | None" = None,
                 enable_cache: bool = True,
                 enable_batch: bool = True,
                 enable_layer_cache: bool = True,
                 registry: "MetricsRegistry | None" = None,
                 device=None):
        self.cache = PlanCache(cache_capacity)
        # the layer-granular fragment tier, independent of the plan cache
        self.layers = LayerCache()
        self.enable_layer_cache = enable_layer_cache
        self.router = router or Router()
        self.solver = BatchedSolver(batch_policy
                                    or BatchPolicy(max_batch=max_batch),
                                    device=device)
        self.device = self.solver.device
        # admission estimates price the engine the batch lane will run
        self.router.engine_hint["dpconv"] = self.solver.policy.engine
        self.router.engine_hint["dpccp"] = self.solver.policy.engine
        self.max_batch = max_batch
        self.enable_cache = enable_cache
        self.enable_batch = enable_batch
        self.stats = ServeStats()
        # one registry per server; every layer's stats object shows up in
        # snapshots as a provider
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.registry.register_provider("cache", self.cache.stats.as_dict)
        self.registry.register_provider(
            "layercache", lambda: self.layers.stats.as_dict())
        self.registry.register_provider(
            "router", lambda: {"decisions": dict(self.router.decisions),
                               "engine_hint":
                                   dict(self.router.engine_hint)})
        self.registry.register_provider(
            "serve", lambda: {"served": self.stats.served,
                              "batches": self.stats.batches,
                              "deadline_fallbacks":
                                  self.stats.deadline_fallbacks,
                              "wall_s": self.stats.wall_s,
                              "latency": self.stats.latency.summary()})
        self.registry.register_provider(
            "solver", lambda: {"batches_run": self.solver.batches_run,
                               "queries_batched":
                                   self.solver.queries_batched,
                               "total_solve_s": self.solver.total_solve_s,
                               "total_solved": self.solver.total_solved})
        self.registry.register_provider(
            "engine", lambda: engine_mod.stats().as_dict())

    # ------------------------------------------------ later slice: runtime
    def prewarm(self, ns, costs=("max", "cap", "out")) -> dict:
        raise NotImplementedError(
            "prewarm compiles the reference's ahead-of-time buckets; the "
            "port builds its programs at first use (not ported yet)")

    def prewarm_from_manifest(self, manifest: "list[dict]") -> dict:
        raise NotImplementedError("prewarm_from_manifest " + _RUNTIME_SLICE)

    def serve(self, requests: "list[PlanRequest]",
              closed_loop: bool = False):
        raise NotImplementedError("serve " + _RUNTIME_SLICE)

    def make_runtime(self, clock=None, config=None, duration_fn=None,
                     executor: str = "inline", injector=None):
        raise NotImplementedError("make_runtime " + _RUNTIME_SLICE)

    def async_runtime(self):
        raise NotImplementedError("async_runtime " + _RUNTIME_SLICE)

    async def plan_async(self, q: QueryGraph, card: np.ndarray,
                         cost: str = "max", **kw) -> PlanResponse:
        raise NotImplementedError("plan_async " + _RUNTIME_SLICE)

    async def plan_request_async(self, req: PlanRequest) -> PlanResponse:
        raise NotImplementedError("plan_request_async " + _RUNTIME_SLICE)

    # ------------------------------------------------------- single entry
    def plan_one(self, q: QueryGraph, card: np.ndarray, cost: str = "max",
                 latency_budget: "float | None" = None,
                 connected: bool = False,
                 explain: bool = False) -> PlanResponse:
        """Plan one query through the full cache/route/solve path."""
        req = PlanRequest(q=q, card=np.asarray(card, np.float64),
                          cost=cost, latency_budget=latency_budget,
                          connected=connected, explain=explain)
        resp = self._process([req])[0]
        self.stats.served += 1
        return resp

    # ---------------------------------------------------------- internals
    def _lookup(self, req: PlanRequest, form: CanonicalForm,
                route: Route, count_miss: bool = True,
                accept_degraded: bool = False,
                report_route: "Route | None" = None
                ) -> "PlanResponse | None":
        """``accept_degraded``: whether a degraded entry may answer this
        probe — the primary (exact-capable) probe leaves it False, so a
        degraded plan misses through to a fresh exact solve; the
        deadline-pressed re-probe and GOO-routed requests accept.
        ``report_route``: the route a replayed *degraded* entry claims
        (degraded entries live under the primary route's key)."""
        key = PlanCache.make_key(form.key, req.cost, route.method,
                                 route.params)
        entry = self.cache.lookup(
            key, request_perm=form.perm, count_miss=count_miss,
            accept_degraded=accept_degraded or route.method == "goo")
        if entry is None:
            return None
        served = route if (report_route is None
                           or entry.status != "degraded") else report_route
        self.router.record(served)
        resp = PlanResponse(
            req_id=req.req_id, cost=entry.cost,
            tree=relabel_tree(entry.tree, form.inverse_perm),
            meta={**entry.meta, "cached": True},
            route=served, cache_hit=True,
            status=("degraded" if (entry.status == "degraded"
                                   or entry.meta.get("best_effort"))
                    else "exact"))
        if req.explain:
            resp.explain = self._explain_base(req, form, route,
                                              cache_hit=True)
        return resp

    def _explain_base(self, req: PlanRequest, form: CanonicalForm,
                      route: Route, cache_hit: bool) -> dict:
        """The provenance skeleton of an opt-in ``explain`` response."""
        key = PlanCache.make_key(form.key, req.cost, route.method,
                                 route.params)
        return {"lane": route.lane, "method": route.method,
                "lane_cost": route.lane_cost, "reason": route.reason,
                "engine_tag": self.router.engine_tag(
                    route.method, form.q.n, route.lane, route.lane_cost),
                "cache_key": repr(key), "cache_hit": cache_hit,
                "params": dict(route.params)}

    def _batch_eligible(self, route: Route, cost: str) -> bool:
        """Does this route ride the batched lattice lane?"""
        return (route.lane == "batch"
                and ((route.method == "dpconv"
                      and cost in ("max", "cap"))
                     or (route.method == "dpccp" and cost == "out")))

    def _observe_batch(self, timings: list) -> None:
        """Feed one batched solve's per-chunk timings to the router's
        latency model — per ``n``, per engine and per topology class."""
        for n, cnt, dt, eng, cost, tags in timings:
            method = "dpccp" if cost == "out" else "dpconv"
            tag = eng + (":" + cost
                         if cost in ("cap", "cap_conn", "out") else "")
            # each class in a chunk gets the per-query mean; the
            # engine-level parent coefficient sees the chunk once
            for i, topo in enumerate(tags or {"": cnt}):
                self.router.observe(method, n, dt / max(cnt, 1),
                                    engine=tag, topo=topo,
                                    parent=(i == 0))

    def _observe_single(self, route: Route, form: CanonicalForm,
                        cost: str, dt: float, meta: dict) -> None:
        # tag dpconv/dpccp observations with the engine that ran (plus
        # the ':cap' / ':out' namespace)
        eng = meta.get("engine", "") \
            if route.method in ("dpconv", "dpccp") else ""
        if eng and cost == "cap":
            eng += ":" + route.lane_cost    # ":cap" or ":cap_conn"
        elif eng and cost == "out" and route.method == "dpccp":
            eng += ":out"
        self.router.observe(route.method, form.q.n, dt, engine=eng,
                            topo=router_mod.topo_class(form.signature))

    def _primary_probe(self, req: PlanRequest, form: CanonicalForm
                       ) -> "tuple[Route, PlanResponse | None]":
        """First rung: probe the cache under the primary (budget-free)
        route — a cached plan satisfies any latency budget."""
        primary = self.router.route(form.q, req.cost, None,
                                    signature=form.signature,
                                    connected=req.connected)
        resp = self._lookup(req, form, primary) if self.enable_cache \
            else None
        return primary, resp

    def _budget_reroute(self, req: PlanRequest, form: CanonicalForm,
                        budget: float, primary: Route
                        ) -> "tuple[Route, PlanResponse | None]":
        """Second rung: re-route under the budget, and when the method
        changed probe the primary key once more (no second miss),
        accepting a cached degraded plan."""
        route = self.router.route(form.q, req.cost, budget,
                                  signature=form.signature,
                                  connected=req.connected)
        resp = None
        if self.enable_cache and route.method != primary.method:
            resp = self._lookup(req, form, primary, count_miss=False,
                                accept_degraded=True,
                                report_route=route)
        return route, resp

    def _layer_seed(self, form: CanonicalForm, cost: str,
                    route: "Route | None") -> "dict | None":
        """The layer-cache seed payload for one plan-cache miss (the 5th
        batch-item slot / the single-lane ``seed=``), or None for a route
        that cannot use one.  Seeds are pure warm-start hints."""
        if not self.enable_layer_cache:
            return None
        if route is None or route.method == "goo":
            return None
        if cost in ("max", "cap"):
            if route.method != "dpconv":
                return None
        elif cost == "out":
            # value-seed probes cost n+1 subset canonicalizations; only
            # the fused lattice program has a seed slot to pay them off
            if route.method != "dpccp" \
                    or self.solver.policy.engine != "fused":
                return None
        else:
            return None
        return self.layers.seed_for(form, cost)

    def _process(self, batch: "list[PlanRequest]") -> "list[PlanResponse]":
        """Answer one micro-batch: cache probes, routing, one batched
        solve for the batch-lane misses, single-lane solves, completion."""
        responses: "list[PlanResponse | None]" = [None] * len(batch)
        batch_lane: list = []          # (pos, form)
        single_lane: list = []         # (pos, form, route)
        routes: "list[Route | None]" = [None] * len(batch)

        for pos, req in enumerate(batch):
            form = canonicalize(req.q, np.asarray(req.card, np.float64))
            primary, resp = self._primary_probe(req, form)
            if resp is not None:
                responses[pos] = resp
                routes[pos] = primary
                continue
            route = primary
            if req.latency_budget is not None:
                route, resp = self._budget_reroute(
                    req, form, req.latency_budget, primary)
                if "deadline" in route.reason:
                    self.stats.deadline_fallbacks += 1
                if resp is not None:
                    responses[pos] = resp
                    routes[pos] = route
                    continue
            routes[pos] = route
            if self.enable_batch and self._batch_eligible(route, req.cost):
                batch_lane.append((pos, form))
            else:
                single_lane.append((pos, form, route))

        if batch_lane:
            # every item's seed is probed before the chunk is solved; the
            # solver groups by lane cost, so "cap_conn" never mixes with cap
            items = [(form.q, form.card, routes[pos].lane_cost,
                      router_mod.topo_class(form.signature),
                      self._layer_seed(form, batch[pos].cost, routes[pos]))
                     for pos, form in batch_lane]
            results = self.solver.solve(items)
            self._observe_batch(self.solver.last_timings)
            for (pos, form), res in zip(batch_lane, results):
                responses[pos] = self._complete(
                    batch[pos], form, routes[pos], float(res.cost),
                    res.tree, dict(res.meta))

        for pos, form, route in single_lane:
            t0 = time.perf_counter()   # timing: measured-duration (solve)
            cost_v, tree, meta = self._solve_single(
                form.q, form.card, batch[pos].cost, route,
                seed=self._layer_seed(form, batch[pos].cost, route))
            self._observe_single(route, form, batch[pos].cost,
                                 # timing: measured-duration
                                 time.perf_counter() - t0, meta)
            responses[pos] = self._complete(batch[pos], form, route,
                                            cost_v, tree, meta)
        return responses  # type: ignore[return-value]

    def _complete(self, req: PlanRequest, form: CanonicalForm,
                  route: Route, cost_v: float, tree, meta: dict,
                  insert: bool = True) -> PlanResponse:
        """Finish one solved request: cache the canonical plan, feed the
        layer cache (exact solves only), record the route, and relabel
        the tree back into the request's labeling.  Degraded (GOO)
        results insert under the primary route's key with
        ``status="degraded"``, and never clobber an exact entry."""
        meta = dict(meta)
        # the solved DP value table rides out of the core solve for the
        # fragment harvest only: it never reaches the plan cache or a
        # response (2^n floats per query)
        dp_row = meta.pop("dp_table", None)
        status = "degraded" if (route.method == "goo"
                                or meta.get("best_effort")) else "exact"
        if self.enable_cache and insert:
            insert_route = route
            if status == "degraded" and route.method == "goo":
                insert_route = self.router.route(
                    form.q, req.cost, None, signature=form.signature,
                    connected=req.connected)
            key = PlanCache.make_key(form.key, req.cost,
                                     insert_route.method,
                                     insert_route.params)
            prior = self.cache.peek(key)
            if not (status == "degraded" and prior is not None
                    and prior.status == "exact"):
                self.cache.insert(key, CachedPlan(cost=cost_v, tree=tree,
                                                  meta=meta,
                                                  inserted_perm=form.perm,
                                                  status=status))
        if insert and status == "exact" and self.enable_layer_cache:
            self.layers.observe(form, req.cost, cost_v, meta,
                                params=route.params, dp=dp_row)
        self.router.record(route)
        resp = PlanResponse(
            req_id=req.req_id, cost=cost_v,
            tree=relabel_tree(tree, form.inverse_perm),
            meta=meta, route=route, cache_hit=False,
            status=status)
        if req.explain:
            resp.explain = self._explain_base(req, form, route,
                                              cache_hit=False)
        return resp

    def _solve_single(self, q: QueryGraph, card: np.ndarray, cost: str,
                      route: Route, engine: "str | None" = None,
                      seed: "dict | None" = None) -> tuple:
        """One single-lane solve on the server's device.  ``engine``
        overrides the policy engine for this solve; ``seed`` is a
        layer-cache warm-start payload, which the host paths drop."""
        if route.method == "goo":
            tree = best_effort.goo(q, card)
            fn = {"max": tree.cost_max, "out": tree.cost_out,
                  "smj": tree.cost_smj, "cap": tree.cost_out}[cost]
            val = float(fn(card))
            # the certificate makes a degraded response auditable: the
            # bound is recomputed from the returned tree itself
            return val, tree, {"best_effort": True,
                               "certificate": {
                                   "kind": "goo", "cost_fn": cost,
                                   "upper_bound": val,
                                   "recomputed_from_tree": True}}
        kw = route.kw()
        if seed is not None:
            if "opt" in seed and cost in ("max", "cap") \
                    and route.method == "dpconv":
                kw["seed_opt"] = float(seed["opt"])
            elif "vals" in seed and cost == "out" \
                    and route.method == "dpccp":
                kw["seed_vals"] = seed["vals"]
                kw["seed_ok"] = seed["ok"]
        if route.method == "dpconv":
            # the single lane follows BatchPolicy.engine too; past the
            # fused-cap ceiling, and for a connected cap on a hyperedge or
            # disconnected graph, the host pipeline runs
            engine = engine or self.solver.policy.engine
            if (cost == "cap"
                    and q.n > self.router.config.fused_cap_max_n):
                engine = "host"
            if (cost == "cap" and kw.get("connected")
                    and (q.hyperedges
                         or not q.is_connected(q.full_mask))):
                engine = "host"
            kw.setdefault("engine", engine)
            if kw["engine"] == "fused":
                kw.setdefault("gamma_batch",
                              self.solver.policy.gamma_batch)
        elif route.method == "dpccp" and engine:
            kw.setdefault("engine", engine)
        res = optimize(q, card, cost=cost, method=route.method,
                       device=self.device, **kw)
        return float(res.cost), res.tree, dict(res.meta)
