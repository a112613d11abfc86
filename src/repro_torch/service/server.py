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

``serve`` drives a whole request stream to completion as a thin
synchronous loop over the event-driven scheduler
(``service.runtime.ServingRuntime``) on a ``VirtualClock``: requests are
admitted in arrival order, buckets of same-``(n, cost)`` misses close on
size or an adaptive timeout, cache hits answer at admission, and
completion times play out on the discrete-event clock (arrivals from the
stream, solve durations measured on the wall clock).  The awaitable
front end (``plan_async``) shares the scheduler on a ``WallClock`` with
a worker-thread executor that solves on the server's device, so sync
and async answers are bit-identical.  ``prewarm`` builds and first-
touches the program buckets the server can hit before traffic arrives
(and, on a card, the kernel library).
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
from repro_torch.service import faults
from repro_torch.service import router as router_mod
from repro_torch.service.batch import BatchedSolver, BatchPolicy
from repro_torch.service.cache import CachedPlan, PlanCache
from repro_torch.service.canon import (CanonicalForm, canonicalize,
                                       relabel_tree)
from repro_torch.service.layercache import LayerCache
from repro_torch.service.router import Route, Router

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

    ``max_wait`` caps the runtime's batch-forming wait, ``trace`` turns
    its span trees on, ``lanes`` is its number of solve lanes, and
    ``replica_id`` names the server in a cluster ("" standalone)."""

    def __init__(self,
                 cache_capacity: int = 4096,
                 max_batch: int = 16,
                 max_wait: float = 0.005,
                 router: "Router | None" = None,
                 batch_policy: "BatchPolicy | None" = None,
                 enable_cache: bool = True,
                 enable_batch: bool = True,
                 enable_layer_cache: bool = True,
                 registry: "MetricsRegistry | None" = None,
                 trace: bool = True,
                 lanes: int = 1,
                 replica_id: str = "",
                 device=None):
        self.cache = PlanCache(cache_capacity)
        self.replica_id = replica_id
        # the bucket list of the prewarm calls so far (list of {"n",
        # "cost", "max_batch", "backend"}), what a peer replica replays
        # through ``prewarm_from_manifest``
        self.prewarm_manifest: "list[dict]" = []
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
        self.max_wait = max_wait
        self.lanes = max(1, int(lanes))   # serving runtime solve lanes
        self.enable_cache = enable_cache
        self.enable_batch = enable_batch
        self.stats = ServeStats()
        # one registry per server; every layer's stats object shows up in
        # snapshots as a provider, and runtimes bind their tracers to it
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.trace = trace
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

    # ------------------------------------------------------------ prewarm
    def prewarm(self, ns, costs=("max", "cap", "out")) -> dict:
        """Build and first-touch the program buckets this server's policy
        can hit for relation counts ``ns`` before traffic arrives (and,
        on a card, the kernel library), so the first requests pay no
        build.  Respects the router's lane ceilings (tiny-``n`` and
        past-ceiling requests never reach the fused engine).  Builds
        nothing for a host-engine server, but the manifest still records
        the requested buckets.

        Every call appends the buckets it covered to
        ``self.prewarm_manifest`` (dedup by ``(n, cost)``); ``backend``
        there is the port's tier, ``"cuda"`` or ``"f64"``."""
        pol = self.solver.policy
        cfg = self.router.config
        total = {"compiled": 0, "seconds": 0.0}
        seen = {(e["n"], e["cost"]) for e in self.prewarm_manifest}
        for cost in costs:
            for n in sorted(set(ns)):
                if n < 2:
                    continue
                if cost == "max":
                    if n <= cfg.small_n:      # routed to numpy DPsub
                        continue
                    max_b = pol.max_batch     # batch lane: all buckets
                elif cost == "out":
                    # the fused connected-C_out lane serves only the
                    # batch-lane window; outside it the host enumerator
                    # runs and there is nothing to build
                    if not (cfg.small_n < n <= cfg.fused_out_max_n):
                        continue
                    max_b = pol.max_batch
                elif n > cfg.fused_cap_max_n:  # host pipeline past ceiling
                    continue
                else:
                    # cap below small_n stays single-lane but still runs
                    # the fused program: warm the chunk-1 bucket only
                    max_b = pol.max_batch if n > cfg.small_n else 1
                # the tier the solver will pick for this n: the kernel
                # tier serves mid-size max chunks; cap's pass 1 and the
                # (min,+) sweeps run on the f64 tier
                backend = "cuda" if (cost == "max"
                                     and self.solver.use_kernels(n)) \
                    else "f64"
                if (n, cost) not in seen:
                    seen.add((n, cost))
                    self.prewarm_manifest.append(
                        {"n": int(n), "cost": cost,
                         "max_batch": int(max_b), "backend": backend})
                if pol.engine != "fused":
                    continue                  # manifest only, no build
                warm_costs = (cost,)
                if self.enable_layer_cache and cost in ("max", "cap"):
                    # seed-carrying solves run the ``<cost>_seeded``
                    # programs, in buckets of their own: warm them too
                    warm_costs = (cost, cost + "_seeded")
                r = engine_mod.prewarm([n], max_batch=max_b,
                                       backend=backend, direct_layers=4,
                                       costs=warm_costs,
                                       gamma_batch=pol.gamma_batch,
                                       device=self.device)
                total["compiled"] += r["compiled"]
                total["seconds"] += r["seconds"]
        return total

    def prewarm_from_manifest(self, manifest: "list[dict]") -> dict:
        """Prewarm from a peer replica's ``prewarm_manifest``: group the
        shipped buckets by cost and replay them through ``prewarm`` (the
        local policy re-derives batch sizes and tiers)."""
        by_cost: "dict[str, list[int]]" = {}
        for e in manifest:
            by_cost.setdefault(str(e["cost"]), []).append(int(e["n"]))
        total = {"compiled": 0, "seconds": 0.0}
        for cost, ns in sorted(by_cost.items()):
            r = self.prewarm(ns, costs=(cost,))
            total["compiled"] += r["compiled"]
            total["seconds"] += r["seconds"]
        return total

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

    # ------------------------------------------------------ stream serving
    def serve(self, requests: "list[PlanRequest]",
              closed_loop: bool = False
              ) -> "tuple[list[PlanResponse], ServeStats]":
        """Drive a request stream to completion over the serving runtime
        on a ``VirtualClock`` (the sync and async front ends share one
        code path, so their answers are bit-identical).

        ``closed_loop=True`` ignores arrival times: windows of
        ``max_batch`` requests are admitted and drained back to back.
        The default honors arrivals on the runtime's discrete-event
        clock: batch wait and executor queueing play out in virtual time,
        solve durations come from the wall clock.  A request that cannot
        be answered comes back as a typed error response, never a raise.
        """
        from repro_torch.service.runtime import (RuntimeConfig,
                                                 ServingRuntime,
                                                 VirtualClock)

        reqs = sorted(requests, key=lambda r: r.arrival)
        t_wall = time.perf_counter()   # timing: measured-duration (serve)
        rt = ServingRuntime(
            self, clock=VirtualClock(),
            config=RuntimeConfig(max_batch=self.max_batch,
                                 max_wait=self.max_wait,
                                 trace=self.trace,
                                 lanes=self.lanes))
        tickets: dict = {}
        if closed_loop:
            for i in range(0, len(reqs), self.max_batch):
                for r in reqs[i:i + self.max_batch]:
                    tickets[id(r)] = rt.submit(r)
                rt.drain()
        else:
            for r in reqs:
                rt.run_until(r.arrival)
                tickets[id(r)] = rt.submit(r)
            rt.drain()
        self.stats.wall_s += time.perf_counter() - t_wall  # timing: measured-duration
        self.stats.batches += rt.stats.batches
        # served counts answered requests only; refusals are explicit
        # error responses below, not throughput
        self.stats.served += rt.stats.served
        out = []
        for r in requests:
            ticket = tickets[id(r)]
            resp = ticket.response
            if resp is None:
                # refused: shed-class SLO, quarantine, or a solve that
                # exhausted the failure ladder
                err = ticket.error if ticket.error is not None \
                    else faults.ShedError(ticket.refuse_reason)
                resp = PlanResponse(
                    req_id=r.req_id, cost=float("inf"), tree=None,
                    meta={"shed": ticket.refuse_reason,
                          "error": repr(err)},
                    route=ticket.route, cache_hit=False,
                    latency=ticket.latency,
                    status="error", error=err)
            else:
                self.stats.latency.record(resp.latency)
            out.append(resp)
        self.last_runtime = rt
        return out, self.stats

    # --------------------------------------------------- async front end
    def make_runtime(self, clock=None, config=None, duration_fn=None,
                     executor: str = "inline", injector=None):
        """A ``ServingRuntime`` scheduling into this server's cache,
        router and solver.  ``injector`` wires a seeded
        ``faults.FaultInjector`` into the runtime's fault seams."""
        from repro_torch.service.runtime import (RuntimeConfig,
                                                 ServingRuntime)
        if config is None:
            config = RuntimeConfig(max_batch=self.max_batch,
                                   max_wait=self.max_wait,
                                   lanes=self.lanes)
        return ServingRuntime(self, clock=clock, config=config,
                              duration_fn=duration_fn, executor=executor,
                              injector=injector)

    def async_runtime(self):
        """The server's shared ``WallClock`` runtime with a worker-thread
        executor: the front end keeps admitting (and answering cache
        hits) while a batched dispatch executes on the server's
        device."""
        rt = getattr(self, "_async_rt", None)
        if rt is None:
            from repro_torch.service.runtime import (RuntimeConfig,
                                                     ServingRuntime,
                                                     WallClock)
            rt = self._async_rt = ServingRuntime(
                self, clock=WallClock(),
                config=RuntimeConfig(max_batch=self.max_batch,
                                     max_wait=self.max_wait,
                                     lanes=self.lanes),
                executor="thread")
        return rt

    async def plan_async(self, q: QueryGraph, card: np.ndarray,
                         cost: str = "max",
                         latency_budget: "float | None" = None,
                         slo: "str | None" = None,
                         connected: bool = False,
                         explain: bool = False,
                         tenant: "str | None" = None,
                         req_id: int = 0) -> PlanResponse:
        """Awaitable single-request entry over the async runtime.
        Concurrent callers share the scheduler: their misses batch
        together, duplicates coalesce, and cache hits overtake in-flight
        solves.  Raises a typed ``faults.PlanError`` (``ShedError``,
        ``QuarantinedError``, ``EngineError``...) if the request cannot
        be answered."""
        req = PlanRequest(q=q, card=np.asarray(card, np.float64),
                          cost=cost, latency_budget=latency_budget,
                          slo=slo, connected=connected, explain=explain,
                          tenant=tenant, req_id=req_id)
        return await self.plan_request_async(req)

    async def plan_request_async(self, req: PlanRequest) -> PlanResponse:
        """``plan_async`` over an already-built ``PlanRequest``."""
        import asyncio

        rt = self.async_runtime()
        ticket = rt.submit(req)
        while not ticket.done:
            rt.poll()
            if ticket.done:
                break
            nxt = rt.next_event_time()
            delay = 2e-4 if nxt is None else \
                min(max(nxt - rt.clock.now(), 0.0), 2e-3)
            await asyncio.sleep(delay)
        if ticket.refused:
            if ticket.error is not None:
                raise faults.as_plan_error(ticket.error)
            raise faults.ShedError(
                f"request shed: {ticket.refuse_reason}")
        self.stats.served += 1
        self.stats.latency.record(ticket.latency)
        return ticket.response

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
