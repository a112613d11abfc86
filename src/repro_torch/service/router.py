"""Admission policy: pick the planning algorithm per request (a copy of
``repro.service.router`` with the same defaults and decisions).

The repo implements a whole portfolio — DPconv[max], DPsub, DPccp, the
(1+eps) approximation, C_cap, and greedy best-effort — with wildly
different cost/optimality envelopes.  The router turns a request's
``(n, edge density, cost fn, latency budget)`` into a ``Route``:

* ``cost="max"``  -> DPconv[max] on the *batch* lane (the whole point of
  the serving subsystem: same-``n`` requests share lattice sweeps), except
  tiny ``n`` where the numpy DPsub beats the device program's overhead.
* ``cost="out"``  -> exact DPsub for dense/small graphs; DPccp for sparse
  graphs (the classic no-cross-product production choice — its search
  space excludes cross joins, which is the semantics sparse workloads
  want).  Connected simple-edge DPccp traffic in the
  ``small_n < n <= fused_out_max_n`` = 19 window rides the *batch* lane:
  the connectivity-masked fused C_out lattice program solves same-``n``
  chunks in one dispatch, bit-identical to the host enumerator; on one
  card it builds the connected-subset masks with the ``connmask`` kernel
  and sweeps with the table-free ``minplus_layer`` kernel, so 19, the
  largest n any fused lane serves, bounds it.  Tiny and past-ceiling
  ``n`` keep the per-query host DPccp.  On CPU tensors and over a solve
  mesh the sweep gathers split tables, so a server off one card, or
  with ``solve_shards > 1``, starts from ``GATHER_SWEEP_MAX_N`` as for
  C_cap below.  Dense C_out takes exact DPsub to ``exact_out_max_n``,
  and the (1+eps) approximation once exact blows the budget or ``n``
  grows past it.
* ``cost="cap"``  -> the fused two-pass C_cap lattice program on the
  *batch* lane for ``small_n < n <= fused_cap_max_n`` = 19, the largest
  n the float64 C_max program serves (the serving tier batches ``cap``
  requests exactly like ``max`` ones since the whole pipeline is one
  lattice program; on one card its (min,+) pass is the table-free
  ``minplus_layer`` kernel, so no split table bounds it); tiny ``n`` and
  ``n`` past the ceiling stay on the single-lane host pipeline.  On CPU
  tensors and over a solve mesh the pass gathers split tables, so a
  server off one card, or with ``solve_shards > 1``, starts from
  ``GATHER_SWEEP_MAX_N`` instead (a mesh then lifts it,
  ``engine.sharded_ceiling``).
* ``cost="smj"``  -> DPsub with the sunk sort-merge term; approx fallback.

Deadlines: the router keeps an EWMA latency model seeded with rough
work-count priors and updated by ``observe`` after every solve.  If the
chosen method's estimate exceeds the request's ``latency_budget`` it
degrades along ``exact -> approx -> GOO``; GOO (greedy operator
ordering) is the terminal best-effort answer — O(n^3) and always
admissible.  Routes carry a ``reason`` string so responses can be
audited (tests assert on it).

Latency-model attribution: coefficients are bucketed hierarchically by
``method`` -> ``method@engine`` -> ``method@engine#topology-class``.
The engine tag separates the fused whole-solve engine from the per-round
host loop (their latencies differ by the dispatch overhead the fused
engine eliminates; the batch lane's cap and out chunks are tagged
``<engine>:cap`` / ``<engine>:out`` so the two-pass pipeline and the
connected-C_out sweep never share a coefficient with plain
DPconv[max] — or, for ``dpccp@fused:out`` vs the untagged ``dpccp``
prior, with the #ccp-scaling host enumerator).  The topology class — the coarse
``canon.topology_signature`` bucket the server passes via
``signature=`` — stops clique observations from polluting chain/star
estimates: their gate densities, and hence their effective round counts
and pruning behavior, differ systematically.  ``observe`` updates the
most specific bucket it is given plus that bucket's engine-level (or
untagged) parent; ``estimate`` falls back most-specific-first, so a cold
topology bucket inherits the engine-level coefficient and a cold engine
tag the method prior.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.querygraph import QueryGraph

# the fused (min,+) ceiling where the sweep gathers split tables (CPU
# tensors, a solve mesh): the tables grow as 3^n, 6.2 GB at n = 18
GATHER_SWEEP_MAX_N = 13

# methods the single/batch lanes know how to execute
_METHODS = ("dpconv", "dpsub", "dpccp", "approx", "goo")


@dataclasses.dataclass(frozen=True)
class Route:
    cost: str
    method: str
    lane: str                  # "batch" | "single"
    params: tuple = ()         # sorted (key, value) pairs, cache-key stable
    reason: str = ""

    @property
    def cache_params(self) -> tuple:
        return self.params

    @property
    def lane_cost(self) -> str:
        """The lane-level cost label: the request cost, except that a
        connected (no-cross-products) cap is its own lane —
        ``"cap_conn"`` — for batching, EWMA pricing and the solver's
        chunk grouping.  Cache keys already separate via ``params``."""
        if self.cost == "cap" and dict(self.params).get("connected"):
            return "cap_conn"
        return self.cost

    def kw(self) -> dict:
        return dict(self.params)


@dataclasses.dataclass
class RouterConfig:
    small_n: int = 5            # below: numpy DPsub beats the device
    exact_out_max_n: int = 13   # exact C_out DPsub admission ceiling
    fused_cap_max_n: int = 19   # fused C_cap batch-lane admission ceiling
    fused_out_max_n: int = 19   # fused connected-C_out batch-lane ceiling
    sparse_density: float = 0.5  # <=: route C_out to DPccp
    approx_eps: float = 0.25
    ewma_alpha: float = 0.3
    lane_alpha: float = 0.3     # per-lane service-time EWMA smoothing


# rough work-count priors (seconds per unit measured lazily); the absolute
# scale only matters until the first observation lands in the EWMA
_PRIOR_COEFF = {
    "dpconv": 5e-8,
    "dpsub": 2e-9,
    "dpccp": 5e-9,
    "approx": 2e-7,
    "goo": 1e-7,
}


def _work(method: str, n: int) -> float:
    if method == "dpconv":
        return float(2 ** n) * n * n
    if method == "dpsub":
        return float(3 ** n)
    if method == "dpccp":
        return float(3 ** n)        # worst case; sparse graphs far below
    if method == "approx":
        return float(2 ** n) * n ** 3
    if method == "goo":
        return float(n ** 3)
    raise ValueError(method)


def topo_class(signature: str) -> str:
    """The coarse class field of a ``canon.topology_signature`` string
    (``n=..|m=..|<class>`` -> ``<class>``); '' passes through."""
    return signature.rsplit("|", 1)[-1] if signature else ""


class Router:
    def __init__(self, config: "RouterConfig | None" = None):
        self.config = config or RouterConfig()
        self._coeff: dict = dict(_PRIOR_COEFF)
        self.decisions: dict = {}     # method -> served count (see record)
        # method -> engine tag the server's solver will actually use for
        # it ("fused"/"host" for dpconv); keys estimates to the right
        # EWMA coefficient during admission
        self.engine_hint: dict = {}
        # lane index -> EWMA of observed per-solve seconds on that lane.
        # Lanes run identical code on identical hardware, but their AOT
        # caches differ (bucket placement is lane-affine), so a lane that
        # keeps compiling fresh shapes prices slower than a warmed one.
        self._lane_ewma: dict = {}

    # ------------------------------------------------------- lane pricing
    def observe_lane(self, lane: int, seconds: float) -> None:
        """EWMA-update one lane's observed per-solve service time (the
        N-lane runtime calls this after every dispatch it attributes to
        a lane)."""
        if seconds <= 0:
            return
        a = self.config.lane_alpha
        prev = self._lane_ewma.get(lane)
        self._lane_ewma[lane] = seconds if prev is None \
            else (1 - a) * prev + a * seconds

    def lane_factor(self, lane: int) -> float:
        """Relative speed of ``lane`` vs the fleet mean (> 1.0 = slower
        than average).  Cold lanes — no observations yet — price neutral
        at 1.0 so prewarm placement isn't biased by boot order."""
        ew = self._lane_ewma.get(lane)
        if ew is None or not self._lane_ewma:
            return 1.0
        mean = sum(self._lane_ewma.values()) / len(self._lane_ewma)
        return ew / mean if mean > 0 else 1.0

    def record(self, route: Route) -> None:
        """Count a route that actually served a response."""
        self.decisions[route.method] = \
            self.decisions.get(route.method, 0) + 1

    # ------------------------------------------------------ latency model
    @staticmethod
    def _key(method: str, engine: str = "", topo: str = "") -> str:
        key = method
        if engine:
            key += f"@{engine}"
        if topo:
            key += f"#{topo}"
        return key

    def estimate(self, method: str, n: int, engine: str = "",
                 topo: str = "") -> float:
        """Latency estimate from the most specific warmed bucket."""
        coeff = None
        for key in (self._key(method, engine, topo),
                    self._key(method, engine),
                    method):
            coeff = self._coeff.get(key)
            if coeff is not None:
                break
        return coeff * _work(method, n)

    def observe(self, method: str, n: int, seconds: float,
                engine: str = "", topo: str = "",
                parent: bool = True) -> None:
        """EWMA-update the latency coefficients: the most specific bucket
        given, plus (``parent=True``) its engine-level (or untagged)
        parent so cold sibling topology buckets inherit something
        fresher than the prior.  A caller attributing ONE solve to
        several topology classes must update the parent only once —
        pass ``parent=False`` on the extra classes — or the shared
        coefficient would weight that solve k-fold."""
        if method not in self._coeff or seconds <= 0:
            return
        a = self.config.ewma_alpha
        obs = seconds / _work(method, n)
        keys = []
        if topo:
            keys.append(self._key(method, engine, topo))
        if parent or not topo:
            keys.append(self._key(method, engine))
        for key in keys:
            prev = self._coeff.get(key, self._coeff[method])
            self._coeff[key] = (1 - a) * prev + a * obs

    def engine_tag(self, method: str, n: int, lane: str = "",
                   cost: str = "") -> str:
        """The EWMA engine namespace of the engine that will actually
        run ``method`` for this (n, lane, cost).  The engine hint
        describes the serving solver; cap requests get their own
        ":cap" namespace (the two-pass pipeline does strictly more
        work than a plain max solve), and past the fused ceiling the
        single-lane cap pipeline is the host one regardless of hint."""
        if cost in ("cap", "cap_conn") and method == "dpconv":
            # the connected cap gets its own ":cap_conn" namespace: its
            # pass 2 sweeps the DPccp search space under per-query
            # connectivity masks — different work, different coefficient
            engine = self.engine_hint.get(method, "")
            if engine and n > self.config.fused_cap_max_n:
                engine = "host"
            return engine + ":" + cost if engine else ""
        if cost == "out" and method == "dpccp":
            # only the batch lane runs the fused connected-C_out
            # program; every single-lane dpccp request (tiny n, past the
            # ceiling, hyperedges) runs the host enumerator, whose
            # latency scales with #ccp, not dense-lattice work — keying
            # on the lane (not the n-window) keeps e.g. in-window
            # hyperedge queries priced by the host coefficient
            engine = self.engine_hint.get(method, "")
            if engine and lane != "batch":
                engine = "host"
            return engine + ":out" if engine else ""
        if lane == "batch":
            return self.engine_hint.get(method, "")
        return ""

    def price(self, method: str, n: int, lane: str = "", cost: str = "",
              topo: str = "") -> float:
        """Deadline-aware latency price of running ``method`` on this
        request: the EWMA estimate under the engine attribution the
        serving tier will actually use.  This is what admission compares
        to the budget — and what the async runtime's batch former and
        shedding policy consume (the serving runtime of ``repro``)."""
        return self.estimate(method, n,
                             engine=self.engine_tag(method, n, lane,
                                                    cost),
                             topo=topo)

    # ----------------------------------------------------------- policy
    def _admit(self, method: str, n: int, budget: "float | None",
               lane: str = "", cost: str = "", topo: str = "") -> bool:
        if budget is None:
            return True
        return self.price(method, n, lane, cost, topo) <= budget

    def failure_fallback(self, cost: str, reason: str) -> Route:
        """The FAILURE-driven terminal rung of the ladder — distinct
        from ``route()``'s deadline-driven degradation: when a lane's
        circuit breaker is open or a solve has exhausted its retries
        and the host-exact rung too, the runtime reroutes onto GOO
        best-effort.  The response carries a cost certificate and is
        marked ``degraded``; it is cached under the goo method key, so
        it can never shadow an exact plan."""
        return Route(cost, "goo", "single", (), "failure: " + reason)

    def route(self, q: QueryGraph, cost: str,
              latency_budget: "float | None" = None,
              signature: str = "", connected: bool = False) -> Route:
        """``connected`` is the request-level no-cross-products flag
        (``PlanRequest.connected``, meaningful for ``cost="cap"``): the
        route's params carry ``("connected", True)`` — a distinct cache
        key — and admission prices against the ``:cap_conn`` EWMA
        namespace via ``Route.lane_cost``.  Non-simple or disconnected
        graphs (where the fused connectivity-masked pass is undefined)
        stay on the single lane's host pipeline."""
        cfg = self.config
        n = q.n
        m = len(q.edges)
        density = 2.0 * m / (n * (n - 1)) if n > 1 else 1.0
        topo = topo_class(signature)
        connected = bool(connected) and cost == "cap"
        lane_cost = "cap_conn" if connected else cost

        def mk(method, lane, params=(), reason=""):
            # NB: ``decisions`` is updated by the server for the route a
            # response actually used (route() may be called twice per
            # budgeted request: primary probe + budgeted re-route)
            return Route(cost, method, lane, tuple(params), reason)

        def degrade(primary, lane, params=(), reason=""):
            if self._admit(primary, n, latency_budget, lane, lane_cost,
                           topo):
                return mk(primary, lane, params, reason)
            if cost in ("out", "smj") and primary != "approx" \
                    and self._admit("approx", n, latency_budget,
                                    topo=topo):
                return mk("approx", "single",
                          (("eps", cfg.approx_eps),),
                          "deadline: degraded to (1+eps) approx")
            return mk("goo", "single", (),
                      "deadline: degraded to greedy best-effort")

        if cost == "max":
            if n <= cfg.small_n:
                return degrade("dpsub", "single", (),
                               f"n={n} <= small_n: numpy DPsub")
            return degrade("dpconv", "batch", (),
                           "DPconv[max] batched lane")
        if cost == "out":
            if density <= cfg.sparse_density \
                    and q.is_connected(q.full_mask):
                if cfg.small_n < n <= cfg.fused_out_max_n \
                        and not q.hyperedges:
                    return degrade(
                        "dpccp", "batch", (),
                        f"sparse (density={density:.2f}): DPccp, "
                        "fused connected-C_out lane")
                return degrade("dpccp", "single", (),
                               f"sparse (density={density:.2f}): DPccp")
            if n <= cfg.exact_out_max_n:
                return degrade("dpsub", "single", (),
                               "dense C_out within exact ceiling")
            return degrade("approx", "single",
                           (("eps", cfg.approx_eps),),
                           f"n={n} > exact ceiling: (1+eps) approx")
        if cost == "cap":
            params = (("connected", True),) if connected else ()
            if connected and (q.hyperedges
                              or not q.is_connected(q.full_mask)):
                return degrade("dpconv", "single", params,
                               "no-cross-products C_cap: host pipeline "
                               "(non-simple/disconnected graph)")
            if cfg.small_n < n <= cfg.fused_cap_max_n:
                return degrade("dpconv", "batch", params,
                               ("connected C_cap fused lattice program, "
                                "batched lane" if connected else
                                "C_cap fused lattice program, batched "
                                "lane"))
            return degrade("dpconv", "single", params,
                           "connected C_cap two-pass pipeline"
                           if connected else "C_cap two-pass pipeline")
        if cost == "smj":
            if n <= cfg.exact_out_max_n:
                return degrade("dpsub", "single", (),
                               "sunk sort-merge DPsub")
            return degrade("approx", "single",
                           (("eps", cfg.approx_eps),),
                           "smj approx")
        raise ValueError(f"unknown cost function {cost!r}")
