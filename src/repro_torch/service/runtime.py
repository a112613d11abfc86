"""Async deadline-aware serving runtime — the scheduler over PlanServer
(a copy of ``repro.service.runtime``: the same scheduling, defaults and
failure ladder, over the port's server, solver and engine).

``PlanServer._process`` answers "plan this micro-batch"; this module
answers "keep answering under load": a sub-millisecond cache hit must
not queue behind a batched miss in flight on the same lane.  It is the
scheduling layer over the fused engines:

* **pluggable clock** — every scheduling decision reads a ``Clock``.
  ``WallClock`` serves real traffic; ``VirtualClock`` makes every
  decision deterministic (the runtime never sleeps: it exposes
  ``next_event_time`` and the caller advances).
* **SLO classes & deadlines** — ``PlanRequest.slo`` names a class
  (``RuntimeConfig.slo_classes``) whose budget prices an absolute
  per-request deadline at admission; ``latency_budget`` still works and
  takes precedence.  Telemetry is kept per class.
* **admission queues per (n, cost) bucket** with an **adaptive batch
  former**: a bucket closes on size (``max_batch``) or timeout, where
  the timeout is priced per bucket from the router's per-(method,
  engine[:cost], topology-class) EWMA — wait at most ``wait_solve_frac``
  of the estimated solve and never more than the tightest queued
  deadline can afford after the solve itself and the executor backlog.
* **cache-hit fast path** — canonicalized hits answer immediately at
  admission, overtaking every in-flight batched miss
  (``stats.overtakes``).
* **relabeling-aware join-on-completion** — a miss whose full cache key
  (canonical key, cost, method, params) matches a queued or in-flight
  solve attaches to it; on completion every joined ticket replays the
  one solve through its *own* inverse permutation (``stats.coalesced``).
* **backpressure & deadline-aware shedding** — past ``max_pending``
  queued tickets new misses are refused; a priced-unmeetable deadline
  is refused or downgraded to the GOO best-effort lane per the SLO
  class policy.  ``deadline_misses`` counts only promised-and-missed
  completions.
* **N solve lanes** — ``RuntimeConfig.lanes`` serial executors
  (single-worker pools in thread mode, per-lane occupancy queues in
  inline mode), each owning a ``BatchedSolver`` on the server's device.
  Placement is lane-affine per ``(n, cost)`` program bucket (see
  ``prewarm_lanes``), deadline-promised works steal onto idle lanes,
  the router prices lanes individually (``observe_lane`` /
  ``lane_factor``), and half-open breaker probes hedge with a
  host-exact shadow on a second lane — first exact answer wins.

Execution: solves go through ``BatchedSolver.submit`` / ``collect`` so
batch formation overlaps the executing dispatch.  The ``inline``
executor runs the solve at start and models occupancy in virtual time;
the ``thread`` executor runs ``collect`` on a lane's worker thread so a
WallClock front end keeps admitting — and fast-path answering — while a
dispatch executes.  Worker threads solve on the server's device (CUDA
unless the server was given another); kernels launch on the thread's
current stream, the default one, so lanes serialize on the card.

Bit-parity contract: the runtime reuses PlanServer's canonicalize /
route / cache / solve pieces verbatim, so responses are bit-identical
(optima, DP tables, trees) to synchronous ``PlanServer.serve`` on the
same workload under any interleaving, and to ``repro``'s runtime under
the same injected durations (``tests/test_torch_runtime.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time

import numpy as np

from repro_torch.core import engine as engine_mod
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.service.cache import PlanCache
from repro_torch.service import faults as faults_mod
from repro_torch.service import router as router_mod
from repro_torch.service import tenancy as tenancy_mod
from repro_torch.service.canon import canonicalize


# ------------------------------------------------------------------ clocks
class Clock:
    """The runtime's single time source.  ``now`` is monotonic seconds;
    ``advance`` charges elapsed work time (a no-op on the wall clock,
    where time passes by itself)."""

    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    def __init__(self):
        self._t0 = time.monotonic()   # timing: clock-source

    def now(self) -> float:
        return time.monotonic() - self._t0   # timing: clock-source

    def epoch_ns(self, t: float) -> int:
        """Clock time ``t`` in epoch nanoseconds (``time.time_ns()``'s
        clock, which ``torch.profiler`` stamps), anchored at the call,
        so the span log drifts with neither clock."""
        # timing: clock-source (the wall anchor of the span log)
        return time.time_ns() - round((self.now() - t) * 1e9)

    def advance(self, dt: float) -> None:
        pass                        # real time advances on its own


class VirtualClock(Clock):
    """Deterministic manual time: the discrete-event tests and the sync
    ``PlanServer.serve`` loop own every tick."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time moves forward")
        self._t += dt

    def advance_to(self, t: float) -> None:
        self._t = max(self._t, float(t))


# ------------------------------------------------------------- SLO classes
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service-level class: the relative deadline budget a request of
    this class is promised, and what to do when admission prices that
    promise as unmeetable."""
    name: str
    budget_s: "float | None"            # None: best effort, no deadline
    on_unmeetable: str = "downgrade"    # "downgrade" | "refuse"

    def __post_init__(self):
        if self.on_unmeetable not in ("downgrade", "refuse"):
            raise ValueError(self.on_unmeetable)


def default_slo_classes() -> dict:
    return {
        "interactive": SLOClass("interactive", 0.5),
        "standard": SLOClass("standard", 5.0),
        "batch": SLOClass("batch", None),
    }


@dataclasses.dataclass
class RuntimeConfig:
    max_batch: int = 16
    max_wait: float = 0.005          # hard cap on batch-forming wait
    lanes: int = 1                   # parallel solve lanes.  Each lane
    # is ONE serial executor (worker thread in thread mode, modeled
    # occupancy queue in inline mode) with its own BatchedSolver;
    # executable-bucket placement is lane-affine (the lane that compiled
    # a (n, cost) bucket keeps serving it) and deadline-promised works
    # steal onto a less-backlogged lane when the home lane would miss.
    wait_solve_frac: float = 0.5     # wait <= frac * priced solve time
    deadline_safety: float = 2.0     # price estimates with this margin
    max_pending: int = 1 << 20       # backpressure: refuse misses past it
    trace: bool = True               # per-request span trees (obs)
    trace_sample: float = 1.0        # span head-sampling rate (1.0 = all;
    # incident capture — shed/error/deadline-miss — is unconditional
    # regardless of sampling, see obs.trace.Tracer)
    # per-tenant SLO quotas: {tenant: tenancy.TenantQuota}.  None/empty
    # disables tenant metering (every tenant unmetered).
    tenant_quotas: "dict | None" = None
    slo_classes: dict = dataclasses.field(
        default_factory=default_slo_classes)
    # --- resilience (service.faults).  Retries are per solve
    # unit on its current ladder rung, with capped exponential backoff
    # that never eats past the tightest ticket's deadline headroom.
    max_retries: int = 2
    retry_backoff: float = 1e-3      # first backoff; doubles per attempt
    retry_backoff_cap: float = 0.05
    # a dispatch is declared hung after max(watchdog_min, factor * the
    # EWMA-priced solve).  The floor guards the cold-EWMA case (tiny
    # first estimates would otherwise abandon healthy dispatches);
    # factor <= 0 disables the watchdog entirely.
    watchdog_factor: float = 8.0
    watchdog_min: float = 2.0
    verify_plans: bool = True        # plan-cost recheck (garbage guard)
    quarantine_ttl: float = 30.0     # poisoned-key containment TTL
    breaker: "faults_mod.BreakerConfig" = dataclasses.field(
        default_factory=faults_mod.BreakerConfig)


# --------------------------------------------------------------- telemetry
@dataclasses.dataclass
class ClassStats:
    served: int = 0
    deadline_misses: int = 0
    downgraded: int = 0
    shed: int = 0
    latency: "object" = None        # LatencyHistogram, lazily attached

    def summary(self) -> dict:
        h = self.latency
        return {"served": self.served,
                "deadline_misses": self.deadline_misses,
                "downgraded": self.downgraded, "shed": self.shed,
                "p50_ms": round(h.percentile(50) * 1e3, 4),
                "p95_ms": round(h.percentile(95) * 1e3, 4),
                "p99_ms": round(h.percentile(99) * 1e3, 4)}


@dataclasses.dataclass
class RuntimeStats:
    submitted: int = 0
    served: int = 0
    fast_path_hits: int = 0
    overtakes: int = 0          # fast-path answers with a solve in flight
    coalesced: int = 0          # tickets joined onto an in-flight/queued solve
    downgraded: int = 0         # deadline-unmeetable -> best-effort lane
    shed: int = 0               # refused: unmeetable deadline (refuse class)
    shed_backpressure: int = 0  # refused: pending queue over max_pending
    batches: int = 0            # batch-lane works started
    batched_items: int = 0      # solve items across those works (occupancy)
    solve_s: float = 0.0        # batched-miss execution seconds
    steals: int = 0             # works stolen off a backlogged home lane
    hedges: int = 0             # half-open probes hedged with a host shadow
    lane_dispatches: dict = dataclasses.field(default_factory=dict)
    lane_steals: dict = dataclasses.field(default_factory=dict)
    per_class: dict = dataclasses.field(default_factory=dict)
    hit_latency: "object" = None    # fast-path LatencyHistogram (lazy)

    @property
    def mean_batch_occupancy(self) -> float:
        return self.batched_items / self.batches if self.batches else 0.0

    @property
    def coalesce_rate(self) -> float:
        return self.coalesced / self.submitted if self.submitted else 0.0

    @property
    def shed_rate(self) -> float:
        return ((self.shed + self.shed_backpressure) / self.submitted
                if self.submitted else 0.0)

    @property
    def deadline_misses(self) -> int:
        return sum(c.deadline_misses for c in self.per_class.values())

    def klass(self, name: str) -> ClassStats:
        cs = self.per_class.get(name)
        if cs is None:
            from repro_torch.service.server import LatencyHistogram
            cs = ClassStats(latency=LatencyHistogram())
            self.per_class[name] = cs
        return cs

    def hits_hist(self):
        if self.hit_latency is None:
            from repro_torch.service.server import LatencyHistogram
            self.hit_latency = LatencyHistogram()
        return self.hit_latency

    @property
    def mean_solve_s(self) -> float:
        """Mean batched-miss execution time — what a fast-path hit
        overtakes."""
        return self.solve_s / self.batches if self.batches else 0.0

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted, "served": self.served,
            "fast_path_hits": self.fast_path_hits,
            "overtakes": self.overtakes, "coalesced": self.coalesced,
            "coalesce_rate": round(self.coalesce_rate, 4),
            "downgraded": self.downgraded, "shed": self.shed,
            "shed_backpressure": self.shed_backpressure,
            "shed_rate": round(self.shed_rate, 4),
            "batches": self.batches,
            "mean_batch_occupancy": round(self.mean_batch_occupancy, 3),
            "steals": self.steals, "hedges": self.hedges,
            "lanes": {str(k): {"dispatches":
                               self.lane_dispatches.get(k, 0),
                               "steals": self.lane_steals.get(k, 0)}
                      for k in sorted(set(self.lane_dispatches)
                                      | set(self.lane_steals))},
            "deadline_misses": self.deadline_misses,
            "solve_s": round(self.solve_s, 4),
            "miss_solve_ms_mean": round(self.mean_solve_s * 1e3, 4),
            "hit_p99_ms": round(
                (self.hit_latency.percentile(99) * 1e3)
                if self.hit_latency is not None else 0.0, 4),
            "per_class": {k: v.summary()
                          for k, v in sorted(self.per_class.items())},
        }


# ----------------------------------------------------------------- tickets
@dataclasses.dataclass
class Ticket:
    """One submitted request's handle: filled in place on completion."""
    request: "object"                   # PlanRequest
    form: "object"                      # CanonicalForm
    route: "object | None" = None       # Route that will/did serve it
    slo: str = "default"
    submitted: float = 0.0
    deadline: "float | None" = None
    downgraded: bool = False
    done: bool = False
    refused: bool = False
    refuse_reason: str = ""
    error: "BaseException | None" = None   # solve failure, if any
    response: "object | None" = None    # PlanResponse (None if refused)
    completed_at: float = 0.0
    # --- tracing (obs): the request's span tree and lane flags.
    # The flags reconstruct the lane's expected span count so the tracer
    # can self-check every tree's shape.
    span: "object | None" = None        # root Span (or NULL_SPAN)
    spans: dict = dataclasses.field(default_factory=dict)
    queued: bool = False                # sat in a forming bucket
    coalesced_join: bool = False        # joined another entry's solve
    dispatched: bool = False            # a dispatch span was opened
    admit_spans: int = 0                # admit's children opened
    seeds: int = 0                      # seed spans (layer-cache probes)
    lane_waits: int = 0                 # lane_wait spans (one an attempt)
    dispatch_attrs: "dict | None" = None  # the next dispatch span's attrs
    price_est: float = 0.0              # router's solve estimate at start
    # --- resilience: the response contract and its provenance
    status: str = "exact"               # "exact" | "degraded" | "error"
    faulted: bool = False               # saw a failure/retry/failover
    extra_spans: int = 0                # beyond-taxonomy spans (retries)

    @property
    def latency(self) -> float:
        return self.completed_at - self.submitted


class _Entry:
    """One canonical solve unit in a bucket: the leader ticket plus any
    coalesced followers (same full cache key, different labelings).

    ``rung`` is the entry's position on the FAILURE ladder (0: routed
    lane, 1: host-exact, 2: GOO best-effort); ``attempts`` counts
    completed solve attempts on the current rung."""

    __slots__ = ("key", "tickets", "attempts", "rung")

    def __init__(self, key, ticket):
        self.key = key
        self.tickets = [ticket]
        self.attempts = 0
        self.rung = 0


class _Bucket:
    __slots__ = ("entries", "close_at")

    def __init__(self):
        self.entries: list = []
        self.close_at: "float | None" = None


class _Work:
    """A closed batch (or a single-lane solve) in execution."""

    __slots__ = ("kind", "entries", "started", "eta", "results",
                 "timings", "future", "duration", "error", "est",
                 "profile", "breaker_key", "probe", "engine", "fault",
                 "hung_at", "abandoned", "finalized", "lane", "stolen",
                 "hedge_partner", "layer_seeds", "seed", "began", "begun")

    def __init__(self, kind, entries, started):
        self.kind = kind                 # "batch" | "single"
        self.entries = entries
        self.started = started
        self.eta: "float | None" = None  # completion in clock time
        self.results = None
        self.timings = None
        self.future = None
        self.duration = 0.0
        self.error: "BaseException | None" = None
        self.est = 0.0                   # priced estimate (backlog model)
        self.profile = ()                # engine DispatchRecords attributed
        # --- resilience bookkeeping
        self.breaker_key = ""            # engine-lane breaker key ("": none)
        self.probe = False               # half-open breaker probe dispatch
        self.engine: "str | None" = None  # ladder engine override ("host")
        self.fault = None                # armed FaultSpec (hang/garbage)
        self.hung_at: "float | None" = None  # watchdog deadline
        self.abandoned = False           # watchdog rerouted the tickets
        self.finalized = False           # finish already processed
        # --- N-lane scheduling
        self.lane: "int | None" = None   # executor lane ("None": unpicked)
        self.stolen = False              # placed off its affinity home
        self.hedge_partner: "_Work | None" = None  # racing hedge work
        self.layer_seeds = 0             # items warm-started by layercache
        self.seed = None                 # a single solve's seed payload
        # --- lane wait: the clock time the lane began the work (stamped
        # by the lane itself) and whether its spans moved on to dispatch
        self.began: "float | None" = None
        self.begun = False


# ------------------------------------------------------------------ runtime
class ServingRuntime:
    """Event-driven deadline-aware scheduler over one ``PlanServer``.

    ``executor="inline"`` runs solves on the driving thread and models a
    single-executor queue in clock time — the deterministic mode the
    sync ``serve`` loop and the VirtualClock tests use.
    ``executor="thread"`` runs solves on a worker thread (WallClock
    serving: the async front end keeps answering hits while a dispatch
    executes).

    ``duration_fn(kind, info) -> float | None`` overrides how long a
    piece of work *takes* in clock time (``kind`` in ``{"admit",
    "solve", "single"}``; ``info`` has ``n``/``cost``/``items`` where
    known).  ``None`` falls back to the measured wall time — the
    default, which is what the sync ``serve`` loop and the benchmark use;
    deterministic tests inject constants.
    """

    def __init__(self, server, clock: "Clock | None" = None,
                 config: "RuntimeConfig | None" = None,
                 duration_fn=None, executor: str = "inline",
                 injector: "faults_mod.FaultInjector | None" = None):
        if executor not in ("inline", "thread"):
            raise ValueError(f"unknown executor {executor!r}")
        self.server = server
        self.clock = clock or WallClock()
        self.config = config or RuntimeConfig()
        self.duration_fn = duration_fn
        self.executor = executor
        self.stats = RuntimeStats()
        self.recorder = FlightRecorder()
        # --- resilience (service.faults): per-lane breakers,
        # poisoned-key quarantine, counters, and (tests/chaos only) the
        # seeded fault injector wired to the runtime's real seams
        self.injector = injector
        self.breakers = faults_mod.BreakerBoard(self.clock,
                                                self.config.breaker)
        self.quarantine = faults_mod.Quarantine(
            self.clock, self.config.quarantine_ttl)
        self.fstats = faults_mod.FaultStats()
        self._hook_installed = False
        if injector is not None:
            # the engine's program-build seam is process-global; one
            # injector-driven runtime at a time (tests, chaos runs)
            engine_mod.set_compile_fault_hook(injector.compile_fault)
            self._hook_installed = True
        self.tracer = Tracer(self.clock,
                             registry=getattr(server, "registry", None),
                             recorder=self.recorder,
                             enabled=self.config.trace,
                             sample_rate=self.config.trace_sample)
        # per-tenant SLO quotas (service.tenancy): None when no
        # quotas are configured — the submit ladder skips the gate
        self.quotas = None
        if self.config.tenant_quotas:
            self.quotas = tenancy_mod.QuotaBoard(self.clock,
                                                 self.config.tenant_quotas)
        reg = getattr(server, "registry", None)
        if reg is not None:
            reg.register_provider("runtime", self.stats.as_dict)
            reg.register_provider("tracer", self.tracer.stats)
            reg.register_provider("recorder", self.recorder.snapshot)
            reg.register_provider("faults", self._faults_snapshot)
            if self.quotas is not None:
                reg.register_provider("tenancy", self.quotas.snapshot)
        self._buckets: dict = {}         # (n, lane_cost) -> _Bucket
        self._by_key: dict = {}          # cache key -> _Entry (pending+flight)
        self._inflight: list = []        # _Work being executed / in window
        self._zombies: list = []         # abandoned thread works (watchdog)
        self._events: list = []          # heap of (t, seq, kind, payload)
        self._seq = itertools.count()
        self._pending_tickets = 0
        # --- N-lane execution: each lane is one serial executor with
        # its own solver; placement is affinity-first with deadline-
        # driven work stealing (see _pick_lane)
        self.lanes = max(1, int(self.config.lanes))
        self._lane_free = [0.0] * self.lanes  # per-lane modeled queues
        self._pools: list = [None] * self.lanes  # lazy worker pools
        self._affinity: dict = {}        # (n, lane_cost) -> home lane
        self._rr = 0                     # round-robin tiebreak cursor
        self._solvers: "list | None" = None  # lazy per-lane solvers

    def _faults_snapshot(self) -> dict:
        snap = {**self.fstats.as_dict(),
                "breakers": self.breakers.snapshot(),
                "quarantine": self.quarantine.snapshot()}
        if self.injector is not None:
            snap["injector"] = self.injector.snapshot()
        return snap

    # ------------------------------------------------------------ helpers
    def _charge(self, kind: str, measured: float, info: dict) -> float:
        """Clock-time cost of a piece of work: the injected duration if
        a ``duration_fn`` gives one, else the measured wall time."""
        if self.duration_fn is not None:
            d = self.duration_fn(kind, info)
            if d is not None:
                return float(d)
        return measured

    def _schedule(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def next_event_time(self) -> "float | None":
        while self._events:
            t, _, kind, payload = self._events[0]
            if kind == "close":
                b = self._buckets.get(payload)
                if b is None or b.close_at is None or b.close_at != t:
                    heapq.heappop(self._events)   # stale timer
                    continue
            elif kind == "watchdog" and (payload.finalized
                                         or payload.abandoned):
                heapq.heappop(self._events)       # work already resolved
                continue
            return t
        return None

    def _lane_backlog(self, lane: int) -> float:
        """One lane's backlog in clock seconds: how long until work
        started on it *now* would begin.  Inline mode knows it exactly
        from the modeled executor queue; thread mode prices the lane's
        in-flight works' EWMA estimates (their real durations aren't
        known until the worker finishes them)."""
        if self.executor == "thread":
            return sum(w.est for w in self._inflight if w.lane == lane)
        return max(0.0, self._lane_free[lane] - self.clock.now())

    def _backlog(self) -> float:
        """Best-case executor backlog: the least-loaded lane's queue —
        work admitted now could start there (stealing makes that true
        even for affinity-bound buckets with a deadline at stake)."""
        return min(self._lane_backlog(k) for k in range(self.lanes))

    def _solver_for(self, lane: int):
        """Lane ``k``'s BatchedSolver.  Lane 0 IS the server's solver
        (the single-lane runtime and the sync front end share it —
        including its counters and any test monkeypatching); lanes 1..N
        get their own solvers so their locks, timing snapshots and
        engine-dispatch attribution never interleave across lanes."""
        if lane == 0 or self.lanes == 1:
            return self.server.solver
        if self._solvers is None:
            from repro_torch.service.batch import BatchedSolver
            base = self.server.solver
            self._solvers = [base] + [
                BatchedSolver(base.policy, device=base.device, lane=k)
                for k in range(1, self.lanes)]
        return self._solvers[lane]

    def _lane_counter(self, lane: int, what: str) -> None:
        reg = getattr(self.server, "registry", None)
        if reg is not None:
            reg.counter(f"runtime.lane{lane}.{what}").inc()

    def _least_loaded(self) -> int:
        """Least-backlogged lane, weighted by the router's per-lane
        speed factor; a round-robin cursor breaks ties so cold lanes
        all get seeded instead of lane 0 absorbing every first
        sighting."""
        router = self.server.router
        best, best_cost = 0, None
        for i in range(self.lanes):
            k = (self._rr + i) % self.lanes
            c = self._lane_backlog(k) * router.lane_factor(k)
            if best_cost is None or c < best_cost - 1e-12:
                best, best_cost = k, c
        self._rr = (self._rr + 1) % self.lanes
        return best

    def _pick_lane(self, work: _Work) -> int:
        """Lane placement.  Affinity first: the lane that compiled an
        ``(n, lane_cost)`` executable bucket keeps serving it (prewarm
        partitions buckets across lanes; re-placing a bucket elsewhere
        would pay its program build again).  Work stealing second: when a
        deadline-promised work would miss waiting out its home lane's
        backlog, it runs on the least-loaded lane instead — a steal
        risks one compile, a miss breaks a promise."""
        if self.lanes == 1:
            return 0
        lead = work.entries[0].tickets[0]
        key = (lead.form.q.n, lead.route.lane_cost)
        home = self._affinity.get(key)
        if home is None:
            home = self._affinity[key] = self._least_loaded()
        deadlines = [t.deadline for e in work.entries for t in e.tickets
                     if t.deadline is not None and not t.downgraded]
        if deadlines:
            now = self.clock.now()
            need = (now + self._lane_backlog(home)
                    + self.config.deadline_safety * work.est)
            if need > min(deadlines):
                alt = self._least_loaded()
                if alt != home and (
                        now + self._lane_backlog(alt)
                        + self.config.deadline_safety * work.est) < need:
                    work.stolen = True
                    self.stats.steals += 1
                    self.stats.lane_steals[alt] = \
                        self.stats.lane_steals.get(alt, 0) + 1
                    self._lane_counter(alt, "steals")
                    return alt
        return home

    @staticmethod
    def _expected_spans(ticket: Ticket, fast: bool = False,
                        refused: bool = False) -> int:
        """How many spans this ticket's lane SHOULD have produced — the
        tracer compares against the actual tree (shape self-check).
        fast path: request/admit/fast_path/respond.  Miss: request +
        admit + optional queue_wait + optional coalesce + dispatch,
        then extract+respond (served) or shed (refused).  Retried and
        failed-over solves open one extra dispatch span per additional
        attempt (``ticket.extra_spans``).  On top: admit's children
        (canonicalize, probe, route), one seed span per layer-cache
        probe and one lane_wait span per dispatch attempt."""
        n = ticket.admit_spans + ticket.seeds + ticket.lane_waits
        if fast:
            return n + 4
        n += (2 + ticket.queued + ticket.coalesced_join
              + ticket.dispatched + ticket.extra_spans)
        return n + (1 if refused else 2)

    @staticmethod
    def _admit_child(ticket: Ticket, name: str,
                     at: "float | None" = None):
        """Open one of admit's children (kept in ``ticket.spans``, so a
        refusal closes it with the rest)."""
        ticket.admit_spans += 1
        s = ticket.spans[name] = ticket.spans["admit"].child(name, at=at)
        return s

    def _seed(self, ticket: Ticket):
        """The layer-cache seed probe of ``ticket``'s solve, as a seed
        span."""
        ticket.seeds += 1
        sp = ticket.span.child("seed")
        seed = self.server._layer_seed(ticket.form, ticket.request.cost,
                                       ticket.route)
        sp.close()
        return seed

    # ------------------------------------------------------------- submit
    def submit(self, req) -> Ticket:
        """Admit one request at ``clock.now()``: fast-path answer,
        coalesce, enqueue, downgrade or refuse.  Never blocks on a
        solve."""
        srv = self.server
        now = self.clock.now()
        t_wall = time.perf_counter()   # timing: measured-duration (admit)
        self.stats.submitted += 1

        card = np.asarray(req.card, np.float64)
        form = canonicalize(req.q, card)
        t_canon = self.clock.now()
        slo = None
        if getattr(req, "slo", None):
            slo = self.config.slo_classes.get(req.slo)
            if slo is None:
                raise ValueError(f"unknown SLO class {req.slo!r}")
        ticket = Ticket(request=req, form=form, submitted=now,
                        slo=slo.name if slo else "default")
        span_attrs = {}
        tenant = getattr(req, "tenant", None)
        if tenant is not None:
            span_attrs["tenant"] = tenant
        replica = getattr(srv, "replica_id", "")
        if replica:
            span_attrs["replica"] = replica
        ticket.span = self.tracer.request(
            at=now, req_id=req.req_id, slo=ticket.slo, cost=req.cost,
            n=form.q.n, **span_attrs)
        ticket.spans["admit"] = ticket.span.child("admit", at=now)
        self._admit_child(ticket, "canonicalize", at=now).close(at=t_canon)
        budget = req.latency_budget
        if budget is None and slo is not None:
            budget = slo.budget_s
        if budget is not None:
            ticket.deadline = now + budget

        # ---- per-tenant SLO quota gate (service.tenancy): one
        # token per admission.  "shed" refuses before any solve work;
        # "downgrade" is applied below as a forced best-effort route (a
        # cache hit still answers — it costs the cluster nothing);
        # "promote" is priority aging — a starved batch-class request
        # adopts the standard class's deadline so the deadline-priority
        # machinery serves it.
        quota_downgrade = False
        if self.quotas is not None and tenant is not None:
            decision = self.quotas.admit(tenant)
            if decision == "shed":
                return self._refuse(
                    ticket, f"tenant {tenant!r} over quota")
            if decision == "promote":
                if budget is None:
                    std = self.config.slo_classes.get("standard")
                    if std is not None and std.budget_s is not None:
                        budget = std.budget_s
                        ticket.deadline = now + budget
            elif decision == "downgrade":
                quota_downgrade = True

        # ---- the shared admission ladder (same helpers as _process, so
        # the sync/async bit-parity contract has ONE implementation):
        # primary-route cache probe first — a cached plan replays in
        # ~zero time, overtaking any in-flight miss.  An injected cache
        # backend error fails OPEN: it degrades to a miss (the solve
        # path still answers), never to a request failure.
        probe_span = self._admit_child(ticket, "probe")
        if (self.injector is not None
                and self.injector.arm("cache") is not None):
            self.fstats.cache_faults += 1
            ticket.faulted = True
            primary = srv.router.route(
                form.q, req.cost, None, signature=form.signature,
                connected=req.connected)
            resp = None
        else:
            primary, resp = srv._primary_probe(req, form)
        probe_span.close()
        ticket.route = primary
        if resp is not None:
            self._finish_ticket(
                ticket, resp, fast=True,
                admit_s=self._charge(
                    # timing: measured-duration (admit)
                    "admit", time.perf_counter() - t_wall,
                    {"n": form.q.n, "cost": req.cost}))
            return ticket

        route_span = self._admit_child(ticket, "route")
        # ---- quarantine: a poisoned canonical key (repeated solo solve
        # failures) is refused with a typed error until its TTL expires.
        # The probe above still serves cached plans — quarantine guards
        # the SOLVE path, where the key has proven it kills workers.
        if self.quarantine.active((form.key, req.cost)):
            self.fstats.quarantine_refusals += 1
            return self._fail_ticket(
                ticket,
                faults_mod.QuarantinedError(
                    "canonical key quarantined after repeated solo "
                    "solve failures", req_id=req.req_id),
                kind="quarantine")

        # ---- deadline-aware routing (the router's degrade ladder, plus the
        # runtime's backlog-aware pricing on top).  A quota downgrade
        # preempts it: the tenant's overflow rides the GOO best-effort
        # lane regardless of its deadline headroom.
        route = primary
        if quota_downgrade:
            route = srv.router.failure_fallback(
                req.cost, f"tenant {tenant!r} over quota")
            ticket.downgraded = True
            self.stats.downgraded += 1
            self.stats.klass(ticket.slo).downgraded += 1
        elif budget is not None:
            route, resp = srv._budget_reroute(req, form, budget, primary)
            if "deadline" not in route.reason and route.lane == "batch":
                # the router prices the solve alone; the runtime also
                # knows the executor backlog and the batch wait it
                # would add — refuse/degrade if the total cannot land
                est = srv.router.price(
                    route.method, form.q.n, route.lane, route.lane_cost,
                    router_mod.topo_class(form.signature))
                need = self.config.deadline_safety * est + self._backlog()
                if need > budget:
                    route, resp = srv._budget_reroute(req, form, 1e-300,
                                                      primary)
            if "deadline" in route.reason:
                if resp is None and slo is not None \
                        and slo.on_unmeetable == "refuse":
                    # (a cached degraded plan beats refusing: it lands
                    # inside any deadline for free)
                    return self._refuse(ticket, "deadline unmeetable")
                ticket.downgraded = True
                self.stats.downgraded += 1
                self.stats.klass(ticket.slo).downgraded += 1
                srv.stats.deadline_fallbacks += 1
            if resp is not None:
                ticket.route = route
                self._finish_ticket(
                    ticket, resp, fast=True,
                    admit_s=self._charge(
                        # timing: measured-duration (admit)
                        "admit", time.perf_counter() - t_wall,
                        {"n": form.q.n, "cost": req.cost}))
                return ticket
        ticket.route = route

        # ---- backpressure: a bounded admission queue
        if self._pending_tickets >= self.config.max_pending:
            self.stats.shed_backpressure += 1
            return self._refuse(ticket, "backpressure: queue full",
                                backpressure=True)

        # ---- failure-driven ladder at admission: an OPEN lane breaker
        # reroutes before the solve is queued (fused -> host-exact ->
        # GOO best-effort); a HALF-OPEN lane admits a solo probe whose
        # outcome restores or re-opens the lane.  Zero-fault runs never
        # touch breaker state: allow() on an unknown lane is a dict get.
        engine_override: "str | None" = None
        probe = False
        if route.method != "goo":
            ok, probe = self.breakers.allow(
                self._breaker_key(route, form.q.n))
            if not ok:
                self.fstats.breaker_rejections += 1
                ticket.faulted = True
                ok, probe = self.breakers.allow(
                    f"host:{route.lane_cost}:n={form.q.n}")
                if ok:
                    self.fstats.failover_host += 1
                    engine_override = "host"
                else:
                    self.fstats.breaker_rejections += 1
                    self.fstats.failover_goo += 1
                    probe = False
                    route = srv.router.failure_fallback(
                        req.cost, "lane breaker open")
                    ticket.route = route

        route_span.close()
        self.clock.advance(self._charge(
            # timing: measured-duration (admit)
            "admit", time.perf_counter() - t_wall,
            {"n": form.q.n, "cost": req.cost}))
        ticket.spans["admit"].close(lane=route.lane, method=route.method)

        if engine_override is not None:
            self._start_single(ticket, engine=engine_override,
                               probe=probe)
        elif probe:
            # half-open probe: solo dispatch, skip the batch former so
            # one probe risks one request (hedged across lanes when the
            # runtime has a lane to spare)
            self._start_probe(ticket)
        elif srv.enable_batch and srv._batch_eligible(route, req.cost):
            self._enqueue(ticket)
        else:
            self._start_single(ticket)
        return ticket

    def _refuse(self, ticket: Ticket, reason: str,
                backpressure: bool = False) -> Ticket:
        ticket.done = True
        ticket.refused = True
        ticket.refuse_reason = reason
        ticket.status = "error"
        if ticket.error is None:
            ticket.error = faults_mod.ShedError(
                reason, backpressure=backpressure)
        ticket.completed_at = self.clock.now()
        if not backpressure:
            self.stats.shed += 1
        self.stats.klass(ticket.slo).shed += 1
        root = ticket.span
        if root is not None:
            now = self.clock.now()
            for s in ticket.spans.values():
                s.close(at=now)
            root.child("shed", at=now, reason=reason,
                       backpressure=backpressure).close(at=now)
            self.tracer.finish(
                root, expected_spans=self._expected_spans(ticket,
                                                          refused=True))
        # always-on incident capture, traced or not
        self.recorder.incident(
            "shed", self._live_span(root),
            reason=reason, req_id=ticket.request.req_id, slo=ticket.slo,
            backpressure=backpressure, at=ticket.completed_at)
        return ticket

    def _live_span(self, root):
        """The span to attach to an incident: None when tracing is off
        OR the request was head-sampled out (NULL_SPAN carries no tree)
        — the incident itself is still recorded unconditionally."""
        return root if (self.tracer.enabled and root is not None
                        and root is not NULL_SPAN) else None

    def _fail_ticket(self, ticket: Ticket, err: BaseException,
                     kind: str = "error") -> Ticket:
        """Terminal typed failure (quarantine refusal, or a solve that
        exhausted the whole failure ladder): the ticket resolves to a
        typed error — never an exception out of the event loop, and
        never counted as a deadline/backpressure shed."""
        err = faults_mod.as_plan_error(err)
        ticket.done = True
        ticket.refused = True
        ticket.error = err
        ticket.status = "error"
        ticket.refuse_reason = f"{kind}: {err}"
        ticket.completed_at = self.clock.now()
        self.fstats.typed_errors += 1
        root = ticket.span
        if root is not None:
            now = self.clock.now()
            for s in ticket.spans.values():
                s.close(at=now)
            root.child("shed", at=now, reason=ticket.refuse_reason,
                       error=type(err).__name__).close(at=now)
            self.tracer.finish(
                root, expected_spans=self._expected_spans(ticket,
                                                          refused=True))
        self.recorder.incident(
            kind, self._live_span(root),
            reason=ticket.refuse_reason, req_id=ticket.request.req_id,
            slo=ticket.slo, at=ticket.completed_at)
        return ticket

    # -------------------------------------------------- queue & coalesce
    def _enqueue(self, ticket: Ticket) -> None:
        req, form, route = ticket.request, ticket.form, ticket.route
        key = PlanCache.make_key(form.key, req.cost, route.method,
                                 route.params)
        # bucket on the LANE cost ("cap_conn" when the connected flag is
        # set): a connected-cap solve must never share a lockstep batch
        # with an unconstrained cap solve — different lattice programs.
        nc = (form.q.n, route.lane_cost)
        entry = self._by_key.get(key)
        if entry is not None:
            # join-on-completion: the same canonical solve is already
            # queued or in flight — ride it (each ticket still replays
            # the result through its own inverse permutation).  A
            # follower with a tighter deadline still gets to shrink the
            # bucket's wait: its headroom binds like a leader's would.
            entry.tickets.append(ticket)
            self.stats.coalesced += 1
            self._pending_tickets += 1
            ticket.coalesced_join = True
            ticket.span.child(
                "coalesce", followers=len(entry.tickets) - 1,
                leader_req=entry.tickets[0].request.req_id).close()
            bucket = self._buckets.get(nc)
            if bucket is not None and entry in bucket.entries:
                ticket.queued = True
                ticket.spans["queue_wait"] = ticket.span.child("queue_wait")
                self._tighten(bucket, nc, ticket)
            else:
                # joined a solve already executing: no queue wait — the
                # dispatch span covers the remaining in-flight time
                ticket.dispatched = True
                ticket.spans["dispatch"] = ticket.span.child(
                    "dispatch", joined_in_flight=True)
            return
        entry = _Entry(key, ticket)
        self._by_key[key] = entry
        self._pending_tickets += 1
        ticket.queued = True
        ticket.spans["queue_wait"] = ticket.span.child("queue_wait")
        bucket = self._buckets.get(nc)
        if bucket is None:
            bucket = self._buckets[nc] = _Bucket()
        bucket.entries.append(entry)
        if len(bucket.entries) >= self.config.max_batch:
            self._close_bucket(nc)
            return
        self._tighten(bucket, nc, ticket)

    def _tighten(self, bucket: _Bucket, nc, ticket: Ticket) -> None:
        close_at = self.clock.now() + self._wait_budget(ticket)
        if bucket.close_at is None or close_at < bucket.close_at:
            bucket.close_at = close_at
            self._schedule(close_at, "close", nc)

    def _wait_budget(self, ticket: Ticket) -> float:
        """How long this ticket can afford to sit in the batch former:
        at most ``wait_solve_frac`` of the priced solve (per-bucket
        adaptive: waiting longer than the solve itself costs more than
        batching saves), hard-capped by ``max_wait``, and never eating
        the deadline budget after solve + backlog are accounted."""
        route, form = ticket.route, ticket.form
        est = self.server.router.price(
            route.method, form.q.n, route.lane, route.lane_cost,
            router_mod.topo_class(form.signature))
        w = min(self.config.max_wait, self.config.wait_solve_frac * est)
        if ticket.deadline is not None:
            headroom = ((ticket.deadline - self.clock.now())
                        - self.config.deadline_safety * est
                        - self._backlog())
            w = min(w, max(headroom, 0.0))
        return max(w, 0.0)

    # --------------------------------------------------------- execution
    def _close_bucket(self, nc) -> None:
        bucket = self._buckets.pop(nc, None)
        if bucket is None or not bucket.entries:
            return
        n, cost = nc
        entries = bucket.entries
        self.stats.batches += 1
        self.stats.batched_items += len(entries)
        now = self.clock.now()
        work = _Work("batch", entries, now)
        for e in entries:
            for t in e.tickets:
                qw = t.spans.get("queue_wait")
                if qw is not None:
                    qw.close(at=now)
        # the 5th item slot is the layer-cache seed payload: solved
        # fragments of isomorphic sub-problems warm-start the lattice
        # program (bit-identical results, fewer search rounds)
        items = [(e.tickets[0].form.q, e.tickets[0].form.card,
                  cost,
                  router_mod.topo_class(e.tickets[0].form.signature),
                  self._seed(e.tickets[0]))
                 for e in entries]
        work.layer_seeds = sum(1 for it in items if it[4] is not None)
        self._start(work, items)

    def _start_single(self, ticket: Ticket, engine: "str | None" = None,
                      probe: bool = False) -> _Work:
        entry = _Entry(None, ticket)
        if engine == "host":
            entry.rung = 1      # admission failover: next stop is GOO
        self._pending_tickets += 1
        work = _Work("single", [entry], self.clock.now())
        work.engine = engine
        work.probe = probe
        self._start(work, None)
        return work

    def _start_probe(self, ticket: Ticket) -> None:
        """Half-open breaker probe dispatch.  Single lane: the plain
        solo probe (one probe risks one request).  With N lanes the
        probe is HEDGED: the probe runs on its home lane while a
        host-exact shadow of the same solve starts on the next lane —
        the first finisher answers the ticket and the loser is zombie-
        dropped through the existing watchdog accounting, so a probe on
        a still-broken lane no longer costs the probing request the
        whole failure ladder.  (A dropped probe still settles its
        breaker outcome — see _settle_zombie_breaker.)"""
        probe_work = self._start_single(ticket, probe=True)
        if self.lanes <= 1 \
                or ticket.route.method not in ("dpconv", "dpccp"):
            return          # hedging needs a lane to spare and a host
        self.stats.hedges += 1          # rung distinct from the probe's
        entry = _Entry(None, ticket)
        entry.rung = 1                  # the shadow IS the host rung
        hedge = _Work("single", [entry], self.clock.now())
        hedge.engine = "host"
        hedge.lane = (probe_work.lane + 1) % self.lanes
        hedge.hedge_partner = probe_work
        probe_work.hedge_partner = hedge
        # NB: no _pending_tickets bump — the ticket is counted once and
        # completed once (by whichever leg finishes first)
        self._start(hedge, None)

    def _breaker_key(self, route, n: int,
                     engine: "str | None" = None) -> str:
        """Engine-lane breaker key: ``fused:n=8``, ``fused:cap_conn:
        n=6``, ``host:cap:n=15``, ``dpsub:n=5``... — per-n buckets of
        the engine tag the dispatch will actually run."""
        if engine == "host":
            return f"host:{route.lane_cost}:n={n}"
        tag = self.server.router.engine_tag(
            route.method, n, route.lane, route.lane_cost) or route.method
        return f"{tag}:n={n}"

    def _hung_threshold(self, work: _Work) -> float:
        f = self.config.watchdog_factor
        if f <= 0:
            return 0.0
        return max(self.config.watchdog_min, f * work.est)

    def _start(self, work: _Work, items) -> None:
        self._inflight.append(work)
        lead = work.entries[0].tickets[0]
        if work.kind == "single" and work.engine is None:
            # host rungs drop seeds
            work.seed = self._seed(lead)
            work.layer_seeds = int(work.seed is not None)
        work.est = self.server.router.price(
            lead.route.method, lead.form.q.n, lead.route.lane,
            lead.route.lane_cost,
            router_mod.topo_class(lead.form.signature))
        if lead.route.method != "goo":
            work.breaker_key = self._breaker_key(
                lead.route, lead.form.q.n, engine=work.engine)
        if work.lane is None:           # hedges arrive pre-placed
            work.lane = self._pick_lane(work)
        self.stats.lane_dispatches[work.lane] = \
            self.stats.lane_dispatches.get(work.lane, 0) + 1
        self._lane_counter(work.lane, "dispatches")
        now = self.clock.now()
        for entry in work.entries:
            for t in entry.tickets:
                t.price_est = work.est
                qw = t.spans.get("queue_wait")
                if qw is not None:
                    qw.close(at=now)
                d = t.spans.get("dispatch")
                lw = t.spans.get("lane_wait")
                if (d is None or not d.open) and (lw is None
                                                  or not lw.open):
                    if d is not None:
                        # retry / ladder failover: a fresh dispatch
                        # attempt, accounted so the lane-shape self-
                        # check still pins the tree exactly
                        t.extra_spans += 1
                    t.dispatched = True
                    # each attempt waits for its lane (lane_wait), then
                    # runs (dispatch, opened by _begin when the lane
                    # begins the work)
                    t.lane_waits += 1
                    t.spans["lane_wait"] = t.span.child(
                        "lane_wait", at=now, lane=work.lane)
                    t.dispatch_attrs = dict(
                        kind=work.kind, items=len(work.entries),
                        est_s=work.est, attempt=entry.attempts,
                        rung=entry.rung, engine=work.engine or "",
                        lane=work.lane, stolen=work.stolen)
        if self.executor == "thread":
            wd = self._hung_threshold(work)
            if wd:
                work.hung_at = now + self._lane_backlog(work.lane) + wd
                self._schedule(work.hung_at, "watchdog", work)
            work.future = self._ensure_pool(work.lane).submit(
                self._execute, work, items)
            return
        t_sched = self.clock.now()      # scheduling time, pre-execution
        measured = self._execute(work, items)
        info = {"items": len(work.entries),
                "n": lead.form.q.n, "cost": lead.request.cost}
        kind = "solve" if work.kind == "batch" else "single"
        dur = self._charge(kind, measured, info)
        wd = self._hung_threshold(work)
        if work.fault is not None and work.fault.kind == "hang":
            # injected stall: the dispatch "completes" far past the
            # hung threshold — the watchdog reroutes the tickets and
            # the zombie's eventual finish is dropped
            dur = max(dur, work.fault.hang_s or (4.0 * wd if wd else 1.0))
        work.duration = dur
        # per-lane serial queue in clock time: work starts when its
        # lane frees, exactly like the worker thread it stands for.
        # On a VirtualClock now() hasn't moved during execution, so eta
        # = start + dur; on a WallClock the solve's wall time already
        # elapsed — the max() keeps it from being charged twice.
        start = max(t_sched, self._lane_free[work.lane])
        self._begin(work, start)
        work.eta = max(self.clock.now(), start + dur)
        self._lane_free[work.lane] = work.eta
        self._schedule(work.eta, "finish", work)
        if wd:
            work.hung_at = start + wd
            if work.eta > work.hung_at:
                # only actually-hung works get a watchdog event: the
                # zero-fault path schedules nothing extra
                self._schedule(work.hung_at, "watchdog", work)

    def _execute(self, work: _Work, items) -> float:
        """Run the solve (caller thread or worker thread); returns the
        measured wall seconds.  A solve failure is CONTAINED: it lands
        on ``work.error`` (finalize fails the work's tickets loudly and
        cleans up) instead of wedging the runtime — an exception must
        never leave a joined entry stuck in ``_by_key`` collecting
        coalescers that can never complete."""
        srv = self.server
        work.began = self.clock.now()   # the lane begins: lane_wait ends
        solver = self._solver_for(work.lane or 0)
        t0 = time.perf_counter()   # timing: measured-duration (solve)
        mark = engine_mod.dispatch_mark()
        try:
            self._inject_before(work)
            # stamp this work's lane onto every DispatchRecord the solve
            # emits (single solves; the batch solver re-asserts its own
            # lane, which is the same value)
            with engine_mod.dispatch_lane(work.lane):
                if work.kind == "batch":
                    handle = solver.submit(items)
                    work.results = solver.collect(handle)
                    work.timings = handle.timings
                else:
                    ticket = work.entries[0].tickets[0]
                    work.results = [srv._solve_single(
                        ticket.form.q, ticket.form.card,
                        ticket.request.cost, ticket.route,
                        engine=work.engine, seed=work.seed)]
            self._inject_after(work)
        except BaseException as e:       # noqa: BLE001 — contained: the
            work.error = e               # failure ladder reroutes per entry
        # attribute the engine's per-dispatch profile records (program
        # cache hit, build/execute split, rounds, work count) to this work
        work.profile = engine_mod.dispatches_since(mark)
        return time.perf_counter() - t0  # timing: measured-duration

    def _inject_before(self, work: _Work) -> None:
        """Arm the pre-solve fault seams (chaos/test runs only).  The
        GOO rung is exempt: it runs plain host python, not a solver
        dispatch — it is the ladder's reliable floor."""
        inj = self.injector
        if inj is None:
            return
        if work.entries[0].tickets[0].route.method == "goo":
            return
        if inj.arm("worker") is not None:
            raise faults_mod.WorkerDied("injected: executor worker died")
        spec = inj.arm("dispatch")
        if spec is not None:
            if spec.kind == "raise":
                raise faults_mod.EngineError("injected: dispatch raised")
            work.fault = spec           # hang / garbage: applied later

    def _inject_after(self, work: _Work) -> None:
        """Apply a ``garbage`` fault: corrupt the first result's
        reported optimum.  The plan-cost recheck in ``_finalize`` must
        catch it before it reaches the cache or a caller."""
        spec = work.fault
        if spec is None or spec.kind != "garbage":
            return
        if work.kind == "batch":
            res = work.results[0]
            res.cost = float(res.cost) * 1.5 + 1.0
        else:
            cost_v, tree, meta = work.results[0]
            work.results[0] = (float(cost_v) * 1.5 + 1.0, tree, meta)

    def _ensure_pool(self, lane: int = 0):
        if self._pools[lane] is None:
            from concurrent.futures import ThreadPoolExecutor
            # one worker per lane: a lane is a SERIAL executor, so N
            # lanes = N single-worker pools, not one N-worker pool —
            # the backlog model and lane-affine placement depend on it
            self._pools[lane] = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"plan-runtime-lane{lane}")
        return self._pools[lane]

    # -------------------------------------------------------- completion
    def _begin(self, work: _Work, at: float) -> None:
        """The lane began ``work`` at clock time ``at``: each of its
        tickets' open lane_wait span closes there and its dispatch span
        opens there.  Runs on the driving thread (spans are never opened
        or closed on a lane's thread, which only stamps ``work.began``),
        once a work; a ticket two hedged works share moves on once."""
        if work.begun:
            return
        work.begun = True
        for entry in work.entries:
            for t in entry.tickets:
                lw = t.spans.get("lane_wait")
                if lw is not None and lw.open:
                    lw.close(at=at)
                    t.spans["dispatch"] = t.span.child(
                        "dispatch", at=at, **(t.dispatch_attrs or {}))

    def _dispatch_attrs(self, work: _Work) -> dict:
        """Aggregate the work's attributed engine DispatchRecords into
        the dispatch span's attributes (build/execute split, rounds,
        program cache hits, work count — per request)."""
        lead = work.entries[0].tickets[0]
        attrs = {"engine_tag": self.server.router.engine_tag(
                     lead.route.method, lead.form.q.n, lead.route.lane,
                     lead.route.lane_cost),
                 "duration_s": work.duration, "est_s": work.est,
                 "items": len(work.entries), "lane": work.lane}
        if work.stolen:
            attrs["stolen"] = True
        if work.hedge_partner is not None:
            attrs["hedged"] = True
        if work.layer_seeds:
            attrs["layer_seeds"] = work.layer_seeds
        prof = work.profile
        if prof:
            attrs.update(
                dispatches=len(prof),
                aot_cache_hits=sum(r.aot_cache_hit for r in prof),
                compile_s=sum(r.compile_s for r in prof),
                execute_s=sum(r.execute_s for r in prof),
                rounds=sum(r.rounds for r in prof),
                flops=sum(r.flops for r in prof),
                bytes_accessed=sum(r.bytes_accessed for r in prof))
        return attrs

    def _finalize(self, work: _Work) -> None:
        srv = self.server
        if work.abandoned:
            # a zombie completed: the watchdog (or a winning hedge
            # partner) already resolved its tickets — drop the late
            # result on the floor, but still settle a probe's breaker
            # outcome so the half-open lane can't wedge
            self.fstats.zombie_completions += 1
            self._settle_zombie_breaker(work)
            return
        self._inflight.remove(work)
        work.finalized = True
        now = self.clock.now()
        self._begin(work, now if work.began is None else work.began)
        if work.kind == "batch":
            self.stats.solve_s += work.duration
        if work.error is not None:
            self._fail_work(work, work.error)
            return
        srv.router.observe_lane(work.lane, work.duration)
        attrs = self._dispatch_attrs(work)
        partner = work.hedge_partner
        if partner is not None:
            # hedged probe race resolved: this leg finished first —
            # drop the other leg before its result can double-complete
            # the shared ticket
            work.hedge_partner = None
            self._abandon_hedge(partner)
        for entry in work.entries:
            for t in entry.tickets:
                d = t.spans.get("dispatch")
                if d is not None:
                    d.close(at=now, **attrs)
        # garbage detector: the cheap plan-cost recheck — a result whose
        # reported optimum disagrees with its own tree never reaches the
        # cache (``_complete_entry`` inserts) or a caller
        bad: list = []
        if work.kind == "batch":
            if work.timings:
                srv._observe_batch(work.timings)
            for entry, res in zip(work.entries, work.results):
                if self._verify(entry, float(res.cost), res.tree):
                    self._complete_entry(entry, float(res.cost),
                                         res.tree, dict(res.meta), now)
                else:
                    bad.append(entry)
        else:
            entry = work.entries[0]
            ticket = entry.tickets[0]
            cost_v, tree, meta = work.results[0]
            srv._observe_single(ticket.route, ticket.form,
                                ticket.request.cost, work.duration,
                                meta)
            if self._verify(entry, float(cost_v), tree):
                self._complete_entry(entry, cost_v, tree, meta, now)
            else:
                bad.append(entry)
        if not bad:
            if work.breaker_key:
                self.breakers.on_success(work.breaker_key,
                                         probe=work.probe)
            return
        self.fstats.garbage_caught += len(bad)
        if work.breaker_key:
            self.breakers.on_failure(work.breaker_key, probe=work.probe)
        err = faults_mod.EngineError(
            "garbage output: plan-cost recheck failed against the "
            "returned tree")
        self.recorder.incident(
            "error", None, error=repr(err), work_kind=work.kind,
            items=len(bad), at=now)
        solo = work.kind == "single" or len(work.entries) == 1
        for entry in bad:
            self._descend(entry, err, solo=solo)

    def _verify(self, entry: _Entry, cost_v: float, tree) -> bool:
        """Recompute the claimed optimum from the returned tree.
        ``C_max`` must match bitwise (the parity contract); cap/out
        trees realize their reported cost to float tolerance; approx/
        GOO (certified, not bit-exact) and tree-less results are not
        checkable here."""
        if not self.config.verify_plans or tree is None:
            return True
        lead = entry.tickets[0]
        if lead.route.method in ("goo", "approx"):
            return True
        cost = lead.request.cost
        card = lead.form.card
        try:
            if cost == "max":
                return float(tree.cost_max(card)) == cost_v
            if cost in ("cap", "out"):
                got = float(tree.cost_out(card))
            elif cost == "smj":
                got = float(tree.cost_smj(card))
            else:
                return True
        except Exception:                # noqa: BLE001 — a tree that
            return False                 # can't price itself IS garbage
        return abs(got - cost_v) <= 1e-9 * max(1.0, abs(cost_v))

    # ------------------------------------------------- failure ladder
    def _fail_work(self, work: _Work, err: BaseException,
                   hung: bool = False) -> None:
        """Entry point for a failed (or hung) dispatch: record the lane
        breaker, then send every solve unit down the failure ladder
        (isolation retry -> same-rung backoff retry -> host-exact ->
        GOO best-effort -> typed error)."""
        err = faults_mod.as_plan_error(err)
        if work in self._inflight:
            self._inflight.remove(work)
        now = self.clock.now()
        self._begin(work, now if work.began is None else work.began)
        if hung:
            work.abandoned = True
            if self.executor == "thread":
                self._zombies.append(work)
            elif work.eta is not None:
                # recycle the modeled lane: the hung worker is killed
                # and replaced; the zombie's remaining occupancy is
                # refunded so later works don't queue behind it
                self._lane_free[work.lane] = max(
                    now,
                    self._lane_free[work.lane] - max(work.eta - now, 0.0))
        else:
            work.finalized = True
        if work.breaker_key:
            self.breakers.on_failure(work.breaker_key, probe=work.probe)
            work.breaker_key = ""    # settled — the zombie path must
            #                          not record a second outcome
        partner = work.hedge_partner
        if partner is not None and not partner.finalized \
                and not partner.abandoned:
            # hedged probe race: this leg failed but its partner is
            # still in flight and owns the shared ticket — bow out
            # without descending the failure ladder (if the partner
            # fails too, ITS failure descends normally)
            partner.hedge_partner = None
            work.hedge_partner = None
            self.recorder.incident(
                "watchdog" if hung else "error", None, error=repr(err),
                work_kind=work.kind, hedge_loser=True, at=now)
            return
        self.recorder.incident(
            "watchdog" if hung else "error", None, error=repr(err),
            work_kind=work.kind, items=len(work.entries), at=now)
        for entry in work.entries:
            for t in entry.tickets:
                d = t.spans.get("dispatch")
                if d is not None:
                    d.close(at=now, error=repr(err), hung=hung)
        solo = work.kind == "single" or len(work.entries) == 1
        for entry in list(work.entries):
            self._descend(entry, err, solo=solo)

    def _descend(self, entry: _Entry, err: "faults_mod.PlanError",
                 solo: bool) -> None:
        """One solve unit's next step on the failure ladder."""
        cfg = self.config
        lead = entry.tickets[0]
        now = self.clock.now()
        for t in entry.tickets:
            t.faulted = True
        entry.attempts += 1
        if not solo:
            # a batch failed: retry each unit SOLO first — isolation
            # both recovers the healthy peers and identifies the
            # poisoned one (it does not consume a backoff retry)
            entry.attempts = 0
            self.fstats.isolation_retries += 1
            self._schedule(now, "retry", entry)
            return
        if entry.attempts <= cfg.max_retries:
            backoff = min(
                cfg.retry_backoff * (2 ** max(entry.attempts - 1, 0)),
                cfg.retry_backoff_cap)
            if self._retry_affordable(entry, backoff):
                self.fstats.retries += 1
                self._schedule(now + backoff, "retry", entry)
                return
            self.fstats.retry_denied_headroom += 1
        if entry.rung == 0:
            # repeated SOLO failure on the primary rung: the canonical
            # key is poisoned — quarantine it so it can never take down
            # batch peers again (attempts >= 2 means it failed alone at
            # least once; a headroom-denied first retry proves nothing)
            if entry.attempts >= 2:
                qk = (lead.form.key, lead.request.cost)
                self.quarantine.add(qk, reason=repr(err))
                self.fstats.quarantined += 1
                self.recorder.incident(
                    "quarantine", None, req_id=lead.request.req_id,
                    reason=repr(err), at=now)
            entry.rung = 1
            entry.attempts = 0
            ok, probe = self.breakers.allow(
                f"host:{lead.route.lane_cost}:n={lead.form.q.n}")
            if ok:
                self.fstats.failover_host += 1
                self._start_entry(entry, probe=probe)
                return
            self.fstats.breaker_rejections += 1
        if entry.rung <= 1:
            entry.rung = 2
            entry.attempts = 0
            self.fstats.failover_goo += 1
            route = self.server.router.failure_fallback(
                lead.request.cost, type(err).__name__)
            for t in entry.tickets:
                t.route = route
            self._start_entry(entry)
            return
        # the GOO floor itself failed: terminal typed error
        if entry.key is not None:
            self._by_key.pop(entry.key, None)
        for t in entry.tickets:
            self._pending_tickets -= 1
            self._fail_ticket(t, err)

    def _abandon_hedge(self, loser: _Work) -> None:
        """The hedge race resolved against this in-flight work: drop it
        as a zombie.  Its eventual completion hits the ``abandoned``
        branch of ``_finalize`` (inline: the scheduled finish event;
        thread: the zombie drain in ``poll``) and is discarded — same
        accounting as a watchdog-killed worker."""
        if loser.finalized or loser.abandoned:
            return
        loser.abandoned = True
        loser.hedge_partner = None
        if loser in self._inflight:
            self._inflight.remove(loser)
        if self.executor == "thread":
            self._zombies.append(loser)
        elif loser.eta is not None:
            now = self.clock.now()
            self._lane_free[loser.lane] = max(
                now,
                self._lane_free[loser.lane] - max(loser.eta - now, 0.0))

    def _settle_zombie_breaker(self, work: _Work) -> None:
        """A dropped work holding a lane's single half-open probe slot
        must still report its outcome — ``BreakerBoard.allow`` admits no
        further probes while one is charged out, so an unreported probe
        wedges the lane half-open forever.  Losing the hedge race says
        nothing bad about the probed lane: report the leg's own result
        (success if its solve worked).  Watchdog-hung works were already
        settled by ``_fail_work`` (which clears the key)."""
        if not work.breaker_key:
            return
        if work.error is None:
            self.breakers.on_success(work.breaker_key, probe=work.probe)
        else:
            self.breakers.on_failure(work.breaker_key, probe=work.probe)
        work.breaker_key = ""

    def _retry_affordable(self, entry: _Entry, backoff: float) -> bool:
        """Never retry past remaining headroom: the backoff plus the
        safety-priced solve must land inside every promised deadline."""
        deadlines = [t.deadline for t in entry.tickets
                     if t.deadline is not None and not t.downgraded]
        if not deadlines:
            return True
        est = entry.tickets[0].price_est
        need = (self.clock.now() + backoff + self._backlog()
                + self.config.deadline_safety * est)
        return need <= min(deadlines)

    def _start_entry(self, entry: _Entry, probe: bool = False) -> None:
        """(Re)dispatch one solve unit solo — retries and ladder rungs
        all land here, single-flight for the whole coalesced group."""
        work = _Work("single", [entry], self.clock.now())
        if entry.rung == 1:
            work.engine = "host"
        work.probe = probe
        self._start(work, None)

    def _complete_entry(self, entry, cost_v, tree, meta, now) -> None:
        srv = self.server
        if entry.key is not None:
            self._by_key.pop(entry.key, None)
        for i, ticket in enumerate(entry.tickets):
            m = dict(meta)
            if i:
                m["coalesced"] = True
            ex = ticket.span.child("extract", insert=(i == 0))
            resp = srv._complete(ticket.request, ticket.form,
                                 ticket.route, cost_v, tree, m,
                                 insert=(i == 0))
            ex.close()
            self._pending_tickets -= 1
            self._finish_ticket(ticket, resp)

    def _finish_ticket(self, ticket: Ticket, resp, fast: bool = False,
                       admit_s: float = 0.0) -> None:
        root = ticket.span
        if fast:
            route_span = ticket.spans.get("route")
            if route_span is not None:
                route_span.close()
            self.clock.advance(admit_s)
            self.stats.fast_path_hits += 1
            self.stats.hits_hist().record(max(admit_s, 1e-9))
            overtake = bool(self._inflight)
            if overtake:            # answered past an executing solve
                self.stats.overtakes += 1
            ticket.spans["admit"].close()
            root.child("fast_path", overtake=overtake).close()
        ticket.done = True
        ticket.completed_at = self.clock.now()
        ticket.response = resp
        ticket.status = getattr(resp, "status", "exact")
        resp.latency = ticket.latency
        cs = self.stats.klass(ticket.slo)
        cs.served += 1
        cs.latency.record(ticket.latency)
        self.stats.served += 1
        if self.quotas is not None:
            tenant = getattr(ticket.request, "tenant", None)
            if tenant is not None:
                self.quotas.record_served(tenant)
        missed = (ticket.deadline is not None and not ticket.downgraded
                  and ticket.completed_at > ticket.deadline)
        if missed:
            cs.deadline_misses += 1
        if fast:
            meta = resp.meta
            meta["fast_path"] = True
        root.child("respond", latency_s=ticket.latency).close()
        self.tracer.finish(
            root, expected_spans=self._expected_spans(ticket, fast=fast))
        live = self._live_span(root)
        if missed:
            self.recorder.incident(
                "deadline_miss", live, req_id=ticket.request.req_id,
                slo=ticket.slo, late_s=ticket.completed_at - ticket.deadline)
        if ticket.downgraded:
            self.recorder.incident(
                "downgraded", live, req_id=ticket.request.req_id,
                slo=ticket.slo, reason=ticket.route.reason)
        if getattr(ticket.request, "explain", False):
            e = resp.explain if isinstance(resp.explain, dict) else \
                self.server._explain_base(ticket.request, ticket.form,
                                          ticket.route, cache_hit=fast)
            e.update({
                "slo": ticket.slo, "deadline": ticket.deadline,
                "fast_path": fast, "degraded": ticket.downgraded,
                "coalesced": bool(resp.meta.get("coalesced")),
                "queued": ticket.queued,
                "price_est_s": ticket.price_est,
                "latency_s": ticket.latency,
                "deadline_missed": missed,
                "spans": root.count(),
                "span_tree": root.shape() if self.tracer.enabled else None,
            })
            resp.explain = e

    # ------------------------------------------------------------ driving
    def poll(self) -> int:
        """Process every event due at (or before) ``clock.now()``, plus
        any finished worker-thread solves.  Returns the number of events
        processed."""
        done = 0
        if self.executor == "thread":
            for work in list(self._inflight):
                if work.began is not None:
                    self._begin(work, work.began)
                if work.future is not None and work.future.done():
                    work.duration = work.future.result()
                    work.future = None
                    self._finalize(work)
                    done += 1
            for work in list(self._zombies):
                if work.future is None or work.future.done():
                    self._zombies.remove(work)
                    work.future = None
                    self.fstats.zombie_completions += 1
                    self._settle_zombie_breaker(work)
        now = self.clock.now()
        while True:
            t = self.next_event_time()
            if t is None or t > now:
                break
            _, _, kind, payload = heapq.heappop(self._events)
            if kind == "close":
                self._close_bucket(payload)
            elif kind == "retry":
                self._start_entry(payload)
            elif kind == "watchdog":
                if not (payload.finalized or payload.abandoned):
                    self.fstats.watchdog_fires += 1
                    self._fail_work(
                        payload,
                        faults_mod.PlanTimeoutError(
                            "watchdog: dispatch declared hung",
                            est_s=payload.est,
                            threshold_s=self._hung_threshold(payload)),
                        hung=True)
            else:
                self._finalize(payload)
            done += 1
        return done

    def run_until(self, t: float) -> None:
        """Advance a ``VirtualClock`` through every event up to ``t``
        (events fire AT their times, in order), leaving the clock at
        ``t``."""
        while True:
            et = self.next_event_time()
            if et is None or et > t:
                break
            self.clock.advance_to(et)
            self.poll()
        self.clock.advance_to(t)

    def flush(self) -> None:
        """Close every forming bucket now (partial batches included)."""
        for nc in list(self._buckets):
            self._close_bucket(nc)

    def drain(self) -> None:
        """Flush, then run every queued/in-flight piece of work to
        completion, advancing a VirtualClock through the events (or
        waiting them out on a WallClock)."""
        self.flush()
        while self._inflight or self._events or self._buckets:
            t = self.next_event_time()
            if t is not None:
                if isinstance(self.clock, VirtualClock):
                    self.clock.advance_to(t)
                elif t > self.clock.now():
                    time.sleep(min(t - self.clock.now(), 0.002))
            elif self.executor == "thread" and self._inflight:
                time.sleep(2e-4)
            elif not self._events:
                if self._buckets:
                    self.flush()
                    continue
                break
            if self.poll() == 0 and t is None and not self._inflight:
                break

    def prewarm_lanes(self, ns, costs=("max", "cap", "out")) -> dict:
        """Partition the server's prewarm buckets round-robin across the
        lanes: bucket ``(n, cost)`` compiles under lane ``k``'s dispatch
        attribution AND seeds the affinity map, so the lane that
        compiled a bucket is the lane its traffic lands on — prewarm
        cost is split across lanes instead of serialized, and steady-
        state placement starts warm."""
        srv = self.server
        total = {"compiled": 0, "seconds": 0.0, "lanes": {}}
        pairs = [(n, c) for c in costs for n in sorted(set(ns))]
        for i, (n, c) in enumerate(pairs):
            k = i % self.lanes
            with engine_mod.dispatch_lane(k):
                r = srv.prewarm([n], costs=(c,))
            if r.get("compiled"):
                self._affinity[(n, c)] = k
                total["lanes"][f"{c}:n={n}"] = k
            total["compiled"] += r["compiled"]
            total["seconds"] += r["seconds"]
        return total

    def close(self) -> None:
        for k, pool in enumerate(self._pools):
            if pool is not None:
                pool.shutdown(wait=True)
                self._pools[k] = None
        if self._hook_installed:
            engine_mod.set_compile_fault_hook(None)
            self._hook_installed = False
