"""Deterministic fault injection + the resilience primitives it exercises
(a copy of ``repro.service.faults``; stdlib only).

The serving runtime's failure story before this module: a solve error
failed its coalesced tickets and the loop kept going — nothing retried,
nothing noticed a hung dispatch, and the router's degradation ladder
only fired on deadline pressure.  This module supplies the missing
pieces, all deterministic so chaos schedules replay bit-for-bit:

* **typed error taxonomy** (``PlanError`` and friends) — every terminal
  failure a request can see is a typed, inspectable error instead of a
  bare exception string.
* **``FaultPlan`` / ``FaultInjector``** — a seeded schedule of faults at
  the runtime's real seams (``dispatch`` raise/hang/garbage, ``compile``
  failure at the engine's build seam, ``cache`` backend error, ``worker``
  death).  One ``random.Random(seed)`` draw per matching spec per
  arming: given the same event order — which a ``VirtualClock`` plus
  injected durations guarantees — the same faults fire at the same
  points every run.
* **``BreakerBoard``** — per-engine-lane circuit breakers (keys like
  ``fused:n=8``, ``fused:cap_conn:n=6``) with the classic closed /
  open / half-open state machine: ``failure_threshold`` consecutive
  failures open a lane, traffic falls through the *failure-driven* rung
  of the router ladder (fused -> host-exact -> GOO best-effort with a
  cost certificate), and after ``cooldown_s`` a half-open probe either
  restores the lane or re-opens it.
* **``Quarantine``** — poisoned-request containment: a canonical key
  whose solve fails even solo is quarantined with a TTL so it can never
  take down batch peers again.

Time comes EXCLUSIVELY from the injected ``Clock`` (breaker cooldowns,
quarantine TTLs, fault timestamps): this module reads no ``time.*``.
"""
from __future__ import annotations

import dataclasses
import random


# ----------------------------------------------------------- error taxonomy
class PlanError(Exception):
    """Base of the typed planning-failure taxonomy.  ``context`` holds
    structured fields (seam, attempts, lane...) for telemetry."""

    code = "error"

    def __init__(self, msg: str = "", **context):
        super().__init__(msg)
        self.context = context


class EngineError(PlanError):
    """A solver/engine dispatch failed (raised, or produced garbage that
    the plan-cost recheck caught)."""

    code = "engine"


class WorkerDied(EngineError):
    """An executor worker died mid-solve."""

    code = "worker_died"


class CompileError(EngineError):
    """The build of a lattice program (a bucket's executable) failed."""

    code = "compile"


class CacheBackendError(PlanError):
    """The plan-cache backend errored (degrades to a cache miss)."""

    code = "cache"


class PlanTimeoutError(PlanError):
    """A dispatch was declared hung by the watchdog."""

    code = "timeout"


# the error taxonomy names this ``TimeoutError``; alias it so
# ``faults.TimeoutError`` reads naturally without shadowing the builtin
# inside this module's own code
TimeoutError = PlanTimeoutError


class QuarantinedError(PlanError):
    """The request's canonical key is quarantined (repeated solo solve
    failures) and is refused until the TTL expires."""

    code = "quarantined"


class ShedError(PlanError):
    """Refused at admission: backpressure or an unmeetable deadline."""

    code = "shed"


class NetworkError(PlanError):
    """A cluster network operation failed (partition, connect refusal,
    frame-level corruption).  The cluster client treats it as
    retriable: failover to the hash ring's next replica."""

    code = "net"


class ReplicaDeadError(NetworkError):
    """A replica process died (or was injected dead) — permanently
    routed around until the cluster restarts it."""

    code = "replica_dead"


def as_plan_error(exc: BaseException) -> PlanError:
    """Wrap an arbitrary failure into the typed taxonomy (idempotent)."""
    if isinstance(exc, PlanError):
        return exc
    e = EngineError(f"{type(exc).__name__}: {exc}", cause=repr(exc))
    e.__cause__ = exc
    return e


# ---------------------------------------------------------- fault injection
SEAMS = ("dispatch", "compile", "cache", "worker", "net", "replica")
KINDS = ("raise", "hang", "garbage")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault source: at ``seam``, with probability ``rate`` per
    arming, inject a fault of ``kind``.

    ``after`` skips the first N armings of this spec (lets a schedule
    place a deterministic burst mid-stream); ``max_fires`` caps how many
    times it fires (None = unlimited); ``hang_s`` is the injected stall
    for ``kind="hang"`` (0 = "longer than any watchdog", modeled as a
    multiple of the work's hung threshold)."""

    seam: str
    kind: str = "raise"
    rate: float = 1.0
    after: int = 0
    max_fires: "int | None" = None
    hang_s: float = 0.0

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable fault schedule."""

    seed: int = 0
    specs: tuple = ()

    @classmethod
    def chaos(cls, seed: int = 0, rate: float = 0.01) -> "FaultPlan":
        """The fixed chaos mix the chaos tests use:
        every seam, ``rate`` total fault probability per dispatch spread
        evenly across the six fault sources."""
        r = rate / 6.0
        return cls(seed=seed, specs=(
            FaultSpec("dispatch", "raise", r),
            FaultSpec("dispatch", "hang", r),
            FaultSpec("dispatch", "garbage", r),
            FaultSpec("compile", "raise", r),
            FaultSpec("cache", "raise", r),
            FaultSpec("worker", "raise", r),
        ))


class FaultInjector:
    """Draws faults from a ``FaultPlan`` deterministically.

    ``arm(seam)`` is called once per pass through a seam; it makes one
    RNG draw per matching spec (in plan order) and returns the first
    spec that fires, or None.  The draw sequence depends only on the
    arming sequence, so a VirtualClock run replays bit-for-bit."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._armed = [0] * len(plan.specs)      # armings per spec
        self._fires = [0] * len(plan.specs)      # fires per spec
        self.armed_total = 0
        self.fired_total = 0

    def arm(self, seam: str) -> "FaultSpec | None":
        hit = None
        for i, spec in enumerate(self.plan.specs):
            if spec.seam != seam:
                continue
            self.armed_total += 1
            seen = self._armed[i]
            self._armed[i] += 1
            u = self._rng.random()
            if hit is not None:
                continue            # draw anyway: keeps streams aligned
            if seen < spec.after:
                continue
            if spec.max_fires is not None \
                    and self._fires[i] >= spec.max_fires:
                continue
            if u < spec.rate:
                self._fires[i] += 1
                self.fired_total += 1
                hit = spec
        return hit

    def compile_fault(self, **ctx) -> None:
        """Engine program-build seam hook (``engine_mod.
        set_compile_fault_hook``): raises ``CompileError`` when a
        ``compile`` spec fires."""
        if self.arm("compile") is not None:
            raise CompileError("injected: AOT compile failure", **ctx)

    def snapshot(self) -> dict:
        per_spec = [
            {"seam": s.seam, "kind": s.kind, "rate": s.rate,
             "armed": self._armed[i], "fired": self._fires[i]}
            for i, s in enumerate(self.plan.specs)]
        return {"seed": self.plan.seed, "armed": self.armed_total,
                "fired": self.fired_total, "specs": per_spec}


# --------------------------------------------------------- circuit breakers
@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3    # consecutive failures that open a lane
    cooldown_s: float = 1.0       # open -> half-open after this long
    half_open_probes: int = 1     # concurrent probes allowed half-open


class _Lane:
    __slots__ = ("state", "failures", "opened_at", "probes", "opens",
                 "closes")

    def __init__(self):
        self.state = "closed"
        self.failures = 0           # consecutive failures while closed
        self.opened_at = 0.0
        self.probes = 0             # probes in flight while half-open
        self.opens = 0
        self.closes = 0


class BreakerBoard:
    """Per-lane circuit breakers keyed by engine-lane strings (e.g.
    ``fused:n=8``, ``fused:cap_conn:n=6``, ``host:cap:n=15``).

    ``allow(key) -> (admit, is_probe)``: closed lanes admit; open lanes
    refuse until ``cooldown_s`` elapses, then transition to half-open
    and admit up to ``half_open_probes`` probe dispatches.  A probe
    success closes the lane; a probe failure re-opens it."""

    def __init__(self, clock, config: "BreakerConfig | None" = None):
        self.clock = clock
        self.config = config or BreakerConfig()
        self.lanes: dict = {}
        self.opens = 0              # total closed/half-open -> open
        self.closes = 0             # total half-open -> closed

    def _lane(self, key: str) -> _Lane:
        ln = self.lanes.get(key)
        if ln is None:
            ln = self.lanes[key] = _Lane()
        return ln

    def state(self, key: str) -> str:
        ln = self.lanes.get(key)
        return ln.state if ln is not None else "closed"

    def allow(self, key: str) -> "tuple[bool, bool]":
        ln = self.lanes.get(key)
        if ln is None or ln.state == "closed":
            return True, False
        if ln.state == "open":
            if self.clock.now() - ln.opened_at < self.config.cooldown_s:
                return False, False
            ln.state = "half_open"
            ln.probes = 0
        # half-open: admit a bounded number of probes
        if ln.probes < self.config.half_open_probes:
            ln.probes += 1
            return True, True
        return False, False

    def on_success(self, key: str, probe: bool = False) -> None:
        ln = self.lanes.get(key)
        if ln is None:
            return          # healthy unknown lane: stays un-materialized
        ln.failures = 0
        if ln.state == "half_open" and probe:
            ln.state = "closed"
            ln.probes = 0
            ln.closes += 1
            self.closes += 1

    def on_failure(self, key: str, probe: bool = False) -> None:
        ln = self._lane(key)
        now = self.clock.now()
        if ln.state == "half_open":
            # the probe failed: straight back to open, fresh cooldown
            ln.state = "open"
            ln.opened_at = now
            ln.probes = 0
            ln.opens += 1
            self.opens += 1
            return
        if ln.state == "open":
            return
        ln.failures += 1
        if ln.failures >= self.config.failure_threshold:
            ln.state = "open"
            ln.opened_at = now
            ln.failures = 0
            ln.opens += 1
            self.opens += 1

    def open_lanes(self) -> "list[str]":
        return sorted(k for k, ln in self.lanes.items()
                      if ln.state != "closed")

    def snapshot(self) -> dict:
        return {"opens": self.opens, "closes": self.closes,
                "open_lanes": self.open_lanes(),
                "lanes": {k: {"state": ln.state,
                              "failures": ln.failures,
                              "opens": ln.opens, "closes": ln.closes}
                          for k, ln in sorted(self.lanes.items())}}


# --------------------------------------------------------------- quarantine
class Quarantine:
    """TTL'd containment for poisoned canonical keys: a request whose
    solve fails even solo is quarantined so it can never join (and take
    down) a batch again until the TTL expires.

    Boundary contract: a key added at ``t0`` is refused on the
    half-open interval ``[t0, t0 + ttl_s)`` — "refused *until* the TTL
    expires" — so a probe at exactly ``t0 + ttl_s`` is ADMITTED (and
    the entry is dropped).  ``active`` therefore tests ``now >=
    expires_at``, not ``>``; the deterministic VirtualClock boundary
    test pins this so an off-by-one can't creep back in."""

    def __init__(self, clock, ttl_s: float = 30.0):
        self.clock = clock
        self.ttl_s = ttl_s
        self._keys: dict = {}       # key -> (expires_at, reason)
        self.added = 0
        self.hits = 0               # refused admissions
        self.expired = 0

    def add(self, key, reason: str = "") -> None:
        self._keys[key] = (self.clock.now() + self.ttl_s, reason)
        self.added += 1

    def active(self, key) -> bool:
        ent = self._keys.get(key)
        if ent is None:
            return False
        if self.clock.now() >= ent[0]:
            # now == expires_at means the TTL has expired: admit
            del self._keys[key]
            self.expired += 1
            return False
        self.hits += 1
        return True

    def snapshot(self) -> dict:
        return {"ttl_s": self.ttl_s, "live": len(self._keys),
                "added": self.added, "hits": self.hits,
                "expired": self.expired}


# ----------------------------------------------------------------- counters
@dataclasses.dataclass
class FaultStats:
    """Runtime-side resilience counters (the ``faults`` registry
    provider)."""

    retries: int = 0                 # retry dispatches scheduled
    retry_denied_headroom: int = 0   # backoff would blow the deadline
    isolation_retries: int = 0       # batch-peer failures retried solo
    watchdog_fires: int = 0          # dispatches declared hung
    zombie_completions: int = 0      # abandoned works that later finished
    garbage_caught: int = 0          # plan-cost recheck failures
    failover_host: int = 0           # ladder rung: fused -> host-exact
    failover_goo: int = 0            # ladder rung: -> GOO best-effort
    breaker_rejections: int = 0      # admissions denied by an open lane
    quarantined: int = 0             # keys quarantined
    quarantine_refusals: int = 0     # requests refused while quarantined
    cache_faults: int = 0            # cache backend errors (-> miss)
    typed_errors: int = 0            # requests resolved to a PlanError

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
