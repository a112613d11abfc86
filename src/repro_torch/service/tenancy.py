"""Per-tenant SLO quotas: token-bucket admission with priority aging (a
copy of ``repro.service.tenancy``, its arithmetic unchanged; stdlib only).

The serving runtime treats every request alike; a single hot tenant can
therefore starve the rest of the fleet's promised-deadline traffic.
This module adds the missing isolation layer, in two halves that share
one piece of state — per-tenant deny rates:

* **``QuotaBoard``** (server side, wired into
  ``runtime.ServingRuntime.submit``): a deterministic token bucket per
  tenant.  Each admitted request spends one token; tokens refill at
  ``rate`` per second up to ``burst``.  An empty bucket triggers the
  tenant's ``on_exceed`` policy — ``"shed"`` (typed refusal) or
  ``"downgrade"`` (the request is rerouted onto the GOO best-effort
  lane with a cost certificate, exactly like a deadline downgrade).
  **Priority aging**: a tenant that has been denied continuously for
  ``aging_s`` seconds gets its next request *promoted* — admitted
  without a token, and (if the request is batch-class, i.e. carries no
  deadline) upgraded to the ``standard`` SLO class so it rides the
  deadline-priority machinery instead of starving forever.

* **``AdmissionCeilings``** (client side, for the cluster router, which
  the port does not carry yet): per-tenant pass fractions fed back from
  the replicas' observed shed/downgrade rates (``QuotaBoard.snapshot``
  -> ``deny_rate``).  A tenant the cluster is shedding at rate ``r``
  gets a client-side ceiling of ``max(floor, 1 - r)``: the router
  pre-sheds the excess before it crosses the network, so over-quota
  traffic stops consuming replica admission work.  Pass decisions are
  counter-based (``k``-th request passes iff ``floor(k * f)`` advanced),
  so they are deterministic — no RNG, bit-identical replays.

Time comes EXCLUSIVELY from the injected ``Clock`` (token refill,
aging); this module reads no ``time.*``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract.

    ``rate`` is the sustained admissions/second the tenant is promised;
    ``burst`` is the bucket depth (how far above the sustained rate a
    quiet tenant may spike).  ``on_exceed`` picks what an empty bucket
    does to the overflow: ``"shed"`` refuses with a typed ``ShedError``,
    ``"downgrade"`` serves best-effort (GOO lane, ``status="degraded"``).
    ``aging_s``: deny the tenant continuously for this long and its next
    request promotes past the bucket (None disables aging)."""

    name: str
    rate: float
    burst: float = 8.0
    on_exceed: str = "shed"          # "shed" | "downgrade"
    aging_s: "float | None" = None

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError("rate must be > 0")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if self.on_exceed not in ("shed", "downgrade"):
            raise ValueError(f"unknown on_exceed {self.on_exceed!r}")
        if self.aging_s is not None and self.aging_s <= 0:
            raise ValueError("aging_s must be > 0")


@dataclasses.dataclass
class TenantStats:
    admitted: int = 0
    shed: int = 0
    downgraded: int = 0
    promoted: int = 0           # aged past an empty bucket
    served: int = 0             # responses delivered (runtime-reported)
    deny_ewma: float = 0.0      # EWMA of the deny indicator per decision

    @property
    def decisions(self) -> int:
        return self.admitted + self.shed + self.downgraded + self.promoted

    def as_dict(self) -> dict:
        return {"admitted": self.admitted, "shed": self.shed,
                "downgraded": self.downgraded, "promoted": self.promoted,
                "served": self.served,
                "deny_rate": round(self.deny_ewma, 4)}


class _Bucket:
    __slots__ = ("tokens", "refilled_at", "denied_since")

    def __init__(self, burst: float, now: float):
        self.tokens = burst
        self.refilled_at = now
        self.denied_since: "float | None" = None


class QuotaBoard:
    """Deterministic per-tenant token buckets against a ``Clock``.

    ``admit(tenant)`` returns one of ``"admit"``, ``"shed"``,
    ``"downgrade"``, ``"promote"``; tenants without a configured quota
    are unmetered (always ``"admit"``).  The deny-rate EWMA feeds the
    client-side ``AdmissionCeilings`` through ``snapshot()``."""

    def __init__(self, clock, quotas: "dict[str, TenantQuota] | None",
                 ewma_alpha: float = 0.2):
        self.clock = clock
        self.quotas = dict(quotas or {})
        self.ewma_alpha = ewma_alpha
        self._buckets: dict = {}
        self.stats: "dict[str, TenantStats]" = {}

    def _stats(self, tenant: str) -> TenantStats:
        st = self.stats.get(tenant)
        if st is None:
            st = self.stats[tenant] = TenantStats()
        return st

    def _observe(self, st: TenantStats, denied: bool) -> None:
        a = self.ewma_alpha
        st.deny_ewma = (1 - a) * st.deny_ewma + a * (1.0 if denied else 0.0)

    def admit(self, tenant: str) -> str:
        quota = self.quotas.get(tenant)
        if quota is None:
            return "admit"                  # unmetered tenant
        now = self.clock.now()
        st = self._stats(tenant)
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = _Bucket(quota.burst, now)
        else:
            b.tokens = min(quota.burst,
                           b.tokens + (now - b.refilled_at) * quota.rate)
            b.refilled_at = now
        if b.tokens >= 1.0:
            b.tokens -= 1.0
            b.denied_since = None
            st.admitted += 1
            self._observe(st, denied=False)
            return "admit"
        if quota.aging_s is not None and b.denied_since is not None \
                and now - b.denied_since >= quota.aging_s:
            # priority aging: the starvation clock restarts so ONE
            # request promotes per aging window, not the whole backlog
            b.denied_since = now
            st.promoted += 1
            self._observe(st, denied=False)
            return "promote"
        if b.denied_since is None:
            b.denied_since = now
        self._observe(st, denied=True)
        if quota.on_exceed == "downgrade":
            st.downgraded += 1
            return "downgrade"
        st.shed += 1
        return "shed"

    def record_served(self, tenant: str) -> None:
        self._stats(tenant).served += 1

    def deny_rate(self, tenant: str) -> float:
        st = self.stats.get(tenant)
        return st.deny_ewma if st is not None else 0.0

    def snapshot(self) -> dict:
        return {"tenants": {t: st.as_dict()
                            for t, st in sorted(self.stats.items())},
                "quotas": {t: {"rate": q.rate, "burst": q.burst,
                               "on_exceed": q.on_exceed,
                               "aging_s": q.aging_s}
                           for t, q in sorted(self.quotas.items())}}


class AdmissionCeilings:
    """Client-side tenant admission ceilings for the cluster router.

    ``update(tenant, deny_rate)`` folds one replica-observed deny rate
    into the tenant's pass fraction ``f = max(floor, 1 - deny_rate)``;
    ``admit(tenant)`` passes the ``k``-th request iff the integer part
    of ``k * f`` advanced — an arithmetic (deterministic) rate limiter
    that spreads passes evenly through the stream."""

    def __init__(self, floor: float = 0.1):
        if not 0.0 < floor <= 1.0:
            raise ValueError("floor must be in (0, 1]")
        self.floor = floor
        self._frac: dict = {}
        self._seen: dict = {}
        self.client_shed = 0

    def update(self, tenant: str, deny_rate: float) -> None:
        # ``1.0 - deny_rate`` as in the reference, rounding included, so
        # the port admits exactly what the reference admits (a caller
        # passing ``1 - f`` gets back f - 1 ulp for some f, e.g. 0.08)
        self._frac[tenant] = max(self.floor,
                                 1.0 - max(0.0, min(1.0, deny_rate)))

    def ceiling(self, tenant: str) -> float:
        return self._frac.get(tenant, 1.0)

    def admit(self, tenant: "str | None") -> bool:
        if tenant is None:
            return True
        f = self._frac.get(tenant, 1.0)
        if f >= 1.0:
            return True
        k = self._seen.get(tenant, 0) + 1
        self._seen[tenant] = k
        ok = int(k * f) > int((k - 1) * f)
        if not ok:
            self.client_shed += 1
        return ok

    def snapshot(self) -> dict:
        return {"ceilings": {t: round(f, 4)
                             for t, f in sorted(self._frac.items())},
                "client_shed": self.client_shed}
