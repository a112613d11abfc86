"""Typed metrics: counters, gauges, log-bucket histograms, a registry —
a copy of ``repro.obs.metrics`` (stdlib only; the port imports nothing
of ``repro``).

* **One lock per registry**, shared by every instrument it creates, so
  multi-field updates (histogram count+sum+bucket) are atomic as a
  group and ``engine._STATS`` is safe under worker threads.
* **Fixed log buckets.**  ``Histogram`` uses geometric bucket
  boundaries, ``BUCKETS_PER_DECADE`` per decade spanning ``1e-7 ..
  1e3`` seconds.  Memory is O(buckets) regardless of traffic, and
  ``percentile`` answers from counts: the *upper bound* of the bucket
  holding the requested rank.
* **Providers.**  Existing stats objects (``CacheStats``,
  ``LayerCacheStats``, router tables, ...) show up in a snapshot through
  ``register_provider(name, fn)`` with any ``() -> dict`` callable;
  ``snapshot()`` merges their output next to the typed metrics.
"""
from __future__ import annotations

import math
import threading

BUCKETS_PER_DECADE = 4
_LO_DECADE, _HI_DECADE = -7, 3  # bucket span: 1e-7 s .. 1e3 s

# Upper bounds of the log buckets: 10^(k / BUCKETS_PER_DECADE).
BOUNDS = tuple(10.0 ** (k / BUCKETS_PER_DECADE)
               for k in range(_LO_DECADE * BUCKETS_PER_DECADE,
                              _HI_DECADE * BUCKETS_PER_DECADE + 1))


class Counter:
    """Monotonic counter.  ``inc`` is atomic under the registry lock."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: "threading.RLock | None" = None):
        self.name = name
        self._lock = lock if lock is not None else threading.RLock()
        self._value = 0

    def inc(self, k: int = 1) -> None:
        with self._lock:
            self._value += k

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def as_value(self):
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, inflight dispatches, ...)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: "threading.RLock | None" = None):
        self.name = name
        self._lock = lock if lock is not None else threading.RLock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def as_value(self):
        return self._value


class Histogram:
    """Fixed log-bucket histogram with count-based quantiles.

    Buckets are the global ``BOUNDS`` grid (upper bounds); one overflow
    bucket catches samples beyond the last bound.  Tracks count / sum /
    min / max exactly; ``percentile`` is bucket-resolution.
    """

    __slots__ = ("name", "_lock", "counts", "count", "sum", "min", "max",
                 "overflow")

    def __init__(self, name: str, lock: "threading.RLock | None" = None):
        self.name = name
        self._lock = lock if lock is not None else threading.RLock()
        self.counts = [0] * len(BOUNDS)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.overflow = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket(v)
        with self._lock:
            if i is None:
                self.overflow += 1
            else:
                self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @staticmethod
    def _bucket(v: float) -> "int | None":
        """Index of the first bucket whose upper bound is >= v."""
        if v <= BOUNDS[0]:
            return 0
        if v > BOUNDS[-1]:
            return None
        # log-position, then a linear nudge to absorb float error
        k = int(math.ceil(math.log10(v) * BUCKETS_PER_DECADE)) \
            - _LO_DECADE * BUCKETS_PER_DECADE
        k = min(max(k, 0), len(BOUNDS) - 1)
        while k > 0 and v <= BOUNDS[k - 1]:
            k -= 1
        while v > BOUNDS[k]:
            k += 1
        return k

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket holding the p-th percentile sample.

        Empty histogram -> 0.0; ranks landing in the overflow bucket
        return the exact observed max.
        """
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil(self.count * p / 100.0))
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= rank:
                    return BOUNDS[i]
            return self.max  # overflow bucket

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * len(BOUNDS)
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf
            self.overflow = 0

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                        "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {"count": self.count, "sum": self.sum,
                    "mean": self.mean, "min": self.min, "max": self.max,
                    "p50": self.percentile(50), "p95": self.percentile(95),
                    "p99": self.percentile(99)}

    def as_value(self):
        return self.summary()


class MetricsRegistry:
    """Get-or-create store of named instruments plus snapshot providers.

    Instrument names are dotted paths (``"engine.dispatches"``,
    ``"trace.dispatch_s"``); the layer prefix keeps one flat namespace
    readable.  Asking for an existing name with a different type is an
    error — it means two layers are fighting over a name.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict = {}
        self._providers: dict = {}

    # ---------------------------------------------------- instruments
    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def metrics(self) -> "list":
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------ providers
    def register_provider(self, name: str, fn) -> None:
        """Attach a ``() -> dict`` snapshot source (e.g. an existing
        stats object's ``as_dict``).  Re-registering replaces."""
        with self._lock:
            self._providers[name] = fn

    def providers(self) -> dict:
        with self._lock:
            items = list(self._providers.items())
        out = {}
        for name, fn in items:
            try:
                out[name] = fn()
            except Exception as e:  # a broken provider must not take
                out[name] = {"error": repr(e)}  # down the snapshot
        return out

    # ------------------------------------------------------ snapshots
    def as_dict(self) -> dict:
        """Flat ``name -> value`` for typed metrics (histograms render
        as their summary dict)."""
        return {m.name: m.as_value() for m in self.metrics()}

    def snapshot(self) -> dict:
        return {"metrics": self.as_dict(), "providers": self.providers()}

    def reset(self) -> None:
        with self._lock:
            for m in self._metrics.values():
                m.reset()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry — what module-level stats (the engine's)
    bind to when no explicit registry is supplied."""
    return _DEFAULT
