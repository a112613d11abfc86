"""Thread-safe counters in a registry — the part of ``repro.obs.metrics``
that ``core.engine.EngineStats`` needs.  Stdlib only."""
from __future__ import annotations

import threading


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


class MetricsRegistry:
    """Named counters sharing one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: dict = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def as_dict(self) -> dict:
        with self._lock:
            return {k: c.value for k, c in sorted(self._counters.items())}
