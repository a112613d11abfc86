"""Observability of the port (counterpart of ``repro.obs``).

* ``metrics``  — the typed ``MetricsRegistry``: thread-safe counters,
  gauges and fixed log-bucket histograms that every serving layer
  registers into.
* ``trace``    — span tracing: one span tree per request (admit ->
  queue_wait -> dispatch -> extract -> respond, with coalesce /
  fast_path / shed variants), timed only through the runtime's
  ``Clock``, so trees are deterministic on a ``VirtualClock``.
* ``recorder`` — the flight recorder: a bounded ring of completed span
  trees plus every shed, downgraded and deadline-missed request.
* ``export``   — a registry as a JSON snapshot and as Prometheus text.

``trace``, ``recorder`` and ``export`` are copies of the reference's
modules; ``core.engine`` emits the per-dispatch records (build/execute
split, rounds, the port's own work count) that the runtime attaches to
the dispatch spans.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, default_registry)
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer  # noqa: F401
from repro_torch.obs.export import (prometheus,  # noqa: F401
                                    registry_snapshot, span_phase_summary)
