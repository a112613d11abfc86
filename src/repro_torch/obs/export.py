"""Registry export: JSON snapshots and Prometheus text format (a copy of
``repro.obs.export``).

``registry_snapshot`` renders a registry as a JSON-ready dict;
``prometheus`` renders the same registry in
the text exposition format (``# TYPE`` headers, cumulative
``_bucket{le=...}`` series for histograms) so a future distributed
front end can be scraped without new code.
"""
from __future__ import annotations

import re

from repro_torch.obs.metrics import (BOUNDS, Counter, Gauge, Histogram,
                                     MetricsRegistry)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Dots (our namespace separator) and other illegal characters
    become underscores; a leading digit gets a guard prefix."""
    out = _NAME_RE.sub("_", name.replace(".", "_"))
    return out if out and not out[0].isdigit() else "_" + out


def registry_snapshot(registry: MetricsRegistry) -> dict:
    """``{"metrics": {...}, "providers": {...}}`` — JSON-serializable."""
    return registry.snapshot()


def prometheus(registry: MetricsRegistry) -> str:
    """Render the registry's typed metrics as Prometheus text format."""
    lines: list = []
    for m in registry.metrics():
        name = _prom_name(m.name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {m.value}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {m.value}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {name} histogram")
            acc = 0
            for bound, c in zip(BOUNDS, m.counts):
                acc += c
                lines.append(f'{name}_bucket{{le="{bound:g}"}} {acc}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{name}_sum {m.sum}")
            lines.append(f"{name}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def span_phase_summary(registry: MetricsRegistry,
                       phases=("admit", "queue_wait", "coalesce",
                               "fast_path", "dispatch", "extract",
                               "respond", "request")) -> dict:
    """Per-phase latency breakdown from the ``trace.<phase>_s``
    histograms the Tracer feeds — the obs row's p50/p95 table."""
    out = {}
    for ph in phases:
        h = registry.histogram(f"trace.{ph}_s")
        if h.count:
            out[ph] = {"count": h.count, "mean_ms": h.mean * 1e3,
                       "p50_ms": h.percentile(50) * 1e3,
                       "p95_ms": h.percentile(95) * 1e3}
    return out
