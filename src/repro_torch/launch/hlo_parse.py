"""Collective-byte accounting from compiled (post-SPMD) HLO text.

(A verbatim copy of ``repro.launch.hlo_parse``, which imports only ``re``
and ``collections``.  The port compiles no HLO: its dry-run reads
``train.dp.CollectiveLog.stats()``, which has ``parse_collectives``'s
layout, with ``link_traffic_bytes``.)

cost_analysis() does not expose collective traffic, so we parse the
optimized HLO: every all-gather / all-reduce / reduce-scatter / all-to-all
/ collective-permute op line carries its result shape; we sum byte sizes
per op kind.

Link-traffic model (ring algorithms on k participants, documented in
EXPERIMENTS.md §Roofline):
    all-gather:        out_bytes * (k-1)/k   per chip through its link
    reduce-scatter:    in_bytes  * (k-1)/k   (we see out shape; in = out*k)
    all-reduce:        2 * bytes * (k-1)/k   (RS + AG)
    all-to-all:        bytes * (k-1)/k
    collective-permute: bytes
We report both raw summed bytes per kind and the modeled per-chip link
traffic.
"""
from __future__ import annotations

import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\)|\S+))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{([^}]*)\}")
_GROUPS_ALT_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Returns {op_kind: {"count", "bytes"}, "_group_size": avg}."""
    stats: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    group_sizes = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        kind = m.group(2)
        if "-done(" in line:     # async pairs: count only the -start
            continue
        nbytes = _shape_bytes(m.group(1))
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += nbytes
        g = _GROUPS_RE.search(line)
        if g:
            first = g.group(1).split("}")[0]
            size = len([x for x in first.replace("{", "").split(",")
                        if x.strip() != ""])
            if size:
                group_sizes.append(size)
        else:
            g2 = _GROUPS_ALT_RE.search(line)
            if g2:
                group_sizes.append(int(g2.group(2)))
    out = {k: dict(v) for k, v in stats.items()}
    out["_avg_group"] = (sum(group_sizes) / len(group_sizes)
                         if group_sizes else 0)
    return out


def link_traffic_bytes(stats: dict, default_group: int) -> float:
    """Modeled per-chip link traffic (bytes) under ring algorithms."""
    k = stats.get("_avg_group") or default_group
    k = max(k, 2)
    f = (k - 1) / k
    t = 0.0
    t += stats.get("all-gather", {}).get("bytes", 0) * f
    t += stats.get("reduce-scatter", {}).get("bytes", 0) * f * k
    t += stats.get("all-reduce", {}).get("bytes", 0) * 2 * f
    t += stats.get("all-to-all", {}).get("bytes", 0) * f
    t += stats.get("collective-permute", {}).get("bytes", 0)
    return t
