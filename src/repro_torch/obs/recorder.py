"""Flight recorder: bounded history + always-on incident capture (a copy
of ``repro.obs.recorder``; stdlib only).

Two retention tiers, mirroring what an operator needs after the fact:

* ``ring`` — the last ``capacity`` *completed* span trees, any lane.
  A rolling window for "what did traffic look like just now"; old
  entries fall off silently.
* ``incidents`` — every shed, downgraded, and deadline-missed request
  (plus solver errors), captured unconditionally up to
  ``incident_capacity`` (much larger, and counted exactly even past
  capacity).  These are the requests a postmortem is about, so they
  are never sampled away: the recorder's incident counts equal the
  runtime's shed/downgrade/miss stats.

Span trees are stored as live ``Span`` objects (immutable once closed)
and serialized lazily — ``dump_jsonl`` renders one JSON object per
line, ``{"kind": ..., "at": ..., "info": {...}, "span": {tree}}``.
"""
from __future__ import annotations

import collections
import json

INCIDENT_KINDS = ("shed", "downgraded", "deadline_miss", "error",
                  "watchdog", "quarantine")


class FlightRecorder:
    def __init__(self, capacity: int = 256, incident_capacity: int = 4096):
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.incidents: collections.deque = collections.deque(
            maxlen=incident_capacity)
        self.counts = {"completed": 0, **{k: 0 for k in INCIDENT_KINDS}}

    def completed(self, span) -> None:
        self.counts["completed"] += 1
        self.ring.append(span)

    def incident(self, kind: str, span=None, **info) -> None:
        if kind not in self.counts:
            self.counts[kind] = 0
        self.counts[kind] += 1
        at = span.t1 if span is not None and span.t1 is not None else None
        self.incidents.append({"kind": kind, "at": at, "info": info,
                               "span": span})

    # ------------------------------------------------------------ dump
    def dump_jsonl(self, path=None, replica: "str | None" = None
                   ) -> "list[str]":
        """Render ring + incidents as JSON lines; optionally write them
        to ``path``.  Returns the lines either way.  ``replica`` tags
        every line with the emitting replica's id so multi-replica dumps
        merge unambiguously (``scripts/obs_tail.py``)."""
        tag = {} if replica is None else {"replica": replica}
        lines = []
        for span in self.ring:
            lines.append(json.dumps({"kind": "completed", **tag,
                                     "span": span.to_dict()},
                                    default=str))
        for inc in self.incidents:
            span = inc["span"]
            lines.append(json.dumps(
                {"kind": inc["kind"], "at": inc["at"], **tag,
                 "info": inc["info"],
                 "span": span.to_dict() if span is not None else None},
                default=str))
        if path is not None:
            with open(path, "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        return lines

    def snapshot(self) -> dict:
        return {"counts": dict(self.counts),
                "ring_len": len(self.ring),
                "incident_len": len(self.incidents)}
