"""The device trace of a traced run: one ``torch.profiler`` session over
the measured window, read once it has closed.

``DeviceTrace.start()`` opens the session before the window opens and
``stop()`` closes it after the window closes; the window's bounds are
taken on the profiler's own clock (wall nanoseconds) right after the
session starts and right before it stops, and every interval is clipped
to them.  From the session's raw events it keeps

* the device operations (kernels, copies, sets) as intervals with their
  names: busy time is the union of the intervals, idle time the rest of
  the window;
* the kernel launches (device operations that are kernels);
* the host's CUDA runtime calls (``cuda...``), which name an idle gap by
  what the host was doing at its end (the call that ended it).
"""
from __future__ import annotations

import collections
import time

from pbench import stats


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.ops: list = []          # (start_s, end_s, name, is_kernel)
        self.host_calls: list = []   # (start_s, end_s, name)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        # a run without a card (the harness's own tests) traces the host,
        # which holds no device operation
        act = ProfilerActivity.CUDA if torch.cuda.is_available() \
            else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        self.t1_ns = time.time_ns()
        self.prof.stop()
        t_read = time.perf_counter()
        t0, t1 = self.t0_ns, self.t1_ns
        events = self.prof.profiler.kineto_results.events()
        self.kinds = collections.Counter()
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if s + d < t0 or s > t1:
                continue
            a, b = max(s, t0), min(s + d, t1)
            kind = str(e.activity_type()) if hasattr(e, "activity_type") \
                else ""
            self.kinds[f"{e.device_type()}/{kind}"] += 1
            if "CUDA" in str(e.device_type()):
                name = e.name()
                name = (name[5:] if name.startswith("void ") else name)[:120]
                kernel = ("kernel" in kind.lower() if kind else
                          not name.startswith(("Memcpy", "Memset")))
                self.ops.append(((a - t0) * 1e-9, (b - t0) * 1e-9, name,
                                 kernel))
            elif ("runtime" in kind.lower() or "driver" in kind.lower()
                  or e.name().startswith("cuda")):
                self.host_calls.append(((a - t0) * 1e-9, (b - t0) * 1e-9,
                                        e.name()))
        self.prof = None
        self.read_s = time.perf_counter() - t_read

    # ------------------------------------------------------------ readings
    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    @property
    def busy_s(self) -> float:
        return stats.union_length((a, b) for a, b, _, _ in self.ops)

    @property
    def kernel_s(self) -> float:
        return sum(b - a for a, b, _, k in self.ops if k)

    @property
    def launches(self) -> int:
        return sum(1 for *_, k in self.ops if k)

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        by = collections.Counter()
        for a, b, name, _ in self.ops:
            by[name] += b - a
        return [[name, s] for name, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle stretches of the window, each named by the
        host's CUDA call that ended it (or "window end")."""
        calls = sorted(self.host_calls)
        gaps = stats.gaps([(a, b) for a, b, _, _ in self.ops], 0.0,
                          self.window_s)
        out = []
        j = 0
        for a, b in sorted(gaps):
            while j < len(calls) and calls[j][1] < b:
                j += 1
            label = "window end" if b >= self.window_s else (
                f"host until {calls[j][2]}" if j < len(calls)
                and calls[j][0] <= b else "host")
            out.append((b - a, label))
        out.sort(reverse=True)
        return [[label, s] for s, label in out[:top]]
