"""The state of one run, shared by the driver, the judge and the metric
readers."""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import time

from pbench import program


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``; 0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Outcome:
    """One request of the window and what became of it.  Times are on
    the driver's clock, in seconds."""
    req: object
    due: float                       # when it was sent
    done: "float | None" = None      # when its answer was delivered
    status: str = "missing"          # exact | degraded | error | missing
    cost: "float | None" = None
    tree: "tuple | None" = None
    queue_wait: "float | None" = None  # its queue_wait span (traced run)

    @property
    def latency(self) -> float:
        return self.done - self.due if self.done is not None else math.inf

    @property
    def answered(self) -> bool:
        return self.status == "exact" and self.done is not None


@dataclasses.dataclass
class Run:
    bench: object
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float                   # perf_counter at process start
    traffic: object = None
    system: "program.System | None" = None
    outcomes: list = dataclasses.field(default_factory=list)
    t_open: float = 0.0              # perf_counter at the window's open
    t_close: float = 0.0
    setup_s: float = 0.0
    rt_before: dict = dataclasses.field(default_factory=dict)
    rt_after: dict = dataclasses.field(default_factory=dict)
    eng_before: dict = dataclasses.field(default_factory=dict)
    eng_after: dict = dataclasses.field(default_factory=dict)
    dispatches: "program.DispatchLog | None" = None
    devtrace: object = None
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)

    # ----------------------------------------------------------- window
    def open_window(self) -> float:
        """Everything set up: start the trace (traced run), snapshot the
        counters, and return the window's opening time."""
        gc.collect()
        gc.freeze()
        if self.trace:
            from pbench.devtrace import DeviceTrace
            self.dispatches = program.DispatchLog()
            self.devtrace = DeviceTrace()
            self.devtrace.start()
            self.dispatches.open()
        if self.system.runtime is not None:
            self.rt_before = program.runtime_counters(self.system.runtime)
        self.eng_before = program.engine_counters()
        self.t_open = time.perf_counter()
        self.setup_s = self.t_open - self.t_start
        self.mark("open")
        return self.t_open

    def close_window(self) -> None:
        self.t_close = time.perf_counter()
        if self.system.runtime is not None:
            self.rt_after = program.runtime_counters(self.system.runtime)
        self.eng_after = program.engine_counters()
        if self.trace:
            self.dispatches.close()
            t = time.perf_counter()
            self.devtrace.stop()
            self.notes["trace_stop_s"] = time.perf_counter() - t
            self.notes["trace_read_s"] = self.devtrace.read_s
            self.notes["trace_kinds"] = dict(self.devtrace.kinds)
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        gc.unfreeze()

    def mark(self, what: str) -> None:
        """Note how far into set-up ``what`` was reached (stderr only)."""
        self.notes.setdefault("setup_marks", {})[what] = round(
            time.perf_counter() - self.t_start, 3)

    def delta(self, before: dict, after: dict, key: str) -> int:
        return after.get(key, 0) - before.get(key, 0)
