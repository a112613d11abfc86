"""The one module that knows the program's interface: it builds the
system under test from a configuration, hands it the generated requests,
and reads back its answers, spans and counters.

The program is the port, ``repro_torch`` under ``src/`` of the checkout;
nothing here imports the JAX package or anything of ``benchmarks/``.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

RUNTIME_COUNTERS = ("batches", "batched_items")
ENGINE_COUNTERS = ("queries", "exec_cache_misses")


def load(root: Path) -> None:
    """Put the program's source tree on the import path."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


@dataclasses.dataclass
class System:
    server: object
    runtime: "object | None" = None


def make_server(config: dict, device):
    from repro_torch.service.batch import BatchPolicy
    from repro_torch.service.server import PlanServer
    s = config["server"]
    return PlanServer(cache_capacity=int(s["cache_capacity"]),
                      max_batch=int(s["max_batch"]),
                      max_wait=float(s["max_wait_s"]),
                      batch_policy=BatchPolicy(**config["batch_policy"]),
                      enable_cache=bool(s["plan_cache"]),
                      enable_layer_cache=bool(s["layer_cache"]),
                      lanes=int(s["lanes"]), device=device)


def make_runtime(server, trace: bool):
    """The server's wall-clock runtime with its worker-thread executor,
    the runtime ``plan_async`` drives, with span trees on only when
    ``trace`` is set."""
    from repro_torch.service.runtime import RuntimeConfig, WallClock
    return server.make_runtime(
        clock=WallClock(),
        config=RuntimeConfig(max_batch=server.max_batch,
                             max_wait=server.max_wait, lanes=server.lanes,
                             trace=trace),
        executor="thread")


def prewarm(server, classes) -> dict:
    """Build the program buckets of the mix's (cost, n range) classes."""
    total = {"compiled": 0, "seconds": 0.0}
    for cls in classes:
        lo, hi = cls["n"]
        r = server.prewarm(range(lo, hi + 1), costs=(cls["cost"],))
        total["compiled"] += r["compiled"]
        total["seconds"] += r["seconds"]
    return total


def plan_request(req):
    """The program's request object for one generated request."""
    from repro_torch.core.querygraph import QueryGraph
    from repro_torch.service.server import PlanRequest
    return PlanRequest(q=QueryGraph(req.n, tuple(req.edges)), card=req.card,
                       cost=req.cost, req_id=req.i)


def plan_one(server, req):
    from repro_torch.core.querygraph import QueryGraph
    return server.plan_one(QueryGraph(req.n, tuple(req.edges)), req.card,
                           cost=req.cost)


def tree_tuple(tree) -> "tuple | None":
    """A served join tree as nested ``(mask, left, right)`` tuples."""
    if tree is None:
        return None
    if tree.left is None:
        return (int(tree.mask),)
    return (int(tree.mask), tree_tuple(tree.left), tree_tuple(tree.right))


def runtime_counters(rt) -> dict:
    return {k: getattr(rt.stats, k) for k in RUNTIME_COUNTERS}


def engine_counters() -> dict:
    from repro_torch.core import engine
    d = engine.stats().as_dict()
    return {k: d[k] for k in ENGINE_COUNTERS}


class DispatchLog:
    """The engine's dispatch records made between ``open`` and ``close``,
    read from its ring often enough that none is lost."""

    def __init__(self):
        from repro_torch.core import engine
        self._engine = engine
        self.mark = None
        self.records: list = []

    def open(self) -> None:
        self.mark = self._engine.dispatch_mark()
        self.records = []

    def read(self) -> None:
        if self.mark is None:
            return
        new = self._engine.dispatches_since(self.mark)
        if new:
            self.records.extend(new)
            self.mark = new[-1].seq

    def close(self) -> None:
        self.read()
        self.mark = None


def release(system: System) -> None:
    """Free the program's state on the device before the reference."""
    import torch
    from repro_torch.core import engine
    if system.runtime is not None:
        system.runtime.close()
    system.runtime = None
    system.server = None
    engine.clear_executable_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
