"""Batched plan solving (counterpart of ``repro.service.batch``).

Same-``n`` queries stack to (B, 2^n) and every lattice sweep broadcasts
over the batch.  The solver groups a mixed micro-batch by ``(n, cost)``,
splits each group into descending power-of-two chunks (11 -> [8, 2, 1]
with cap 16), solves each chunk, and restores request order.

The lane carries four costs, routed as in the reference: ``"max"``
(DPconv[max]), ``"cap"`` (the two-pass C_cap program), ``"cap_conn"``
(C_cap with the no-cross-products pass 2: solved as ``cost="cap"`` with
``connected=True``, grouped under its own label) and ``"out"`` (C_out
with DPccp semantics: the connectivity-masked program, one call per
chunk; a chunk with a disconnected or hyperedge member falls back to
per-query host enumeration).

Tiers (``BatchPolicy.backend``): ``"auto"`` sends
``kernel_min_n <= n <= kernel_max_n`` (12..15) to the int32 kernel tier
(``"cuda"``: the hand-written zeta/Moebius and ranked-convolution
kernels) when the solver runs on a CUDA device, and everything else to
the f64 tier.  ``"cuda"`` forces the kernel tier up to ``kernel_max_n``
(on a CPU device its plain versions run); ``"f64"`` never uses it.  As
in the reference, only ``max`` chunks take the kernel tier: cap's pass 1
runs on the f64 tier in this lane and the (min,+) sweeps are f64, so
cap and out results report ``meta["backend"] == "f64"``.
Engines (``BatchPolicy.engine``): ``"fused"`` runs each chunk's whole
solve on the device (``core.engine``); ``"host"`` is the per-round host
loop for max (a feasibility pass per round on the chunk's tier: the
kernel tier's is ``kernel_dp_fn``), the host pipeline for cap (B
independent solves, ``chunk = 1``) and the host DPccp enumerator for
out.  Both engines run the same recursion on a tier
(``lattice.feasibility_layers``): on a card each middle layer of the
kernel tier is one ``ranked_conv`` launch either way.

Solve mesh (``BatchPolicy.solve_shards = D``): chunks at ``n >=
shard_min_n`` run the fused engine over a D-way solve mesh
(``launch.mesh``; ``_shards`` clamps D to the devices the mesh may use),
which is what lets the server lift its fused out ceiling, and the cap
ceiling of the mesh's gather sweep, past n = 13
(``engine.sharded_ceiling``).  The host tiers never shard.

Execution splits into ``submit`` (stage the items) and ``collect`` (run
them, possibly on another thread): the serving runtime carries a
``SolveHandle`` onto a lane's worker thread and keeps forming the next
micro-batch meanwhile.  One solver is one solve lane: a re-entrant lock
serializes its solves, and ``solve`` stamps the solver's ``lane`` on
every engine ``DispatchRecord`` it makes.

Warm-start seeds ride an item's 5th slot (``_unpack``) into the fused
engine only: a chunk with any seeded row runs the seeded program, and
rows without a seed keep a cold bracket.  Results are bit-identical in
cost and tree to single-query ``core.dpconv.optimize`` and to ``repro``,
with or without seeds.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core.dpconv import optimize, optimize_batch
from repro_torch.core.engine import host_cards
from repro_torch.core.layered import layered_feasibility_dp
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_devices


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    max_batch: int = 16
    kernel_min_n: int = 12      # kernel tier lower bound
    kernel_max_n: int = 15      # exactness bound: 2^{2n} < 2^31
    backend: str = "auto"       # "auto" | "f64" | "cuda"
    engine: str = "fused"       # "fused" | "host"
    gamma_batch: int = 1        # fused probe width: 1 = binary search
    solve_shards: int = 1       # solve-mesh width of the fused sweeps
    shard_min_n: int = 14       # engage the mesh only at n >= this

    def __post_init__(self):
        if self.engine not in ("fused", "host"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.backend not in ("auto", "f64", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.gamma_batch < 1:
            raise ValueError("gamma_batch must be >= 1")
        if self.solve_shards < 1:
            raise ValueError("solve_shards must be >= 1")


def _pow2_chunks(b: int, cap: int):
    """Decompose b into descending power-of-two chunk sizes <= cap (a
    non-power-of-two cap is clamped down)."""
    cap = 1 << (cap.bit_length() - 1)
    out = []
    while b:
        c = min(1 << (b.bit_length() - 1), cap)
        out.append(c)
        b -= c
    return out


def kernel_dp_fn(n: int, direct_layers: int = 4):
    """Host-loop feasibility pass on the kernel tier (counterpart of
    ``repro.service.batch.pallas_dp_fn``): the layered DP on the
    ``"cuda"`` tier, whose zeta/Moebius and middle-layer ranked
    convolutions run in int32 through ``kernels.ops``."""
    def dp_fn(gate: torch.Tensor, final_layer_shortcut: bool):
        dp = layered_feasibility_dp(gate, n, direct_layers,
                                    final_layer_shortcut, tier="cuda")
        return dp.to(torch.float64)
    return dp_fn


def _unpack(item):
    """items are (q, card[, cost[, tag[, seed]]]); cost defaults to
    "max", ``tag`` is an attribution label kept in ``last_timings``, and
    ``seed`` the layer cache's warm-start payload (None cold; ``{"opt":
    float}`` for the max/cap search, ``{"vals": (2^n,) f64, "ok": (2^n,)
    bool}`` for the out sweep).  Seeds are perf hints: the solvers return
    bit-identical results with or without them."""
    q, card = item[0], item[1]
    cost = item[2] if len(item) > 2 else "max"
    tag = item[3] if len(item) > 3 else ""
    seed = item[4] if len(item) > 4 else None
    return q, card, cost, tag, seed


def _seed_kw(seeds: list, cost: str, size: int) -> dict:
    """One chunk's seeds as engine keywords: per-row optima for a search
    lane, (B, 2^n) values and mask for the out lane; {} when no row has
    a seed the lane can use."""
    if not any(s is not None for s in seeds):
        return {}
    if cost == "out":
        if not any(s and s.get("ok") is not None for s in seeds):
            return {}
        sv = np.zeros((len(seeds), size), np.float64)
        so = np.zeros((len(seeds), size), bool)
        for b, s in enumerate(seeds):
            if s and s.get("ok") is not None:
                sv[b] = s["vals"]
                so[b] = s["ok"]
        return {"seed_vals": sv, "seed_ok": so}
    opts = [s.get("opt") if s else None for s in seeds]
    if not any(o is not None for o in opts):
        return {}
    return {"seed_opt": opts}


@dataclasses.dataclass
class SolveHandle:
    """A submitted, not yet collected batched solve: ``submit`` captures
    the items, ``collect`` runs them once and keeps the solve's
    ``last_timings`` rows in ``timings``."""
    items: list
    extract_tree: bool = True
    results: "list | None" = None
    timings: "list | None" = None        # this solve's last_timings slice


class BatchedSolver:
    """Groups micro-batch items by ``(n, cost)`` and solves each chunk on
    ``device`` (CUDA unless given).  ``lane`` is the serving lane this
    solver stands for (the engine's dispatch attribution label)."""

    def __init__(self, policy: "BatchPolicy | None" = None, device=None,
                 lane: int = 0):
        self.policy = policy or BatchPolicy()
        self.device = resolve_device(device)
        # one solver is one solve lane: a runtime worker thread and a
        # synchronous caller (plan_one, serve) may both reach solve(), so
        # the lane is a real lock, which also keeps last_timings snapshots
        # from interleaving.  RLock: collect() holds it across solve()
        # and the snapshot.
        self._lock = threading.RLock()
        self.lane = lane
        self.batches_run = 0
        self.queries_batched = 0
        # cumulative solver-lane totals (all chunks ever solved)
        self.total_solve_s = 0.0
        self.total_solved = 0
        # (n, queries, seconds, engine, cost, tag_counts) per chunk of the
        # last solve() call
        self.last_timings: list = []

    def use_kernels(self, n: int) -> bool:
        p = self.policy
        if p.backend == "cuda":
            # even when forced, never exceed the int32 exactness bound
            return n <= p.kernel_max_n
        if p.backend == "auto":
            return (self.device.type == "cuda"
                    and p.kernel_min_n <= n <= p.kernel_max_n)
        return False

    def _dp_fn(self, n: int):
        return kernel_dp_fn(n) if self.use_kernels(n) else None

    def _shards(self, n: int) -> int:
        """Solve-mesh width for one chunk: the policy's width, engaged
        only at ``n >= shard_min_n`` and clamped to the devices a mesh led
        by the solver's device may use (a policy written for four cards
        runs single-device on one)."""
        p = self.policy
        if p.solve_shards <= 1 or n < p.shard_min_n:
            return 1
        return min(p.solve_shards, len(mesh_devices(self.device)))

    def _solve_chunk(self, qs, cards, n, cost, extract_tree, seeds=None):
        """One same-(n, cost) chunk through the routed engine tier.
        ``seeds`` (per-query warm-start payloads, see ``_unpack``) reach
        the fused engine only."""
        engine = self.policy.engine
        G = self.policy.gamma_batch
        tier = "cuda" if self.use_kernels(n) else "f64"
        shards = self._shards(n)
        dev = self.device
        seed_kw = (_seed_kw(seeds or [None] * len(qs), cost, 1 << n)
                   if engine == "fused" else {})
        method = "dpccp" if cost == "out" else "dpconv"
        solve_cost, conn_kw = (("cap", {"connected": True})
                               if cost == "cap_conn" else (cost, {}))
        if len(qs) == 1:
            kw = {"engine": engine, "device": dev}
            if engine == "fused" and shards > 1:
                kw["shards"] = shards
            if engine == "fused" and cost != "out":
                kw["gamma_batch"] = G   # out's (min,+) sweep never probes
                if cost == "max":   # cap's pass 1 stays on the f64 tier
                    kw["backend"] = tier
            # the single-query slice of the chunk's seeds
            kw.update({k: v[0] for k, v in seed_kw.items()})
            res = optimize(qs[0], cards[0], cost=solve_cost, method=method,
                           extract_tree=extract_tree, **kw, **conn_kw)
            res.meta["batched"] = False
            res.meta["chunk"] = 1
            # a single host max solve runs the f64 host loop, as in repro
            res.meta["backend"] = (tier if cost == "max" and engine == "fused"
                                   else "f64")
            return [res]
        if cost == "out":
            # one fused program call for the chunk; with engine="host", or
            # when a disconnected/hyperedge member voids the DPccp search
            # space, B host enumerations accounted as chunk-1 solves
            results = optimize_batch(qs, cards, cost="out", method="dpccp",
                                     extract_tree=extract_tree,
                                     engine=engine, shards=shards,
                                     device=dev, **seed_kw)
            if not results[0].meta.get("batched"):
                return self._independent(results)
        elif solve_cost == "cap":
            if engine != "fused":
                # the host cap pipeline has no lockstep form: B
                # independent solves sharing only the wall-clock window
                return self._independent(
                    [optimize(q, c, cost="cap", extract_tree=extract_tree,
                              engine="host", device=dev, **conn_kw)
                     for q, c in zip(qs, cards)])
            results = optimize_batch(qs, cards, cost="cap",
                                     extract_tree=extract_tree,
                                     gamma_batch=G, shards=shards,
                                     device=dev, **conn_kw, **seed_kw)
        elif engine == "fused":
            results = optimize_batch(qs, cards, cost="max",
                                     extract_tree=extract_tree,
                                     engine="fused", backend=tier,
                                     gamma_batch=G, shards=shards,
                                     device=dev, **seed_kw)
        else:
            results = optimize_batch(qs, cards, cost="max",
                                     extract_tree=extract_tree,
                                     engine="host", dp_fn=self._dp_fn(n),
                                     device=dev)
        self.batches_run += 1
        self.queries_batched += len(qs)
        for res in results:
            res.meta["backend"] = tier if cost == "max" else "f64"
            res.meta["chunk"] = len(qs)
        return results

    @staticmethod
    def _independent(results):
        for res in results:
            res.meta["backend"] = "f64"
            res.meta["batched"] = False
            res.meta["chunk"] = 1
        return results

    # ------------------------------------------------- submit / collect
    def submit(self, items: list, extract_tree: bool = True
               ) -> SolveHandle:
        """Stage a batched solve without running it; ``collect`` (from
        any thread) runs it."""
        return SolveHandle(items=list(items), extract_tree=extract_tree)

    def collect(self, handle: SolveHandle) -> list:
        """Run (once) and return a submitted solve's results; the
        handle's ``timings`` keeps this solve's ``last_timings`` rows."""
        with self._lock:
            if handle.results is None:
                handle.results = self.solve(
                    handle.items, extract_tree=handle.extract_tree)
                handle.timings = list(self.last_timings)
        return handle.results

    def solve(self, items: list, extract_tree: bool = True) -> list:
        """``items``: list of (q, card[, cost[, tag[, seed]]]) tuples;
        cost is "max", "cap", "cap_conn" or "out", ``seed`` the optional
        layer-cache warm-start payload.  Returns PlanResults aligned with
        the input order."""
        with self._lock, engine_mod.dispatch_lane(self.lane):
            return self._solve_locked(items, extract_tree)

    def _solve_locked(self, items: list, extract_tree: bool) -> list:
        groups: dict = {}
        for idx, item in enumerate(items):
            q, card, cost, tag, seed = _unpack(item)
            groups.setdefault((q.n, cost), []).append(
                (idx, q, card, tag, seed))
        out: list = [None] * len(items)
        self.last_timings = []
        for (n, cost), group in sorted(groups.items()):
            lo = 0
            for chunk in _pow2_chunks(len(group), self.policy.max_batch):
                part = group[lo:lo + chunk]
                lo += chunk
                qs = [g[1] for g in part]
                cards = [host_cards(g[2]) for g in part]
                tags: dict = {}
                for g in part:
                    tags[g[3]] = tags.get(g[3], 0) + 1
                seeds = [g[4] for g in part]
                t0 = time.perf_counter()  # timing: measured-duration
                results = self._solve_chunk(qs, cards, n, cost,
                                            extract_tree, seeds=seeds)
                for g, res in zip(part, results):
                    out[g[0]] = res
                dt = time.perf_counter() - t0  # timing: measured-duration
                self.total_solve_s += dt
                self.total_solved += chunk
                eng = results[0].meta.get("engine", self.policy.engine)
                self.last_timings.append((n, chunk, dt, eng, cost, tags))
        return out
