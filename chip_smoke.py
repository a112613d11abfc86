#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. card      — name, count, and ``nvidia-smi`` name and power limit;
2. build     — ``nvcc`` builds every kernel of ``src/repro_torch/csrc``;
3. zeta      — every launch of a transform's plan (``zeta_cluster``
               for the low min(n, 15) bits, ``zeta_pair`` per higher
               bit) against its plain PyTorch version on the card,
               bitwise, n = 0..17, int32 and f32, fresh and in place;
4. conv      — the ranked-convolution kernel against its plain version;
5. fused     — the DPconv[max] batch lane (``BatchedSolver``, default
               policy: fused engine, int32 kernel tier for n = 12..15) on
               16 paper Sec. 9 clique(15) queries plus chain/star/cycle
               at n = 12..15 and one clique(12); optima and trees equal
               the f64 tier's, the clique(12) optimum equals the O(3^n)
               oracle; one ``zeta_cluster`` launch per transform, no
               ``zeta_pair``, and the rounds and passes of the reference;
6. host      — the same lane on the host engine (n = 13, B = 4), where
               the ranked-convolution kernel runs; optima equal the f64
               tier's;
7. large     — 4 clique(18) queries, above the int32 envelope: ``auto``
               takes the f64 tier and launches no kernel;
8. cap       — the C_cap lane (default policy: fused engine, pass 1 on
               the f64 tier as in the reference) on 16 clique(15) queries
               as ``"cap"`` and chain/star/cycle(15) as ``"cap_conn"``;
               caps, C_out values and trees equal the host pipeline's
               (``ccap(engine="host")``); then ``fused_ccap`` on the
               kernel tier over the 16 cliques equals the f64 tier, with
               one ``zeta_cluster`` launch per transform, no ``zeta_pair``;
9. out       — the C_out lane (fused DPccp, one program call per chunk)
               on 16 clique(15) plus chain/star/cycle(15): optima, trees
               and DP tables equal numpy DPsub (cliques) and the DPccp
               enumerator (sparse graphs); one micro-batch at n = 13 with
               all four lane costs comes back in request order;
10. server   — the plan server (``PlanServer._process``, one micro-batch
               per pass, plan cache off, layer cache with
               ``admission_min_probes=0``), every pass run once on fresh
               servers to warm up and then again, timed and checked:
               16 clique(15) as ``max``, optima equal to numpy DPsub,
               then the same 16 under fixed relabelings, every row seeded
               (one round against the cold rounds), optima and trees
               equal; 16 clique(13) as ``max`` then ``cap`` (the
               cross-lane warm start), equal to the host pipeline;
               chain/star/cycle(13) as ``out`` twice, the cold DP tables
               equal to the DPccp enumerator's, the second pass
               relabeled, with value hits and byte-equal DP tables; the
               max stream replayed through the plan cache (16 hits, no
               solve, no launch); a host-engine server at n = 13, which
               launches the ranked-convolution kernel, equal to the
               fused server and to DPsub;
11. runtime  — the serving runtime on one seeded stream
               (``make_workload``: 96 requests, n = 12..15, clique, chain,
               star and cycle, the default cost mix, 200 requests/s), B = 16:
               (a) ``prewarm(range(12, 16))`` from a cold program cache,
               then ``serve``, every dispatch of a prewarmed bucket a
               program-cache hit; (b) ``serve(closed_loop=True)``; (c)
               ``serve`` at the stream's arrivals; (d) 16 concurrent
               ``plan_async`` calls (8 clique(15), 8 relabelled
               duplicates) on the worker-thread executor; (e) a
               ``lanes=2`` thread runtime; (f) a host-engine server on the
               stream's n = 13 requests, which launches the ranked
               convolution; each pass once on fresh servers to warm up,
               then again, timed and checked: every answer equals a fresh
               server's ``plan_one`` (clique max optima also numpy DPsub),
               and no fault, retry, reroute, watchdog fire, shed or error;
               (g) ``FaultPlan.chaos`` on a ``VirtualClock``, run twice:
               identical tickets, every exact answer equal to
               ``plan_one``'s, every degraded one certified;
12. times    — each kernel at the path's shapes: device time per launch
               (torch.profiler) warm and with L2 cold, the host-launched
               call (CUDA events around 50 calls from Python), the host's
               cost per launch, its bound and its plain version; one
               whole transform warm and with L2 cold; launches per solve,
               solved queries per second.

Phases 8 and 9 print wall time, solved queries per second, peak device
memory and host syncs per solve; phase 10 prints each pass's wall time,
requests per second, cache hits, seeded solves, rounds, host syncs and
launches; phase 11 prints each pass's wall time, requests per second,
p50/p99 latency, batches, batch occupancy, coalesced joins, fast-path
and plan-cache hits, the engine's dispatch records (count, execute and
build seconds, program-cache hits) and launches.  Launch counters are
set to 0 just before each main-path phase (5, 6, 8, 9), each server
pass and each runtime pass, and read just after.  Data comes from fixed seeds through numpy.  The
second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a card, and
in a directory without the port.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores;
#                             32-bit integer adds and multiplies are
#                             counted against the same rate
ZETA_KERNELS = ("zeta_cluster_kernel", "zeta_pair_kernel")
# phase 5's workload searches 23 rounds and runs 31 feasibility passes
# (23 rounds + 8 extraction passes), as the reference does
LANE_ROUNDS, LANE_PASSES = 23, 31
# phase 11's stream: WorkloadSpec(n_requests=96, seed=12, ...) is the
# first seed whose stream has clique max requests and routes nothing to
# the approx lane (see phase 11).  FaultPlan.chaos(seed=139, rate=0.01)
# draws a firing fault at its first arming (each of its six specs fires
# with probability rate / 6 per arming, so most seeds fire none in one
# stream)
RUNTIME_REQUESTS, RUNTIME_SEED, CHAOS_SEED = 96, 12, 139


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, between CUDA events around ``iters``
    calls issued back to back from Python after warm-up: a host-launched
    call, which includes the host's launch cost when it is the larger."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn``, without a sync: what the
    Python wrapper and the launch cost the host."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_ms(fn, names, iters: int = 200, between=None) -> tuple:
    """Device milliseconds per call of ``fn``, kernel launches per call
    and the profiler sessions it took: torch.profiler's self device time
    of the kernels whose name holds one of ``names``, summed over
    ``iters`` calls.  ``between`` runs before each call (an L2 flush);
    its kernels are not counted.  A profiler session that reports no
    device event of ``names`` (seen now and then on the card's machine,
    cause not found) is run again, up to three sessions in all; the run
    fails if none sees one, and the count of sessions is reported so
    that a retry shows in the result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        us = launched = 0
        for e in prof.key_averages():
            if (getattr(e, "device_type", None) == DeviceType.CUDA
                    and any(nm in e.key for nm in names)):
                us += _device_us(e)
                launched += e.count
        if launched > 0 and us > 0:
            return us * 1e-3 / iters, launched / iters, attempt
        print(f"torch.profiler session {attempt} saw no device time of "
              f"{names}", flush=True)
    fail(f"torch.profiler saw no device time of {names} in 3 sessions")


def bound(nbytes: float, nops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    # ------------------------------------------------------------ 1. card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        from repro_torch.core import engine, jointree, querygraph as qg
        from repro_torch.core.baselines import dpsub
        from repro_torch.core.ccap import ccap
        from repro_torch.core.dpccp import dpccp_with_tree
        from repro_torch.core.dpconv_max import dpconv_max_ref
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.ranked_conv import ranked_conv_cuda
        from repro_torch.kernels.zeta_cuda import (launch_cluster,
                                                   launch_pair, launch_plan)
        from repro_torch.service.batch import BatchedSolver, BatchPolicy
        from repro_torch.service.canon import canonicalize, relabel_tree
        from repro_torch.service.layercache import LayerCache
        from repro_torch.service.server import PlanRequest, PlanServer
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    card = f"[{smi_line}]"
    print(f"card: {kind}, devices: {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    # exact float32 kernels: no TF32 anywhere in this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  ptxas {line.strip()}")

    rng = np.random.default_rng(20240913)
    err = {k: 0.0 for k in build.KERNELS}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def record(kernel, got, want):
        e = float((got.double() - want.double()).abs().max())
        err[kernel] = max(err[kernel], e)
        return bool(torch.equal(got, want))

    # ------------------------------------------------------------ 3. zeta
    # Every launch of the plan against its plain version, n = 0..17:
    # full-range int32, integer f32 and random f32 (bits in increasing
    # order, each add rounded alone, so all three are bitwise); the whole
    # transform into a fresh tensor and in place; mobius(zeta(x)) == x on
    # the exact inputs.
    shapes = [(1 << n,) for n in range(18)]
    shapes += [(16, 1 << n) for n in range(18)]
    shapes += [(2, 16, 1 << n) for n in range(18)] + [(16, 16, 1 << 15)]
    for shape in shapes:
        n = shape[-1].bit_length() - 1
        plan = launch_plan(n)
        inputs = [
            rng.integers(-2**31, 2**31, shape, dtype=np.int64)
            .astype(np.int32),
            rng.integers(-8, 9, shape).astype(np.float32),
            rng.random(shape, dtype=np.float32)]
        for i, a in enumerate(inputs):
            x = on_card(a)
            for sign in (1, -1):
                low = plan[0][2]
                out = torch.empty_like(x)
                launch_cluster(x, out, low, sign)
                ok = record("zeta_cluster", out,
                            ref.zeta_stages_ref(x, sign, 0, low))
                check(ok, f"zeta_cluster {x.dtype} {shape} sign {sign}")
                y = x.clone()
                launch_cluster(y, y, low, sign)
                check(torch.equal(y, out),
                      f"zeta_cluster in place {x.dtype} {shape} {sign}")
                for _, j, _ in plan[1:]:
                    y = x.clone()
                    launch_pair(y, j, sign)
                    ok = record("zeta_pair", y,
                                ref.zeta_stages_ref(x, sign, j, j + 1))
                    check(ok, f"zeta_pair {x.dtype} {shape} bit {j} {sign}")
                want = ref.mobius_ref(x) if sign < 0 else ref.zeta_ref(x)
                check(torch.equal(ops.zeta_op(x, inverse=sign < 0), want),
                      f"zeta_op {x.dtype} {shape} sign {sign}")
                y = x.clone()
                ops.zeta_op(y, inverse=sign < 0, out=y)
                check(torch.equal(y, want),
                      f"zeta_op in place {x.dtype} {shape} sign {sign}")
            if i < 2:
                check(torch.equal(ops.mobius_op(ops.zeta_op(x)), x),
                      f"mobius(zeta(x)) != x on {x.dtype} {shape}")
    torch.cuda.synchronize()
    print(f"zeta: every launch == its plain version, bitwise, n = 0..17 on "
          f"(2^n,), (16, 2^n), (2, 16, 2^n) and (16, 16, 2^15), both "
          f"signs, int32 full range, integer and random f32, fresh and in "
          f"place; mobius(zeta(x)) == x", flush=True)

    # ------------------------------------------------------------ 4. conv
    Zshape = (16, 16, 1 << 15)
    Z = on_card(rng.integers(-2**31, 2**31, Zshape, dtype=np.int64)
                .astype(np.int32))
    for k in (5, 8, 15):
        ok = record("ranked_conv", ranked_conv_cuda(Z, k),
                    ref.ranked_conv_ref(Z, k))
        check(ok, f"ranked_conv int32 {Zshape} k={k}")
    Zs = on_card(rng.integers(0, 2**31, (4, 3, 1 << 5 | 1), dtype=np.int64)
                 .astype(np.int32))   # odd width: the scalar path
    check(record("ranked_conv", ranked_conv_cuda(Zs, 3),
                 ref.ranked_conv_ref(Zs, 3)), "ranked_conv scalar path")
    torch.cuda.synchronize()
    print(f"conv: kernel == plain version, bitwise, on {Zshape} for "
          f"k in (5, 8, 15) and the unaligned path", flush=True)

    # ----------------------------------------------------- 5. fused lane
    items = [qg.paper_clique_instance(15, seed) for seed in range(16)]
    for n in range(12, 16):
        for maker in (qg.chain, qg.star, qg.cycle):
            q = maker(n)
            items.append((q, qg.make_cardinalities(q, seed=100 + n)))
    # the oracle's query: a clique, whose candidate table is long (the
    # chain/star/cycle tables above reach the 1e8 cap at V: one candidate)
    items.append(qg.paper_clique_instance(12, 16))
    lane = BatchedSolver()                      # default policy, cuda
    lane.solve(items)                           # builds the programs
    torch.cuda.synchronize()
    # transforms counted apart from the kernel counters: around the
    # wrapper that runs a transform's launch plan
    transforms5 = [0]
    zeta_cuda = ops.zeta_cuda

    def counted(*args, **kw):
        transforms5[0] += 1
        return zeta_cuda(*args, **kw)

    ops.zeta_cuda = counted
    engine.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = lane.solve(items)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    counts5 = ops.launch_counts()
    ops.zeta_cuda = zeta_cuda
    passes5 = sum(r.meta["passes"] / r.meta["chunk"] for r in got)
    chunks5 = len(lane.last_timings)
    rounds5 = engine.stats().rounds
    check(all(r.meta["backend"] == "cuda" for r in got),
          "auto did not take the kernel tier at n = 12..15")
    f64 = BatchedSolver(BatchPolicy(backend="f64")).solve(items)
    for (q, cq), r, w in zip(items, got, f64):
        check(r.cost.hex() == w.cost.hex(),
              f"n={q.n}: kernel tier {r.cost!r} != f64 tier {w.cost!r}")
        check(str(r.tree) == str(w.tree), f"n={q.n}: trees differ")
        check(r.tree.validate() and r.tree.cost_max(cq) == r.cost,
              f"n={q.n}: tree does not realize its optimum")
    oracle = dpconv_max_ref(items[-1][1], 12)
    check(got[-1].cost == oracle,
          f"n=12: {got[-1].cost!r} != oracle {oracle!r}")
    check(counts5["zeta_cluster"] == transforms5[0] > 0
          and counts5["zeta_pair"] == 0,
          f"the fused lane made {counts5} launches for {transforms5[0]} "
          f"transforms; one zeta_cluster launch per transform expected")
    check((rounds5, passes5) == (LANE_ROUNDS, LANE_PASSES),
          f"{rounds5} rounds and {passes5} passes, not {LANE_ROUNDS} and "
          f"{LANE_PASSES}")
    qps5 = len(items) / t_fused
    print(f"fused: {len(items)} queries in {chunks5} chunks, {rounds5} "
          f"search rounds, {passes5:g} passes, {t_fused:.4f} s, "
          f"{qps5:.2f} queries/s, {transforms5[0]} transforms, launches "
          f"{counts5}; optima and trees == f64 tier, n=12 clique == oracle "
          f"{oracle!r} {card}", flush=True)

    # ------------------------------------------------------ 6. host lane
    host_items = []
    for i, maker in enumerate((qg.clique, qg.chain, qg.star, qg.cycle)):
        q = maker(13)
        host_items.append((q, qg.make_cardinalities(q, seed=200 + i,
                                                    cap=1e8)))
    host_lane = BatchedSolver(BatchPolicy(engine="host"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got6 = host_lane.solve(host_items)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    counts6 = ops.launch_counts()
    want6 = BatchedSolver(BatchPolicy(backend="f64")).solve(host_items)
    for (q, _), r, w in zip(host_items, got6, want6):
        check(r.cost.hex() == w.cost.hex(),
              f"host lane {r.cost!r} != f64 tier {w.cost!r}")
        check(str(r.tree) == str(w.tree), "host lane: trees differ")
    check(counts6["zeta_cluster"] > 0 and counts6["ranked_conv"] > 0
          and counts6["zeta_pair"] == 0,
          f"the host lane's launches {counts6}: zeta_cluster and "
          f"ranked_conv expected, no zeta_pair at n = 13")
    print(f"host: 4 queries at n=13 in {t_host:.4f} s, launches "
          f"{counts6}; optima and trees == f64 tier {card}", flush=True)

    # ---------------------------------------------------- 7. above int32
    big = [qg.paper_clique_instance(18, seed) for seed in range(4)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got7 = lane.solve(big)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    check(all(r.meta["backend"] == "f64" for r in got7),
          "auto left the f64 tier above n = 15")
    check(sum(ops.launch_counts().values()) == 0,
          "a kernel launched above the int32 envelope")
    for (q, cq), r in zip(big, got7):
        check(r.tree.validate() and r.tree.cost_max(cq) == r.cost,
              "n=18: tree does not realize its optimum")
    qps7 = len(big) / t_big
    print(f"large: 4 clique(18) queries on the f64 tier in {t_big:.4f} s "
          f"(first call of this bucket), {qps7:.3f} queries/s {card}",
          flush=True)

    def lane_run(solver, lane_items):
        """One timed ``solve`` after a warm-up call: results, wall
        seconds, peak device bytes, host syncs per solve and launches."""
        solver.solve(lane_items)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine.reset_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.solve(lane_items)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = engine.stats()
        return (res, dt, torch.cuda.max_memory_allocated(),
                st.host_syncs / max(st.solves, 1), ops.launch_counts())

    def same_plan(label, r, cout, tree, gamma=None):
        check(float(r.cost).hex() == float(cout).hex(),
              f"{label}: {r.cost!r} != host {cout!r}")
        check(str(r.tree) == str(tree), f"{label}: trees differ")
        if gamma is not None:
            check(float(r.meta["gamma"]).hex() == float(gamma).hex(),
                  f"{label}: cap {r.meta['gamma']!r} != host {gamma!r}")

    sparse15 = []
    for i, maker in enumerate((qg.chain, qg.star, qg.cycle)):
        q = maker(15)
        sparse15.append((q, qg.make_cardinalities(q, seed=300 + i)))
    cliques15 = [qg.paper_clique_instance(15, seed) for seed in range(16)]

    # ------------------------------------------------------------ 8. cap
    cap_items = ([(q, c, "cap") for q, c in cliques15]
                 + [(q, c, "cap_conn") for q, c in sparse15])
    got8, t_cap, mem8, syncs8, counts8 = lane_run(BatchedSolver(), cap_items)
    check(sum(counts8.values()) == 0,
          f"the cap lane launched {counts8}: its pass 1 runs the f64 tier")
    for (q, c, cost), r in zip(cap_items, got8):
        check(r.meta["engine"] == "fused" and r.meta["backend"] == "f64",
              f"cap lane meta {r.meta}")
        h = ccap(q, c, engine="host", connected=cost == "cap_conn")
        same_plan(f"{cost} n=15", r, h.cout, h.tree, h.gamma)
    qps8 = len(cap_items) / t_cap
    print(f"cap: {len(cap_items)} queries (16 cap, 3 cap_conn) at n=15 in "
          f"{t_cap:.4f} s, {qps8:.3f} queries/s, peak device memory "
          f"{mem8 / 2**20:.1f} MiB, {syncs8:g} host syncs per solve; caps, "
          f"C_out values and trees == host pipeline {card}", flush=True)
    # pass 1 on the kernel tier: one zeta_cluster launch per transform
    cl_cards = np.stack([c for _, c in cliques15])
    f64_cap = engine.fused_ccap(cl_cards, 15, backend="f64", device=dev)
    transforms8 = [0]

    def counted8(*args, **kw):
        transforms8[0] += 1
        return zeta_cuda(*args, **kw)

    ops.zeta_cuda = counted8
    ops.reset_launch_counts()
    k_cap = engine.fused_ccap(cl_cards, 15, backend="cuda", device=dev)
    torch.cuda.synchronize()
    counts8k = ops.launch_counts()
    ops.zeta_cuda = zeta_cuda
    check([g.hex() for g in k_cap.gammas] == [g.hex() for g in f64_cap.gammas]
          and [c.hex() for c in k_cap.couts]
          == [c.hex() for c in f64_cap.couts]
          and [str(t) for t in k_cap.trees] == [str(t) for t in f64_cap.trees]
          and k_cap.rounds == f64_cap.rounds,
          "fused_ccap: the kernel tier differs from the f64 tier")
    check(counts8k["zeta_cluster"] == transforms8[0] > 0
          and counts8k["zeta_pair"] == 0,
          f"fused_ccap(backend='cuda') made {counts8k} launches for "
          f"{transforms8[0]} transforms; one zeta_cluster each expected")
    print(f"cap: fused_ccap kernel tier == f64 tier on the 16 cliques, "
          f"{k_cap.rounds} rounds, {transforms8[0]} transforms, launches "
          f"{counts8k}", flush=True)

    # ------------------------------------------------------------ 9. out
    out_items = [(q, c, "out") for q, c in cliques15 + sparse15]
    got9, t_out, mem9, syncs9, counts9 = lane_run(BatchedSolver(), out_items)
    check(sum(counts9.values()) == 0, f"the out lane launched {counts9}")
    for i, ((q, c, _), r) in enumerate(zip(out_items, got9)):
        check(r.meta["engine"] == "fused", f"out lane meta {r.meta}")
        if i < len(cliques15):      # every subset of a clique is connected
            dp = dpsub(c, 15, mode="out")
            tree = jointree.extract_tree_out(dp, c, 15)
        else:
            dp, tree = dpccp_with_tree(q, c)
        same_plan(f"out n=15 #{i}", r, dp[-1], tree)
        check(r.meta["dp_table"].tobytes() == dp.tobytes(),
              f"out n=15 #{i}: DP tables differ")
    qps9 = len(out_items) / t_out
    print(f"out: {len(out_items)} queries at n=15 in {t_out:.4f} s, "
          f"{qps9:.3f} queries/s, peak device memory {mem9 / 2**20:.1f} "
          f"MiB, {syncs9:g} host syncs per solve; optima, trees and DP "
          f"tables == DPsub (cliques) and DPccp (sparse) {card}",
          flush=True)
    mixed = []
    for i, cost in enumerate(["max", "cap", "out", "cap_conn"] * 3):
        q = (qg.clique, qg.chain, qg.star, qg.cycle)[(i + i // 4) % 4](13)
        mixed.append((q, qg.make_cardinalities(q, seed=400 + i,
                                               base_range=(1e1, 1e3)),
                      cost))
    mixed_lane = BatchedSolver()
    got_mixed = mixed_lane.solve(mixed)
    chunks_mixed = len(mixed_lane.last_timings)
    for it, r in zip(mixed, got_mixed):
        (w,) = mixed_lane.solve([it])
        check(float(r.cost).hex() == float(w.cost).hex()
              and str(r.tree) == str(w.tree),
              f"mixed micro-batch: {it[2]} result out of request order")
    print(f"out: a mixed micro-batch of {len(mixed)} queries at n=13 "
          f"(max, cap, out, cap_conn) came back in request order, "
          f"{chunks_mixed} chunks", flush=True)

    # --------------------------------------------------------- 10. server
    # The passes run twice, each time on fresh servers: first to build
    # every program and touch every table ("first call"), then the run
    # that is timed, counted and checked ("warm"), so that a cold pass and
    # a seeded pass are compared warm against warm.
    class TimedLayerCache(LayerCache):
        """The layer cache, with the host seconds of its seed probes and
        of its harvests summed."""
        probe_s = harvest_s = 0.0

        def seed_for(self, form, cost):
            t0 = time.perf_counter()
            try:
                return super().seed_for(form, cost)
            finally:
                self.probe_s += time.perf_counter() - t0

        def observe(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return super().observe(*args, **kw)
            finally:
                self.harvest_s += time.perf_counter() - t0

    def server(**kw):
        """A plan server on the card with the plan cache off (unless
        asked) and a layer cache that admits from the first solve."""
        kw.setdefault("enable_cache", False)
        srv = PlanServer(**kw)
        srv.layers = TimedLayerCache(admission_min_probes=0)
        return srv

    def serve_pass(srv, label, pairs, cost):
        """One ``_process`` micro-batch of ``pairs`` as ``cost``, timed and
        counted: responses and a dict of the pass's numbers.  ``solve_s``
        is the batch lane's share of the wall (``BatchedSolver.solve``),
        ``host_s`` the rest: canonicalization, cache probes, seeds,
        harvest and relabeling, of which ``probe_s`` went to the layer
        cache's seed probes and ``harvest_s`` to its harvests."""
        reqs = [PlanRequest(q=q, card=c, cost=cost) for q, c in pairs]
        st0 = srv.layers.stats.as_dict()
        hits0 = srv.cache.stats.hits
        solve0 = srv.solver.total_solve_s
        probe0, harvest0 = srv.layers.probe_s, srv.layers.harvest_s
        torch.cuda.synchronize()
        engine.reset_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        resps = srv._process(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        es = engine.stats()
        st = srv.layers.stats.as_dict()
        solve_s = srv.solver.total_solve_s - solve0
        probe_s = srv.layers.probe_s - probe0
        harvest_s = srv.layers.harvest_s - harvest0
        num = {"wall_s": dt, "requests_per_s": len(reqs) / dt,
               "solve_s": solve_s, "host_s": dt - solve_s,
               "probe_s": probe_s, "harvest_s": harvest_s,
               "plan_cache_hits": srv.cache.stats.hits - hits0,
               "search_hits": st["search_hits"] - st0["search_hits"],
               "value_hits": st["value_hits"] - st0["value_hits"],
               "seeded_solves": st["seeded_solves"] - st0["seeded_solves"],
               "solves": es.solves, "seeded_rows": es.seeded_rows,
               "rounds": es.rounds, "host_syncs": es.host_syncs,
               "launches": ops.launch_counts()}
        print(f"server {label}: {len(reqs)} requests ({cost}) in "
              f"{dt:.4f} s (solve {solve_s:.4f} s, host "
              f"{dt - solve_s:.4f} s, of which seed probes "
              f"{probe_s:.4f} s and harvest {harvest_s:.4f} s), "
              f"{num['requests_per_s']:.2f} "
              f"requests/s, plan-cache hits {num['plan_cache_hits']}, "
              f"layer-cache search hits {num['search_hits']}, value hits "
              f"{num['value_hits']}, seeded solves {num['seeded_solves']} "
              f"({es.seeded_rows} rows), {es.solves} chunk solves, "
              f"{es.rounds} rounds, {es.host_syncs} host syncs, launches "
              f"{num['launches']} {card}", flush=True)
        return resps, num

    def relabeled(pairs, seed):
        """The same queries under fixed random relabelings, and the
        inverse permutations that map their trees back."""
        prng = np.random.default_rng(seed)
        out, inv = [], []
        for q, c in pairs:
            perm = [int(p) for p in prng.permutation(q.n)]
            out.append((qg.relabel(q, perm), qg.permute_card(c, q.n, perm)))
            back = [0] * q.n
            for i, p in enumerate(perm):
                back[p] = i
            inv.append(back)
        return out, inv

    def same_answers(label, a, b, inv):
        for i, (ra, rb) in enumerate(zip(a, b)):
            check(float(ra.cost).hex() == float(rb.cost).hex(),
                  f"{label} #{i}: {rb.cost!r} != {ra.cost!r}")
            check(str(relabel_tree(rb.tree, inv[i])) == str(ra.tree),
                  f"{label} #{i}: trees differ after relabeling back")

    def same_cmax(label, pairs, resps, want):
        """C_max optima equal DPsub's on the host, and each tree, in the
        request's labels, realizes its optimum."""
        for i, ((q, c), r) in enumerate(zip(pairs, resps)):
            check(float(r.cost).hex() == float(want[i]).hex(),
                  f"{label} #{i}: {r.cost!r} != DPsub {want[i]!r}")
            check(r.tree.validate() and r.tree.cost_max(c) == r.cost,
                  f"{label} #{i}: tree does not realize its optimum")

    cliques13 = [qg.paper_clique_instance(13, seed) for seed in range(16)]
    sparse13 = []
    for i, maker in enumerate((qg.chain, qg.star, qg.cycle)):
        q = maker(13)
        sparse13.append((q, qg.make_cardinalities(q, seed=700 + i)))
    re15, inv15 = relabeled(cliques15, 11)
    re13, inv13 = relabeled(sparse13, 12)

    def server_passes(tag):
        """Every pass of the phase on fresh servers: responses and numbers
        by pass, and the out server's DP tables by canonical key."""
        res = {}
        srv = server()
        res["max15"] = serve_pass(srv, f"{tag}, max n=15 cold", cliques15,
                                  "max")
        res["max15_seeded"] = serve_pass(
            srv, f"{tag}, max n=15 relabeled", re15, "max")
        res["search_inserts15"] = srv.layers.stats.search_inserts
        srv13 = server()
        res["max13"] = serve_pass(srv13, f"{tag}, max n=13", cliques13,
                                  "max")
        res["cap13"] = serve_pass(srv13, f"{tag}, cap n=13 after max",
                                  cliques13, "cap")
        srv_out = server()
        tables: dict = {}
        observe = srv_out.layers.observe

        def keep_table(form, cost, cost_v, meta, params=(), dp=None):
            tables.setdefault(form.key, []).append(np.array(dp, copy=True))
            return observe(form, cost, cost_v, meta, params=params, dp=dp)

        srv_out.layers.observe = keep_table
        res["out13"] = serve_pass(srv_out, f"{tag}, out n=13 cold",
                                  sparse13, "out")
        res["out13_seeded"] = serve_pass(
            srv_out, f"{tag}, out n=13 relabeled", re13, "out")
        res["tables"] = tables
        srv_c = server(enable_cache=True)
        res["cache_first"] = serve_pass(srv_c, f"{tag}, plan cache first",
                                        cliques15, "max")
        res["cache_replay"] = serve_pass(srv_c, f"{tag}, plan cache replay",
                                         re15, "max")
        srv_h = server(batch_policy=BatchPolicy(engine="host"))
        res["host13"] = serve_pass(srv_h, f"{tag}, host engine n=13",
                                   host_items, "max")
        return res

    server_passes("first call")
    res10 = server_passes("warm")
    server_launches = {k: 0 for k in build.KERNELS}
    for val in res10.values():
        if isinstance(val, tuple):
            for k, v in val[1]["launches"].items():
                server_launches[k] += v

    # max n=15: cold against DPsub on the host, seeded against cold
    cold, n_cold = res10["max15"]
    warm, n_warm = res10["max15_seeded"]
    check(all(r.route.lane == "batch" and r.meta["backend"] == "cuda"
              for r in cold + warm), "the max passes left the kernel tier")
    check(res10["search_inserts15"] == 16
          and n_warm["search_hits"] == 16 and n_warm["seeded_rows"] == 16
          and n_warm["solves"] == 1,
          f"the relabeled pass was not seeded 16/16 in one chunk: {n_warm}")
    check(n_warm["rounds"] == 1 < n_cold["rounds"],
          f"seeded rounds {n_warm['rounds']}, cold {n_cold['rounds']}")
    check(n_cold["launches"]["zeta_cluster"] > 0
          and n_warm["launches"]["zeta_cluster"] > 0,
          "a max pass at n = 15 launched no zeta_cluster")
    cmax15 = [dpsub(c, 15, mode="max")[-1] for _, c in cliques15]
    same_cmax("server max n=15 cold", cliques15, cold, cmax15)
    same_answers("server max n=15", cold, warm, inv15)

    # cap n=13 after max: the cross-lane warm start, against the host
    # pipeline on the canonical form the server solved
    max13, n_max13 = res10["max13"]
    caps, n_cap13 = res10["cap13"]
    same_cmax("server max n=13", cliques13, max13,
              [dpsub(c, 13, mode="max")[-1] for _, c in cliques13])
    check(n_cap13["search_hits"] == 16 and n_cap13["seeded_rows"] == 16
          and n_cap13["rounds"] == 1,
          f"the cap pass was not warm-started by the max pass: {n_cap13}")
    for i, ((q, c), r) in enumerate(zip(cliques13, caps)):
        check(r.route.lane == "batch" and r.meta["engine"] == "fused",
              f"cap n=13 #{i}: route {r.route}, meta {r.meta}")
        form = canonicalize(q, c)      # what the server solved
        h = ccap(form.q, form.card, engine="host")
        same_plan(f"server cap n=13 #{i}", r,
                  h.cout, relabel_tree(h.tree, form.inverse_perm), h.gamma)

    # out n=13: cold DP tables against the DPccp enumerator on the
    # canonical form, seeded tables byte-equal to cold
    out1, n_out1 = res10["out13"]
    out2, n_out2 = res10["out13_seeded"]
    tables = res10["tables"]
    check(all(r.route.method == "dpccp" and r.route.lane == "batch"
              for r in out1 + out2), "the out passes left the fused lane")
    check(n_out2["value_hits"] > 0 and n_out2["seeded_rows"] == 3,
          f"the relabeled out pass scored no value hits: {n_out2}")
    for i, ((q, c), r) in enumerate(zip(sparse13, out1)):
        form = canonicalize(q, c)
        dp, tree = dpccp_with_tree(form.q, form.card)
        same_plan(f"server out n=13 #{i}", r, dp[-1],
                  relabel_tree(tree, form.inverse_perm))
        check(len(tables.get(form.key, ())) == 2
              and tables[form.key][0].tobytes() == dp.tobytes(),
              f"server out n=13 #{i}: cold DP table != DPccp enumerator")
    check(len(tables) == 3 and all(
        v[0].tobytes() == v[1].tobytes() for v in tables.values()),
        "seeded out DP tables differ from the cold ones")
    same_answers("server out n=13", out1, out2, inv13)

    # the plan cache: the first pass against DPsub, the replay from cache
    first, _ = res10["cache_first"]
    replay, n_replay = res10["cache_replay"]
    same_cmax("server plan cache first", cliques15, first, cmax15)
    check(n_replay["plan_cache_hits"] == 16 and n_replay["solves"] == 0
          and sum(n_replay["launches"].values()) == 0
          and all(r.cache_hit for r in replay),
          f"the replay was not answered by the plan cache: {n_replay}")
    same_answers("server plan-cache replay", first, replay, inv15)

    # the host engine: ranked_conv launched, answers == fused server
    host_resp, n_host = res10["host13"]
    check(n_host["launches"]["ranked_conv"] > 0,
          f"the host-engine server launched {n_host['launches']}")
    fused_resp = server()._process([PlanRequest(q=q, card=c)
                                    for q, c in host_items])
    for i, (a, b) in enumerate(zip(host_resp, fused_resp)):
        check(float(a.cost).hex() == float(b.cost).hex()
              and str(a.tree) == str(b.tree),
              f"host-engine server #{i} differs from the fused server")
    same_cmax("server host engine n=13", host_items, host_resp,
              [dpsub(c, 13, mode="max")[-1] for _, c in host_items])
    print(f"server: every warm pass == its reference answer (DPsub, the "
          f"cap pipeline, the DPccp enumerator); rounds cold "
          f"{n_cold['rounds']} -> seeded {n_warm['rounds']} (max n=15), "
          f"{n_max13['rounds']} -> {n_cap13['rounds']} (cap n=13 after "
          f"max); launches over the warm passes {server_launches} {card}",
          flush=True)

    # -------------------------------------------------------- 11. runtime
    # The serving runtime (PlanServer.serve, the async front end, prewarm)
    # on one seeded stream at the int32 tier's sizes, n = 12..15, B = 16.
    # Every pass runs once on fresh servers to warm up ("first call"),
    # then again, timed, counted and checked ("warm").
    import asyncio
    from collections import Counter

    from repro_torch.service import faults
    from repro_torch.service.canon import topology_signature
    from repro_torch.service.router import Router
    from repro_torch.service.runtime import (RuntimeConfig, VirtualClock,
                                             WallClock)
    from repro_torch.service.workload import WorkloadSpec, make_workload

    spec = WorkloadSpec(n_requests=RUNTIME_REQUESTS, seed=RUNTIME_SEED,
                        n_range=(12, 15),
                        topologies=("clique", "chain", "star", "cycle"),
                        pool_size=16, relabel_frac=0.5, fresh_frac=0.1,
                        rate=200.0)
    stream = make_workload(spec)
    router0 = Router()
    routes0 = [router0.route(r.q, r.cost, None,
                             signature=topology_signature(r.q))
               for r in stream]
    route_mix = Counter(f"{rt.method}/{rt.lane}" for rt in routes0)
    # the approx lane (dense out and smj above n = 13) costs minutes of
    # host numpy per n >= 14 solve: the stream's seed is one whose
    # requests route to every other lane and never there
    check(route_mix.get("approx/single", 0) == 0,
          f"the runtime stream routes to the approx lane: {route_mix}")
    check(route_mix.get("dpconv/batch", 0) > 0
          and route_mix.get("dpccp/batch", 0) > 0
          and route_mix.get("dpconv/single", 0) > 0
          and route_mix.get("dpccp/single", 0) > 0,
          f"the runtime stream misses a lane: {route_mix}")

    def is_clique(q):
        return len(q.edges) == q.n * (q.n - 1) // 2

    # the answers a fresh server's plan_one gives, and numpy DPsub for
    # the clique max optima
    t0 = time.perf_counter()
    oracle_srv = PlanServer()
    want = {r.req_id: oracle_srv.plan_one(r.q, r.card, cost=r.cost)
            for r in stream}
    dpsub_max = {}
    for r in stream:
        if r.cost == "max" and is_clique(r.q):
            dpsub_max[r.req_id] = dpsub(r.card, r.q.n, mode="max")[-1]
            check(float(want[r.req_id].cost).hex()
                  == float(dpsub_max[r.req_id]).hex(),
                  f"plan_one clique({r.q.n}) max {want[r.req_id].cost!r} "
                  f"!= DPsub {dpsub_max[r.req_id]!r}")
    check(len(dpsub_max) > 0, "the runtime stream has no clique max")
    t_oracle = time.perf_counter() - t0
    print(f"runtime: stream of {len(stream)} requests (seed {RUNTIME_SEED},"
          f" n = 12..15), routes {dict(sorted(route_mix.items()))}, "
          f"{len(dpsub_max)} clique max requests; plan_one answers and "
          f"DPsub optima in {t_oracle:.2f} s", flush=True)

    def same_as_plan_one(label, reqs, resps, wanted):
        for r, got in zip(reqs, resps):
            w = wanted[r.req_id]
            check(got is not None and got.status == "exact",
                  f"{label} #{r.req_id}: status "
                  f"{None if got is None else got.status}")
            check(float(got.cost).hex() == float(w.cost).hex(),
                  f"{label} #{r.req_id}: {got.cost!r} != plan_one "
                  f"{w.cost!r}")
            check(str(got.tree) == str(w.tree),
                  f"{label} #{r.req_id}: tree differs from plan_one's")
            if r.req_id in dpsub_max:
                check(float(got.cost).hex()
                      == float(dpsub_max[r.req_id]).hex(),
                      f"{label} #{r.req_id}: != DPsub")

    def no_faults(label, rt):
        """The failure ladder never engaged: no failure, retry, reroute,
        watchdog fire, quarantine, degraded response, shed or error."""
        fs = rt.fstats.as_dict()
        check(all(v == 0 for v in fs.values()),
              f"{label}: the failure ladder engaged: "
              f"{ {k: v for k, v in fs.items() if v} }")
        st = rt.stats
        check(st.shed == st.shed_backpressure == st.downgraded
              == st.deadline_misses == 0,
              f"{label}: shed/downgraded/missed {st.as_dict()}")
        bad = {k: v for k, v in rt.recorder.counts.items()
               if k != "completed" and v}
        check(not bad, f"{label}: flight-recorder incidents {bad}")
        check(not rt.breakers.lanes and
              rt.quarantine.snapshot()["added"] == 0,
              f"{label}: breakers {rt.breakers.snapshot()}")

    def runtime_pass(label, run):
        """Time and count one pass: ``run()`` returns (requests,
        responses, runtimes, server).  Returns the numbers."""
        torch.cuda.synchronize()
        engine.reset_stats()
        ops.reset_launch_counts()
        mark = engine.dispatch_mark()
        t0 = time.perf_counter()
        reqs, resps, rts, srv = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        recs = engine.dispatches_since(mark)
        lat = np.array([r.latency for r in resps]) * 1e3
        st = [rt.stats for rt in rts]
        batches = sum(s.batches for s in st)
        items = sum(s.batched_items for s in st)
        num = {"requests": len(reqs), "wall_s": dt,
               "requests_per_s": len(reqs) / dt,
               "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)),
               "batches": batches,
               "batch_lane_s": sum(s.solve_s for s in st),
               "occupancy": items / batches if batches else 0.0,
               "coalesced": sum(s.coalesced for s in st),
               "fast_path_hits": sum(s.fast_path_hits for s in st),
               "plan_cache_hits": srv.cache.stats.hits,
               "dispatches": len(recs),
               "execute_s": sum(r.execute_s for r in recs),
               "compile_s": sum(r.compile_s for r in recs),
               "aot_hits": sum(r.aot_cache_hit for r in recs),
               "records": recs, "launches": ops.launch_counts()}
        print(f"runtime {label}: {len(reqs)} requests in {dt:.4f} s, "
              f"{num['requests_per_s']:.2f} requests/s, latency p50 "
              f"{num['p50_ms']:.3f} ms p99 {num['p99_ms']:.3f} ms, "
              f"{batches} batches ({num['batch_lane_s']:.4f} s of batch-"
              f"lane work), mean occupancy "
              f"{num['occupancy']:.3f}, coalesced {num['coalesced']}, "
              f"fast-path hits {num['fast_path_hits']}, plan-cache hits "
              f"{num['plan_cache_hits']}; dispatch records {len(recs)} "
              f"(execute {num['execute_s']:.4f} s, build "
              f"{num['compile_s']:.4f} s, program-cache hits "
              f"{num['aot_hits']}), launches {num['launches']} {card}",
              flush=True)
        return reqs, resps, rts, srv, num

    def covered(rec, manifest):
        """Did prewarm build this dispatch's bucket?"""
        base = rec.cost[:-len("_seeded")] if rec.cost.endswith("_seeded") \
            else rec.cost
        for e in manifest:
            warm = (e["cost"], e["cost"] + "_seeded") \
                if e["cost"] in ("max", "cap") else (e["cost"],)
            if (e["n"] == rec.n and e["cost"] == base and rec.cost in warm
                    and rec.B <= e["max_batch"]
                    and rec.backend == e["backend"]):
                return True
        return False

    prewarms = []

    def pass_prewarm(cold):
        srv = PlanServer()
        if cold:       # prewarm builds every bucket it covers from nothing
            engine.clear_executable_cache()
        t0 = time.perf_counter()
        pw = srv.prewarm(range(12, 16))
        pw_s = time.perf_counter() - t0
        prewarms.append((pw, pw_s))
        resps, _ = srv.serve(list(stream), closed_loop=True)
        return stream, resps, [srv.last_runtime], srv

    def pass_serve(closed_loop):
        def run():
            srv = PlanServer()
            resps, _ = srv.serve(list(stream), closed_loop=closed_loop)
            return stream, resps, [srv.last_runtime], srv
        return run

    pairs16 = [qg.paper_clique_instance(15, 900 + s) for s in range(8)]
    dup16, _ = relabeled(pairs16, 13)
    async_reqs = [PlanRequest(q=q, card=c, cost="max", req_id=1000 + i)
                  for i, (q, c) in enumerate(pairs16 + dup16)]
    want_async = {r.req_id: oracle_srv.plan_one(r.q, r.card, cost="max")
                  for r in async_reqs}
    dpsub_async = {}
    for r in async_reqs[:8]:
        dpsub_async[r.req_id] = dpsub(r.card, 15, mode="max")[-1]

    def pass_async():
        srv = PlanServer()

        async def main():
            return await asyncio.gather(*(
                srv.plan_request_async(r) for r in async_reqs))
        try:
            resps = asyncio.run(main())
        finally:
            srv.async_runtime().close()
        return async_reqs, resps, [srv.async_runtime()], srv

    def pass_lanes():
        srv = PlanServer(lanes=2)
        rt = srv.make_runtime(clock=WallClock(), executor="thread")
        tickets = []
        try:
            for i in range(0, len(stream), srv.max_batch):
                tickets += [rt.submit(r)
                            for r in stream[i:i + srv.max_batch]]
                rt.drain()
        finally:
            rt.close()
        check(all(t.done and not t.refused for t in tickets),
              "lanes=2: a request was not answered")
        check({s.device.type for s in rt._solvers} == {"cuda"},
              "lanes=2: a lane solver left the card")
        return stream, [t.response for t in tickets], [rt], srv

    host13 = [r for r in stream if r.q.n == 13]

    def pass_host():
        srv = PlanServer(batch_policy=BatchPolicy(engine="host"))
        resps, _ = srv.serve(list(host13), closed_loop=True)
        return host13, resps, [srv.last_runtime], srv

    passes = [("prewarm + stream", None),
              ("serve closed loop", pass_serve(True)),
              ("serve at arrivals", pass_serve(False)),
              ("plan_async x16", pass_async),
              ("lanes=2 thread", pass_lanes),
              ("host engine n=13", pass_host)]
    res11 = {}
    for tag in ("first call", "warm"):
        for pname, run in passes:
            if run is None:
                run = (lambda cold=(tag == "first call"):
                       pass_prewarm(cold))
            res11[pname] = runtime_pass(f"{tag}, {pname}", run)
    runtime_launches = {k: 0 for k in build.KERNELS}
    for pname, (reqs, resps, rts, srv, num) in res11.items():
        wanted = want_async if pname.startswith("plan_async") else want
        same_as_plan_one(f"runtime {pname}", reqs, resps, wanted)
        for rt in rts:
            no_faults(f"runtime {pname}", rt)
        for k, v in num["launches"].items():
            runtime_launches[k] += v
    for rid, v in dpsub_async.items():
        got = next(r for r in res11["plan_async x16"][1] if r.req_id == rid)
        check(float(got.cost).hex() == float(v).hex(),
              f"plan_async #{rid}: {got.cost!r} != DPsub {v!r}")
    # prewarm: every dispatch of a prewarmed bucket is a cache hit
    srv_a, num_a = res11["prewarm + stream"][3], res11["prewarm + stream"][4]
    (pw0, pw0_s), (pw, pw_s) = prewarms
    cov = [r for r in num_a["records"] if covered(r, srv_a.prewarm_manifest)]
    check(cov and all(r.aot_cache_hit and r.compile_s == 0.0 for r in cov),
          f"a prewarmed bucket missed: "
          f"{[(r.cost, r.n, r.B) for r in cov if not r.aot_cache_hit]}")
    check(all(r.execute_s > 0 and r.flops > 0 and r.bytes_accessed > 0
              and r.devices == (str(srv_a.device),)
              for r in num_a["records"]),
          "a dispatch record lacks its device time or work count")
    check(pw0["compiled"] > 0 and pw["compiled"] == 0,
          f"prewarm built {pw0['compiled']} programs from a cold cache, "
          f"then {pw['compiled']}")
    print(f"runtime prewarm: {len(srv_a.prewarm_manifest)} (n, cost) "
          f"buckets, {pw0['compiled']} programs built and first-touched in "
          f"{pw0_s:.3f} s from a cold program cache (warm run: "
          f"{pw['compiled']} in {pw_s:.4f} s); {len(cov)} of "
          f"{len(num_a['records'])} stream dispatches in prewarmed "
          f"buckets, all program-cache hits {card}", flush=True)
    # the async front end: 8 relabelled duplicates coalesce or hit
    num_d = res11["plan_async x16"][4]
    check(num_d["coalesced"] + num_d["fast_path_hits"]
          + num_d["plan_cache_hits"] >= 8,
          f"plan_async: duplicates were solved again: {num_d}")
    # the host engine launches the ranked convolution
    check(res11["host engine n=13"][4]["launches"]["ranked_conv"] > 0,
          "the host-engine runtime pass launched no ranked_conv")
    check(runtime_launches["zeta_cluster"] > 0,
          "the runtime passes launched no zeta_cluster")

    # (g) chaos: a seeded fault plan on a VirtualClock with injected
    # durations (and fixed chunk timings for the router's prices), run
    # twice from a cold program cache: the two runs replay identically
    def chaos_run():
        engine.clear_executable_cache()
        srv = PlanServer()
        observe = srv._observe_batch
        srv._observe_batch = lambda timings: observe(
            [(n, cnt, 1e-3 * cnt, eng, cost, tags)
             for n, cnt, _, eng, cost, tags in timings])
        inj = faults.FaultInjector(faults.FaultPlan.chaos(seed=CHAOS_SEED,
                                                          rate=0.01))
        rt = srv.make_runtime(
            clock=VirtualClock(), injector=inj,
            duration_fn=lambda what, info: {"admit": 0.0, "solve": 0.05,
                                            "single": 0.02}[what],
            config=RuntimeConfig(watchdog_min=0.5, retry_backoff=1e-3,
                                 retry_backoff_cap=0.05))
        try:
            tickets = [rt.submit(r) for r in stream]
            rt.drain()
        finally:
            rt.close()
        check(not rt._inflight and not rt._by_key,
              "chaos: work left in flight")
        key = [(t.request.req_id, t.status, t.refuse_reason,
                None if t.error is None else repr(t.error),
                None if t.response is None
                else (float(t.response.cost).hex(), str(t.response.tree)),
                t.completed_at) for t in tickets]
        return tickets, key, rt.fstats.as_dict(), inj.snapshot()

    t0 = time.perf_counter()
    tickets_g, key1, fstats_g, inj_g = chaos_run()
    _, key2, fstats_g2, inj_g2 = chaos_run()
    t_chaos = time.perf_counter() - t0
    check(key1 == key2 and fstats_g == fstats_g2 and inj_g == inj_g2,
          "chaos: the two runs differ")
    check(inj_g["fired"] > 0, "chaos: no fault fired")
    statuses = Counter(t.status for t in tickets_g)
    for t in tickets_g:
        r = t.request
        if t.status == "exact":
            same_as_plan_one("chaos exact", [r], [t.response], want)
        elif t.status == "degraded":
            cert = t.response.meta.get("certificate")
            check(cert is not None
                  and cert["upper_bound"] == t.response.cost,
                  f"chaos #{r.req_id}: degraded without its certificate")
        else:
            check(t.status == "error"
                  and isinstance(t.error, faults.PlanError),
                  f"chaos #{r.req_id}: untyped failure {t.error!r}")
    print(f"runtime chaos: FaultPlan.chaos(seed={CHAOS_SEED}, rate=0.01), "
          f"two runs identical ({t_chaos:.2f} s for both), statuses "
          f"{dict(statuses)}, faults fired {inj_g['fired']}, "
          f"{ {k: v for k, v in fstats_g.items() if v} }; every exact "
          f"answer == plan_one, every degraded one certified", flush=True)
    print(f"runtime: every warm pass == plan_one (and DPsub for clique "
          f"max), no fault, retry, reroute, watchdog fire, shed or error; "
          f"launches over the warm passes {runtime_launches} {card}",
          flush=True)

    # ----------------------------------------------------------- 12. times
    # Device time per launch from torch.profiler (self device time of the
    # kernel, by name), warm and after a 64 MB write (L2 cold);
    # "host-launched call" = CUDA events around 50 calls issued back to
    # back from Python; host cost = perf_counter per wrapper call, no
    # sync, over 1000 calls.
    x = on_card(rng.integers(0, 2, (16, 1 << 15)).astype(np.int32))
    total = x.numel()
    out = torch.empty_like(x)
    rows = []
    scratch = torch.empty(16 << 20, dtype=torch.int32, device=dev)

    def flush_l2():
        scratch.fill_(1)

    def row(kernel, names, source, replaces, launch, plain, nbytes, nops,
            launches, shape):
        dev_ms, per_call, tries = device_ms(launch, names)
        cold_ms, _, tries_cold = device_ms(launch, names, between=flush_l2)
        call_ms = time_ms(launch)
        host = host_us(launch)
        plain_ms = time_ms(plain)
        b_ms, b_by = bound(nbytes, nops)
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err[kernel], "ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "ms_method": "torch.profiler self device time",
                     "profiler_sessions": [tries, tries_cold],
                     "ms_l2_cold": cold_ms,
                     "host_call_ms": call_ms, "host_us_per_launch": host,
                     "shape": shape})
        print(f"time {kernel} {shape}: device {dev_ms:.5f} ms per launch "
              f"warm, {cold_ms:.5f} ms L2 cold (torch.profiler, "
              f"{per_call:g} kernel(s) per call, profiler sessions "
              f"{tries} / {tries_cold}), "
              f"host-launched call {call_ms:.5f} ms, host cost "
              f"{host:.2f} us per launch, plain {plain_ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}) {card}", flush=True)

    launches = {k: counts5[k] + counts6[k] + counts8[k] + counts8k[k]
                + counts9[k] + server_launches[k] + runtime_launches[k]
                for k in build.KERNELS}
    row("zeta_cluster", ("zeta_cluster_kernel",),
        "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:53",
        lambda: launch_cluster(x, out, 15, 1),
        lambda: ref.zeta_ref(x),
        8 * total, total // 2 * 15, launches["zeta_cluster"],
        "(16, 2^15) int32, 15 bits")
    # the pair kernel serves bits >= 15 only: bit 15 of an (8, 2^16)
    # table, as many elements as the row above
    xp = on_card(rng.integers(0, 2, (8, 1 << 16)).astype(np.int32))
    row("zeta_pair", ("zeta_pair_kernel",), "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:101",
        lambda: launch_pair(xp, 15, 1),
        lambda: ref.zeta_stages_ref(xp, 1, 15, 16),
        4 * total + 4 * total // 2, total // 2, launches["zeta_pair"],
        "(8, 2^16) int32, bit 15")
    k = 8
    rest = Z[0].numel()
    row("ranked_conv", ("ranked_conv",), "src/repro_torch/csrc/ranked_conv.cu",
        "src/repro/kernels/ranked_conv.py:31",
        lambda: ranked_conv_cuda(Z, k),
        lambda: ref.ranked_conv_ref(Z, k),
        4 * rest * (k - 1) + 4 * rest, rest * k, launches["ranked_conv"],
        "(16, 16, 2^15) int32, k = 8")
    # one whole transform, warm in L2 and after a 64 MB write (L2 cold)
    for shape in [(16, 1 << 15), (16, 16, 1 << 15)]:
        xt = on_card(rng.integers(0, 2, shape).astype(np.int32))
        ot = torch.empty_like(xt)
        fn = lambda: ops.zeta_op(xt, out=ot)    # noqa: E731
        warm, per_call, tries = device_ms(fn, ZETA_KERNELS)
        cold, _, tries_cold = device_ms(fn, ZETA_KERNELS, between=flush_l2)
        call_ms = time_ms(fn)
        plain = time_ms(lambda: ref.zeta_ref(xt))
        b_ms, _ = bound(8 * xt.numel(), xt.numel() // 2 * 15)
        print(f"time zeta transform {shape}: device {warm:.5f} ms warm, "
              f"{cold:.5f} ms L2 cold ({per_call:g} launches per "
              f"transform, torch.profiler), host-launched call "
              f"{call_ms:.5f} ms, plain {plain:.5f} ms, bound {b_ms:.5f} ms "
              f"({100 * b_ms / cold:.1f}% of it cold), profiler sessions "
              f"{tries} / {tries_cold} {card}", flush=True)
    del scratch
    print(f"launches per solve: fused lane "
          f"{ {k: v / chunks5 for k, v in counts5.items()} } over "
          f"{chunks5} chunk solves; host lane {counts6} over 1 solve",
          flush=True)
    print(f"throughput: fused lane (phase 5) {qps5:.3f} queries/s, f64 "
          f"tier n=18 (phase 7) {qps7:.4f} queries/s, cap lane n=15 "
          f"(phase 8) {qps8:.3f} queries/s, out lane n=15 (phase 9) "
          f"{qps9:.3f} queries/s, server max n=15 cold / seeded "
          f"(phase 10) {n_cold['requests_per_s']:.3f} / "
          f"{n_warm['requests_per_s']:.3f} requests/s {card}", flush=True)

    loaded = [m for m in sys.modules
              if m.split(".")[0] == "jax" or m.startswith("repro.")
              or m == "repro"]
    check(not loaded, f"the smoke imported {loaded}")
    print("kernels: " + ", ".join(f"{k} {launches[k]}"
                                  for k in build.KERNELS))
    print(smi_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
