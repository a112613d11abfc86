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
10. times    — each kernel at the path's shapes: device time per launch
               (torch.profiler) warm and with L2 cold, the host-launched
               call (CUDA events around 50 calls from Python), the host's
               cost per launch, its bound and its plain version; one
               whole transform warm and with L2 cold; launches per solve,
               solved queries per second.

Phases 8 and 9 print wall time, solved queries per second, peak device
memory and host syncs per solve.  Launch counters are set to 0 just
before each main-path phase (5, 6, 8, 9) and read just after.  Data comes from fixed seeds through numpy.  The
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
    """Device milliseconds per call of ``fn`` and kernel launches per
    call: torch.profiler's self device time of the kernels whose name
    holds one of ``names``, summed over ``iters`` calls.  ``between``
    runs before each call (an L2 flush); its kernels are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
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
    check(launched > 0 and us > 0,
          f"torch.profiler saw no device time of {names}")
    return us * 1e-3 / iters, launched / iters


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
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    card = f"[{smi_line}]"
    print(f"card: {name}, devices: {count}, torch {torch.__version__}, "
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

    # ----------------------------------------------------------- 10. times
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
        dev_ms, per_call = device_ms(launch, names)
        cold_ms, _ = device_ms(launch, names, between=flush_l2)
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
                     "ms_l2_cold": cold_ms,
                     "host_call_ms": call_ms, "host_us_per_launch": host,
                     "shape": shape})
        print(f"time {kernel} {shape}: device {dev_ms:.5f} ms per launch "
              f"warm, {cold_ms:.5f} ms L2 cold (torch.profiler, "
              f"{per_call:g} kernel(s) per call), "
              f"host-launched call {call_ms:.5f} ms, host cost "
              f"{host:.2f} us per launch, plain {plain_ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}) {card}", flush=True)

    launches = {k: counts5[k] + counts6[k] + counts8[k] + counts8k[k]
                + counts9[k] for k in build.KERNELS}
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
        warm, per_call = device_ms(fn, ZETA_KERNELS)
        cold, _ = device_ms(fn, ZETA_KERNELS, between=flush_l2)
        call_ms = time_ms(fn)
        plain = time_ms(lambda: ref.zeta_ref(xt))
        b_ms, _ = bound(8 * xt.numel(), xt.numel() // 2 * 15)
        print(f"time zeta transform {shape}: device {warm:.5f} ms warm, "
              f"{cold:.5f} ms L2 cold ({per_call:g} launches per "
              f"transform, torch.profiler), host-launched call "
              f"{call_ms:.5f} ms, plain {plain:.5f} ms, bound {b_ms:.5f} ms "
              f"({100 * b_ms / cold:.1f}% of it cold) {card}", flush=True)
    del scratch
    print(f"launches per solve: fused lane "
          f"{ {k: v / chunks5 for k, v in counts5.items()} } over "
          f"{chunks5} chunk solves; host lane {counts6} over 1 solve",
          flush=True)
    print(f"throughput: fused lane (phase 5) {qps5:.3f} queries/s, f64 "
          f"tier n=18 (phase 7) {qps7:.4f} queries/s, cap lane n=15 "
          f"(phase 8) {qps8:.3f} queries/s, out lane n=15 (phase 9) "
          f"{qps9:.3f} queries/s {card}", flush=True)

    loaded = [m for m in sys.modules
              if m.split(".")[0] == "jax" or m.startswith("repro.")
              or m == "repro"]
    check(not loaded, f"the smoke imported {loaded}")
    print("kernels: " + ", ".join(f"{k} {launches[k]}"
                                  for k in build.KERNELS))
    print(smi_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
