#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. card      — name, count, and ``nvidia-smi`` name and power limit;
2. build     — ``nvcc`` builds every kernel of ``src/repro_torch/csrc``;
3. zeta      — every launch of a transform's plan (``zeta_cluster``
               for the low min(n, 15) bits, 14 in f64, ``zeta_high`` for
               each chunk of at most 5 higher bits) against its plain
               PyTorch
               version on the card, bitwise, n = 0..17 and, for the
               high bits, (1, 2^n) at n = 18..21 and (8, 2^20), int32,
               f32 and f64 (the float64 tier's), fresh and in place;
4. conv      — the ranked-convolution kernel against its plain version;
5. fused     — the DPconv[max] batch lane (``BatchedSolver``, default
               policy: fused engine, int32 kernel tier for n = 12..15) on
               16 paper Sec. 9 clique(15) queries plus chain/star/cycle
               at n = 12..15 and one clique(12); optima and trees equal
               the f64 tier's, the clique(12) optimum equals the O(3^n)
               oracle; one ``zeta_cluster`` launch per transform, no
               ``zeta_high``, and the rounds and passes of the reference;
6. host      — the same lane on the host engine (n = 13, B = 4), where
               the ranked-convolution kernel runs; optima equal the f64
               tier's;
7. large     — 4 clique(18) queries, above the int32 envelope: ``auto``
               takes the f64 tier, which launches the zeta kernels only:
               one ``zeta_cluster`` launch and one ``zeta_high`` launch
               per transform (the plan's ceil((n - 15) / 5) at n = 18),
               no ``ranked_conv`` (the tier's convolution is the plain
               one);
8. cap       — the C_cap lane (default policy: fused engine, pass 1 on
               the f64 tier as in the reference) on 16 clique(15) queries
               as ``"cap"`` and chain/star/cycle(15) as ``"cap_conn"``;
               caps, C_out values and trees equal the host pipeline's
               (``ccap(engine="host")``); pass 1 launches the zeta
               kernels only (a ``zeta_cluster`` and a ``zeta_high``
               launch per f64 transform at n = 15, no ``ranked_conv``);
               then ``fused_ccap`` on the kernel tier over the 16 cliques
               equals the f64 tier, with one ``zeta_cluster`` launch per
               transform, no ``zeta_high``; pass 2 is one
               ``minplus_layer`` launch per layer;
9. out       — the C_out lane (fused DPccp, one program call per chunk)
               on 16 clique(15) plus chain/star/cycle(15): optima, trees
               and DP tables equal numpy DPsub (cliques) and the DPccp
               enumerator (sparse graphs), one ``connmask`` launch (the
               connected-subset masks) and one ``minplus_layer`` launch
               per layer a call, and no other kernel; one micro-batch at
               n = 13
               with all four lane costs comes back in request order;
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
               star and cycle, the default cost mix, 200 requests/s), a
               C_out request on chain(14) with a hyperedge, which the
               DPccp enumerator answers on the single lane, and a
               connected C_cap request on clique(12) with a hyperedge,
               which the host C_cap pipeline answers, equal to
               ``ccap(engine="host")``; every other cap and sparse out
               stays on the fused batch lane; B = 16:
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
12. early exit — the paper's Fig. 6 path: ``paper_clique_instance(n, n)``
               at n = 14..19 through ``dpconv_max`` with ``early_exit``
               (the host loop's dyadic-window abort), the host loop's
               (G+1)-ary search (G = 3) and the fused engine (f64, and
               the kernel tier at n <= 15); optima (``float.hex``) and
               trees equal across variants, the host loops' passes equal
               the reference's search replayed on the candidate table,
               n = 14, 15 equal numpy DPsub;
13. planner  — ``model_planner_trace`` of the ten configs at full width
               as max, out (fused DPccp) and cap by ``optimize`` on the
               card (against DPsub and the host C_cap pipeline) and
               through one ``PlanServer`` (a second pass all plan-cache
               hits); ``execute_plan`` in float64 on the card against
               one ``torch.einsum`` (relative error <= 1e-10 of the
               result's largest magnitude) for reduced qwen2-0.5b and the
               demo's contraction; the demo's data-join pipeline planned
               on the card and executed (numpy) in three orders; the
               einsum replay lane (96 requests, seed 2) through ``serve``,
               each answer against ``optimize`` with the route's method;
14. cluster  — three ``LoopbackTransport`` replicas on the card (fused
               engine, batch lane) serving phase 11's stream, every
               answer equal to ``plan_one``; a spread client publishing
               to the owners, replayed through them; the seeded loopback
               chaos run twice, identical; ``ReplicaCluster(2)`` over TCP
               as spawned processes on the card with replica 0's prewarm
               manifest shipped to the peer, 24 requests, and the two
               flight-recorder dumps merged by ``scripts/obs_tail.py``;
15. times    — the (min,+) sweep kernel (``minplus_layer``) against the
               gather sweep on the card, bitwise, with the launch counts
               reset before it: n = 13, B = 16 connected and seeded, and
               n = 19, B = 1 value gated at a clique's C_max optimum;
               the connected-subset mask kernel (``connmask``) against
               ``QueryGraph.connected_mask`` and its plain version at
               (4, 2^19) and (16, 2^13), bitwise, one launch a call;
               each kernel at the path's shapes (``minplus_layer`` as
               whole sweeps): device time per call
               (torch.profiler) warm and with L2 cold, the host-launched
               call (CUDA events around 50 calls from Python), the host's
               cost per launch, its bound and its plain version; one
               whole transform warm and with L2 cold; launches per solve,
               solved queries per second;
16. sharded  — the sharded lattice solve with ``force_device_count(4)``
               (cuda:0 fills four solve-mesh slots) and, when more than
               one card is visible, on a mesh of distinct cards:
               ``paper_clique_instance(n, n)`` at n = 14, 15 as max
               (kernel tier), cap and out (fused DPccp), and a cycle as
               connected cap, on D = 1, 2, 4, each built once and then
               timed three times, held bitwise against the unsharded
               fused solve and the host pipelines (DPsub for out), with
               the median wall per solve and device memory, and one
               ``connmask`` launch a connected (out, cap_conn) call; then
               a ``BatchPolicy(solve_shards=4)`` server (cap/out ceilings
               lifted to 15) on the repeated card, prewarmed and serving
               phase 11's stream, every answer equal to an unsharded
               server's ``plan_one``, n >= 14 simple-edge cap/out on the
               batch lane over the 4-slot mesh.  It runs after phase 15; its
               launches join the kernel table;
17. LM serve — the LM side, which runs none of the three kernels: (a)
               the ten reduced configs in float32, the port's
               teacher-forced decode against its forward (B = 2, S = 40,
               within 2e-3 of a position's largest |logit|; MoE at
               capacity_factor 16), int8 KV caches of qwen3-0.6b and
               zamba2-1.2b within 5e-2, and the card's logits against the
               port's on the CPU on the same weights; (b) gemma3-1b at its
               published width in bf16 through ``launch.serve.main``
               (batch 8, prompt 512 + gen 64: every local ring wraps),
               the decode path's logits of all 576 positions against
               ``make_prefill_step``'s, then one decode step profiled and
               timed (see ``lm_serve_phase``);
18. LM train — LM training, which runs none of the three kernels (see
               ``lm_train_phase``): (a) the ten reduced configs' train
               steps in float32, card against CPU on the same state and
               batch (loss, ce, aux, grad norm, every gradient leaf),
               accum 2 against 1, and the mini cyclic stream's CE halving
               on the card; (b) qwen2-0.5b at its published width in bf16
               through ``launch.train.main`` (batch 8 × seq 4096, accum
               2) on cuda:0 alone, its first-step loss and gradient norm
               against a float32 step of the same weights and batch, then
               one step profiled; (c) the fail-at-step-9-and-resume
               contract as three ``launch.train`` processes on cuda:0;
19. LM data parallel — ``launch.train --data-mesh D`` over the D visible
               cards (D worker processes, NCCL; D = 1 on a one-card host
               still goes through the process group), which runs none of
               the three kernels (see ``lm_dp_phase``): (a) qwen2-0.5b at
               its published width, the first step of phase 18 (b)'s run
               at D cards, its loss and gradient norm against phase 18's
               one-card first step; (b) weak scaling, 8·D sequences a
               step (each card runs phase 18's rows): s per step,
               tokens/s against D times phase 18's, the share of
               ``costmodel.roofline_terms``'s bound, each card's masters
               + moments, its peak while the state is built and its peak
               above them in the steps, and the step's collective time
               (each collective's least time over the ranks, and rank
               0's with its waits);
20. LM tensor parallel — ``launch.train`` on ('data', 'model') = (D, T)
               meshes of the visible cards (NCCL worker processes),
               qwen3-0.6b at its published width, which runs none of the
               three kernels (see ``lm_tp_phase``): one card in this
               process, then (1, 1) through the spawned ranks on a
               one-card host (bitwise one card's first step), or (1, N)
               and (2, N // 2) on N cards (within 1e-3): s per step and
               tokens/s against one card's, the share of
               ``roofline_terms(n_chips=D·T, tp=T)``'s bound, each
               card's masters + moments and peaks, the 'data' and
               'model' collective seconds, the gathered leaves; then the
               same meshes in float32 (within 1e-5).
               ``python3 chip_smoke.py --phase 20`` runs phases 1 and 20
               alone;
21. LM serve over 'model' — ``launch.serve.serve_on_mesh`` (NCCL worker
               processes, each rank its part of the model and its block
               of the KV cache; ``train.tp``'s "Serving"), which runs
               none of the three kernels (see ``lm_serve_tp_phase``):
               (a) qwen3-0.6b at its published width in bf16, batch 8,
               prompt 512 + gen 64, in this process and through one
               spawned rank at (1, 1): tokens, decode and prefill logits
               bitwise; (b) on N >= 2 cards, (1, 2) and (1, 4) for
               qwen3-0.6b and (1, 2) for gemma3-1b (one KV head: the
               cache's sequence axis split over 'model'), fed one card's
               tokens, decode and prefill logits within LM_TP_BF16_RTOL
               of one card's, and in float32 qwen3-0.6b at (1, min(N, 4))
               and gemma3-1b at (1, 2) (the partial softmaxes' combine
               and the slot owner's writes over NCCL) within
               LM_TP_F32_RTOL: ms per decode step and tokens/s
               against one card's, KV-cache and parameter bytes a card
               at rest and as served, 'model' collective seconds a step;
               (c) both dry-run contract cells (``python -m
               repro_torch.launch.dryrun``, on the ``meta`` device under
               the fake process group, no card), run beside (a) and (b).
               ``python3 chip_smoke.py --phase 21`` runs phases 1 and 21
               alone.

Phases 8 and 9 print wall time, solved queries per second, peak device
memory and host syncs per solve; phase 10 prints each pass's wall time,
requests per second, cache hits, seeded solves, rounds, host syncs and
launches; phase 11 prints each pass's wall time, requests per second,
p50/p99 latency, batches, batch occupancy, coalesced joins, fast-path
and plan-cache hits, the engine's dispatch records (count, execute and
build seconds, program-cache hits) and launches; phases 12-14 print
wall time, passes or requests per second and launches per variant;
phase 17 prints tokens per second of the prompt through the decode path,
of generation and of ``make_prefill_step``, ms per decode step against
its bound, launches per step, device busy share and peak memory above
the weights; phase 18 prints s per step, tokens per second, the share
of the step that ``launch.costmodel.step_cost``'s bound is, MFU against
6·N·tokens, launches and device busy time of one profiled step, and the
peak memory split into masters + moments and what the step adds; phase
19 prints the same per card of D, with the collectives' time; phase 20
per (D, T) mesh, with the 'data' and 'model' collectives apart; phase
21 per serving mesh, and one line per dry-run cell.
Launch counters are set to 0 just before each main-path phase (5, 6, 8,
9, 12, 13, 14's loopback passes, 16's direct solves and its server
pass, 17's two parts, 18's three parts and its profiled step), each
server pass and each runtime pass, and read just after; phases 19's,
20's and 21's worker processes count from 0 each and hand their counts back,
which the table adds; spawned replicas count in their own processes, which
the table does not read.  Data comes from fixed seeds through numpy.  The second-to-last
line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a card, and
in a directory without the port.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores;
#                             32-bit integer adds and multiplies are
#                             counted against the same rate
F64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
ZETA_KERNELS = ("zeta_cluster_kernel", "zeta_high_kernel")
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
# phase 17: the card's float32 logits against the port's on the CPU
# (TF32 off; the sums run in other orders), and gemma3-1b's bf16 decode
# path against its prefill (bf16 keeps 8 bits; the two paths round at
# other places over 26 layers), each relative to a position's largest
# |logit|
LM_CARD_RTOL, LM_BF16_RTOL = 1e-4, 5e-2
# phase 18: the card's float32 train step against the port's on the CPU,
# relative to each leaf's largest |value|; (b)'s run and its gates on the
# first step's loss and gradient norm (see lm_train_phase for how
# TRAIN_BF16_RTOL and TRAIN_BF16_GNORM_RTOL were set)
TRAIN_CARD_RTOL, TRAIN_BF16_RTOL, TRAIN_BF16_GNORM_RTOL = 1e-4, 5e-3, 2e-2
# phase 19 (a): the D-card first step's loss and gradient norm against
# phase 18's one-card step, relative.  On the CPU, bf16 reduced configs
# (qwen2, qwen3, gemma3, olmoe, mamba2; B = 8, S = 128, accum 2) in 2 and
# 4 gloo processes land within 1.6e-7 (loss) and 3.7e-5 (gradient norm)
# of one process; the card's bf16 products of a rank's rows may round
# otherwise than the whole microbatch's (cuBLAS picks kernels by shape),
# which the CPU does not show, so 1e-3, about 27 times the largest CPU
# gap.  At D = 1 the step is bitwise the one-card step's on the CPU.
TRAIN_DP_RTOL = 1e-3
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = "qwen2-0.5b", 8, 4096, 2
# phase 20: the (D, T) mesh's first step against one card's, relative;
# 1e-3, phase 19's gate.  Split sums over heads, d_ff and the vocabulary
# round each rank's part to bf16 before they are added (in float32,
# train.tp).  On the CPU, bf16 reduced configs (qwen2, qwen3, gemma3,
# olmoe, mamba2; B = 8, S = 128, accum 2) at (1, 2), (1, 4) and (2, 2)
# land within 2.3e-5 (loss) and 9.3e-4 (gradient norm) of one process
# for the dense ones, 7.7e-4 for qwen3, and 4.0e-4 / 1.4e-3 for olmoe
# (bf16 moves tokens between experts).  At (1, 1) the step is bitwise
# one card's (the collectives are copies).
TRAIN_TP_RTOL = 1e-3
TP_ARCH = "qwen3-0.6b"
# phase 20 (c): the same meshes in float32 (TF32 off), first step within
# TRAIN_TP_F32_RTOL of one card's: on the CPU the ten reduced configs at
# (1, 2) and qwen3, olmoe and mamba2 at (2, 2) and (1, 4) land within
# 2.8e-7 (tests/test_torch_train_tp.py), so 1e-5.  Batch 4 × 1024 in two
# microbatches: one row a data rank at (2, 2).  launch.train's workers
# resolve the float32 config by name; they import this script as their
# main module, which registers it (_register_f32).
TRAIN_TP_F32_RTOL = 1e-5
TP_F32_ARCH, TP_F32_BATCH, TP_F32_SEQ = TP_ARCH + "-f32", 4, 1024
# a step takes about 10 s on the card (PERF.md §5): one warm-up and two
# timed steps keep the phase near two minutes
TRAIN_WARM, TRAIN_TIMED = 1, 2
# phase 21: serving over 'model', phase 17's traffic; the logits compared
# at every 32nd prompt position and every 4th generated one.  A mesh's
# bf16 logits against one card's, relative to a position's largest
# |logit|: each rank rounds its part of a split sum to bf16 before the
# parts are added (in float32, train.tp).  On the CPU, bf16 reduced
# qwen3 at (1, 2) and (1, 4), gemma3 and qwen2 at (1, 2) (batch 8,
# prompt 72 + gen 16, fed one process's tokens) land within 2.76e-2 of
# one process, decode and prefill alike; so phase 17's 5e-2.  In float32
# the reduced configs land within 1.5e-6 (tests/test_torch_serve_tp.py),
# so 1e-5.  At (1, 1) every collective is a copy: bitwise.
LM_TP_BF16_RTOL, LM_TP_F32_RTOL = 5e-2, 1e-5
SERVE_TP_ARCH, SERVE_SPLIT_ARCH = "qwen3-0.6b", "gemma3-1b"
B21, P21, G21 = 8, 512, 64
KEEP21 = list(range(0, P21, 32)) + list(range(P21, P21 + G21, 4))
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "pod"),
                ("mamba2-130m", "decode_32k", "multipod"))


def _register_f32() -> None:
    """TP_F32_ARCH: TP_ARCH in float32, in the port's registry (phase 20
    (c)); a no-op where the port is not importable."""
    import dataclasses
    try:
        from repro_torch import configs
    except ImportError:
        return
    configs.ARCHS[TP_F32_ARCH] = dataclasses.replace(
        configs.ARCHS[TP_ARCH], name=TP_F32_ARCH, dtype="float32")


_register_f32()


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


def device_ms(fn, names, per_call: int = 1, iters: int = 200,
              between=None) -> tuple:
    """Device milliseconds per call of ``fn`` and the profiler sessions
    it took: torch.profiler's self device time of the kernels whose name
    holds one of ``names``, summed over ``iters`` calls, where each call
    launches ``per_call`` of them.  ``between`` runs before each call (an
    L2 flush; ``names`` must not match its kernels).  A session that sees
    more launches than ``per_call * iters`` fails the run (``names``
    matched another kernel); one that sees fewer (seen now and then on
    the card's machine: a session loses device events, cause not found)
    is run again, up to five sessions in all.  If every session lost
    some, the time is the mean of the launches seen times ``per_call``
    (from the session that saw most), and the print says so; the run
    fails if no session sees one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    want = per_call * iters
    best = (0, 0.0)
    for attempt in range(1, 6):
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
        check(launched <= want, f"torch.profiler saw {launched} launches "
              f"of {names} in {iters} calls of {per_call}")
        if launched == want and us > 0:
            return us * 1e-3 / iters, attempt
        print(f"torch.profiler session {attempt} saw {launched} of {want} "
              f"launches of {names}", flush=True)
        if launched > best[0] and us > 0:
            best = (launched, us)
    check(best[0] > 0,
          f"torch.profiler saw no device time of {names} in 5 sessions")
    print(f"torch.profiler: every session lost launches of {names}; the "
          f"time is the mean of {best[0]} launches seen", flush=True)
    return best[1] * 1e-3 / best[0] * per_call, attempt


def bound(nbytes: float, nops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_serve_phase(dev, card: str) -> None:
    """Phase 17, LM serving on the card; a failed check exits.

    (a) The ten reduced configs in float32 (TF32 off since phase 1),
    weights from a seeded CPU generator copied to the card: the port's
    teacher-forced decode against its own forward at B = 2, S = 40 within
    2e-3 of each position's largest |logit| (the reference's contract;
    MoE at capacity_factor 16, so that the forward drops nothing); int8
    KV caches (qwen3-0.6b, zamba2-1.2b, S = 32) within 5e-2; and the
    card's forward and decode logits against the port's on the CPU, same
    weights, within LM_CARD_RTOL.
    (b) gemma3-1b at its published width in bf16 through
    ``launch.serve.main`` (weights from a seeded CUDA generator): batch
    8, prompt 512, gen 64, so that every local layer's 512-entry ring
    wraps; the decode path's logits of all 576 positions against
    ``make_prefill_step``'s over the same tokens within LM_BF16_RTOL;
    then one decode step profiled and timed.  The LM path launches none
    of the three kernels: the counts are set to 0 before each part and
    must read 0 after it.
    """
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves

    def rel_err(got, want) -> float:
        """Largest error of any position relative to that position's
        largest |logit| of ``want``; (..., V) tensors, compared in f32."""
        got, want = got.float(), want.float()
        scale = want.abs().amax(dim=-1) + 1e-6
        return float(((got - want).abs().amax(dim=-1) / scale).max())

    def lm_run(model, cfg, tok, frames, device, S):
        """Forward logits (B, S, V) and teacher-forced decode logits."""
        tok_d = torch.as_tensor(tok, device=device)
        fr = None if frames is None else torch.as_tensor(frames,
                                                         device=device)
        with torch.no_grad():
            fwd, _ = tfm.forward(model, cfg, tok_d, frames=fr)
            cache = tfm.init_cache(cfg, tok.shape[0], max_seq=S,
                                   device=device)
            if fr is not None:
                enc_out, _ = tfm.encode(model, cfg, fr)
                tfm.build_cross_cache(model, cfg, enc_out, cache)
            dec = []
            for i in range(S):
                lg, cache = tfm.decode_step(
                    model, cfg, cache, tok_d[:, i],
                    torch.full((tok.shape[0],), i, device=device))
                dec.append(lg)
        return fwd.cpu(), torch.stack(dec, dim=1).cpu()

    ops.reset_launch_counts()
    t17 = time.perf_counter()
    worst17 = {"decode vs forward": 0.0, "card vs cpu": 0.0, "int8": 0.0}
    for arch in sorted(ARCHS):
        for quant in (("", "int8") if arch in ("qwen3-0.6b", "zamba2-1.2b")
                      else ("",)):
            cfg = reduced(get_config(arch))
            if cfg.n_experts:
                cfg = dataclasses.replace(cfg, capacity_factor=16.0)
            if quant:
                cfg = dataclasses.replace(cfg, kv_cache_dtype=quant)
            S = 32 if quant else 40
            rng17 = np.random.default_rng(0)
            tok = rng17.integers(0, cfg.vocab_size, (2, S))
            frames = (rng17.normal(size=(2, cfg.n_frames, cfg.d_model))
                      .astype(np.float32) if cfg.family == "encdec" else None)
            params = tfm.init_params(cfg, seed=0, device="cpu")
            cpu_model = tfm.LM(cfg, params)
            card_model = tfm.LM(cfg, params).to(dev)
            fwd, dec = lm_run(card_model, cfg, tok, frames, dev, S)
            at = f"LM {arch}{' int8 kv' if quant else ''}"
            e_dec = rel_err(dec, fwd)
            check(torch.isfinite(dec).all() and torch.isfinite(fwd).all(),
                  f"{at}: logits not finite on the card")
            if quant:
                check(e_dec < 5e-2, f"{at}: decode vs forward {e_dec:.3e}")
                worst17["int8"] = max(worst17["int8"], e_dec)
                print(f"{at}: decode vs forward {e_dec:.3e} (< 5e-2) on "
                      f"the card", flush=True)
                continue
            check(e_dec < 2e-3, f"{at}: decode vs forward {e_dec:.3e}")
            cfwd, cdec = lm_run(cpu_model, cfg, tok, frames, "cpu", S)
            e_cf, e_cd = rel_err(fwd, cfwd), rel_err(dec, cdec)
            check(e_cf <= LM_CARD_RTOL and e_cd <= LM_CARD_RTOL,
                  f"{at}: card vs cpu forward {e_cf:.3e}, decode {e_cd:.3e}")
            worst17["decode vs forward"] = max(worst17["decode vs forward"],
                                               e_dec)
            worst17["card vs cpu"] = max(worst17["card vs cpu"], e_cf, e_cd)
            print(f"{at}: decode vs forward {e_dec:.3e} (< 2e-3), card vs "
                  f"cpu forward {e_cf:.3e} decode {e_cd:.3e} (<= "
                  f"{LM_CARD_RTOL:g}) {card}", flush=True)
    counts17a = ops.launch_counts()
    check(not any(counts17a.values()),
          f"the reduced LM runs launched {counts17a}")
    print(f"LM reduced: ten configs held in {time.perf_counter() - t17:.2f} "
          f"s; worst {worst17} {card}", flush=True)

    B17, P17, G17 = 8, 512, 64
    rec = {"logits": True}
    ops.reset_launch_counts()
    check(lm_serve.main(["--arch", "gemma3-1b", "--batch", str(B17),
                         "--prompt-len", str(P17), "--gen", str(G17),
                         "--seed", "0"], record=rec) == 0,
          "launch.serve.main failed")
    counts17 = ops.launch_counts()
    check(not any(counts17.values()), f"LM serving launched {counts17}")
    cfg, model, cache = rec["cfg"], rec["model"], rec["cache"]
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.window_size, cfg.dtype)
          == (26, 1152, 4, 1, 256, 6912, 262144, 512, "bfloat16")
          and cfg.param_count() == 999_751_680,
          f"gemma3-1b is not at its published width: {cfg}")
    n_params = sum(a.numel() for a in tree_leaves(model))
    rings = [c["k"].shape[2] for seg in cache["segments"]
             for c in seg.values()]
    check(min(rings) == cfg.window_size < P17 + G17,
          f"local rings of {min(rings)} entries do not wrap")
    toks = rec["tokens"]
    check(toks.shape == (B17, P17 + G17)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.padded_vocab,
          "greedy tokens outside [0, padded_vocab)")
    keep = rec["logits"]
    check(bool(torch.equal(toks[:, P17:], keep[:, P17 - 1:-1].argmax(-1))),
          "fed tokens are not the greedy tokens of the decode logits")
    # make_prefill_step over the same tokens, run and timed by main after
    # one warm-up call (the weights' cast)
    pre, t_pre = rec["prefill_logits"], rec["t_prefill"]
    check(pre.shape == keep.shape and pre.dtype == torch.bfloat16,
          f"prefill logits {tuple(pre.shape)} {pre.dtype}")
    e_pre = max(rel_err(keep[b], pre[b]) for b in range(B17))
    check(e_pre < LM_BF16_RTOL and bool(torch.isfinite(keep).all()),
          f"gemma3-1b decode vs prefill {e_pre:.3e}")
    agree = float((pre[:, P17 - 1:-1].argmax(-1) == toks[:, P17:])
                  .float().mean())
    del pre
    rec.pop("prefill_logits")

    # one more decode step, re-fed the last token at its position (the
    # same entries are written again): its launches from the profiler,
    # its device time, and its time from CUDA events over 20 calls
    step = rec["step"]
    last = toks[:, -1].contiguous()
    pos_last = torch.full((B17,), P17 + G17 - 1, device=dev)
    one = lambda: step(model, cache, last, pos_last)    # noqa: E731
    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
    step_launches = sum(e.count for e in dev_events)
    step_dev_ms = sum(_device_us(e) for e in dev_events) * 1e-3
    check(step_launches > 0, "the profiler saw no device event of a step")
    step_ms = time_ms(one, iters=20, warmup=2)
    mem = rec["ranks"][0]
    weights_cast = mem["cast_bytes"]
    kv_bytes = mem["cache_bytes"]
    # bytes: every bf16 weight read once (the tied embedding serves the
    # unembedding), and the whole KV cache; operations: 2 per weight and
    # token at the bf16 tensor-core rate, far below the bytes' time
    b_w = weights_cast / HBM_BYTES_PER_S * 1e3
    b_all = (weights_cast + kv_bytes) / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * n_params * B17 / BF16_OPS_PER_S * 1e3
    ms_step = rec["t_gen"] / G17 * 1e3
    # what the process held before main (earlier phases) is not the run's
    above = (mem["peak_bytes"] - mem["held_bytes"]
             - mem["params_at_rest_bytes"] - weights_cast)
    print(f"LM gemma3-1b (published width, {n_params} parameters, "
          f"param_count() {cfg.param_count()}), bf16, batch {B17}, prompt "
          f"{P17} + gen {G17}, rings of {min(rings)} wrapped: decode vs "
          f"prefill logits {e_pre:.3e} (< {LM_BF16_RTOL:g}) over "
          f"{P17 + G17} positions; prefill's greedy tokens agree with the "
          f"decode path's at {agree:.4f} of positions {card}", flush=True)
    print(f"LM gemma3-1b serve: prompt through the decode path "
          f"{B17 * P17 / rec['t_prompt']:.1f} tokens/s "
          f"({rec['t_prompt']:.3f} s), generate "
          f"{B17 * G17 / rec['t_gen']:.1f} tokens/s ({rec['t_gen']:.3f} s, "
          f"{ms_step:.3f} ms per decode step with its argmax and host "
          f"read); make_prefill_step over {P17 + G17} tokens "
          f"{B17 * (P17 + G17) / t_pre:.1f} tokens/s "
          f"({t_pre:.3f} s) {card}", flush=True)
    print(f"LM gemma3-1b decode step: {step_ms:.3f} ms (CUDA events over "
          f"20 calls), device busy {step_dev_ms:.3f} ms "
          f"({100 * (1 - step_dev_ms / step_ms):.1f}% idle), "
          f"{step_launches} launches per step (torch.profiler); bound "
          f"{b_w:.3f} ms for {weights_cast / 1e9:.3f} GB of bf16 weights "
          f"over 3.35 TB/s, {b_all:.3f} ms with the {kv_bytes / 1e9:.3f} GB "
          f"KV cache ({b_ops:.4f} ms of bf16 operations); peak device "
          f"memory until the last decode step "
          f"{mem['peak_bytes'] / 2**30:.2f} GiB, of which "
          f"{mem['held_bytes'] / 2**30:.2f} GiB held before the run; "
          f"{above / 2**30:.2f} GiB above that, the f32 masters "
          f"({mem['params_at_rest_bytes'] / 1e9:.3f} GB) and bf16 weights, of "
          f"which the KV cache {kv_bytes / 2**30:.3f} GiB and the kept "
          f"logits {keep.numel() * keep.element_size() / 2**30:.2f} GiB; "
          f"kernel launches {counts17} {card}", flush=True)
    del rec, keep, model, cache, step, one
    torch.cuda.empty_cache()


def lm_train_phase(dev, card: str) -> tuple:
    """Phase 18, LM training on the card; a failed check exits.  Returns
    the three kernels' launch counts over its parts (all 0: training
    runs none of them) and (b)'s first step and tokens/s, which phase 19
    holds its D-card run to.

    (a) The ten reduced configs in float32 (TF32 off since phase 1), the
    state from a seeded CPU generator copied to the card, B = 2, S = 40,
    ``loss_chunk`` 32: the card's ``make_grad_step`` (the train step's
    forward and backward) and ``make_train_step`` against the same on the
    CPU — loss, ce, aux, grad norm and every gradient leaf within
    TRAIN_CARD_RTOL of the leaf's largest |value| (a leaf whose CPU
    gradient is below 1e-6 of the tree's largest is zero in exact
    arithmetic, the enc-dec cross-attention key bias: both below that);
    the reference's contract that ``accum`` 2 lands within 5e-3 of
    ``accum`` 1; and the reduced qwen3 stream of
    ``test_loss_decreases_on_learnable_data`` (60 steps, cyclic) ending
    below half its first CE.
    (b) qwen2-0.5b at its published width (arXiv:2407.10671) through
    ``launch.train.main`` on cuda:0 alone (one process, no process
    group, on any host): bf16 compute, float32 masters and moments,
    ``--batch 8 --seq 4096 --accum 2`` (32768 tokens a step, two
    microbatches of 4 × 4096), the cyclic pattern, TRAIN_WARM warm-up
    and TRAIN_TIMED timed steps, no checkpoints.  Gates: the first
    step's bf16 loss within TRAIN_BF16_RTOL and its gradient norm (before
    the clip) within TRAIN_BF16_GNORM_RTOL (relative) of a float32 step's
    on the same weights (the same seed on the card) and batch, microbatch
    for microbatch.  The reduced configs' bf16-vs-f32 loss gap on the CPU
    (B = 4, S = 128, ``tests/test_torch_train_models.py::
    test_bf16_loss_gap``) is at most 5e-5 for the dense ones and 1.07e-3
    in all (olmoe: bf16 moves tokens between experts); 5e-3 is five times
    the largest, for a model with six times the reduced one's layers.
    Their gradient-norm gap (accum 2, ``test_bf16_grad_norm_gap``) is
    4.3e-4 to 1.28e-3 for the dense, SSM and hybrid configs and up to
    7.8e-3 for the MoE ones; 2e-2 is about fifteen times the dense
    largest.  At initialisation the loss sits at ln V and bf16 barely
    moves it (1.6e-7 on the H100); the gradients carry bf16's rounding
    through every layer.  Then one more step profiled
    (launches, device time), the step time against
    ``costmodel.step_cost``'s bound and 6·N·tokens, and the peak memory.
    (c) The restart contract of ``tests/test_train.py::
    test_failure_restart_reproduces_run`` on cuda:0: three
    ``launch.train`` processes (qwen3-0.6b reduced, 14 steps, batch 2,
    seq 32, a checkpoint every 5): uninterrupted, ``--fail-at-step 9``
    (exit 42), ``--resume``; the final losses within rtol 1e-4.
    """
    import dataclasses
    import os
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch import costmodel
    from repro_torch.launch import train as lm_train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import OptConfig, global_norm
    from repro_torch.train import steps
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    def on(tree, device):
        return tree_map(lambda a: a.to(device, copy=True), tree)

    def rel(got, want) -> float:
        return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # ------------------------------------------------ (a) reduced configs
    ops.reset_launch_counts()
    t18 = time.perf_counter()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    worst = {"loss": 0.0, "grad": 0.0, "step": 0.0}
    for arch in sorted(ARCHS):
        cfg = reduced(get_config(arch))
        rng18 = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng18.integers(0, cfg.vocab_size,
                                                   (2, 40)))
                 for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            batch["frames"] = torch.as_tensor(rng18.normal(
                size=(2, cfg.n_frames, cfg.d_model)), dtype=torch.float32)
        host = steps.init_train_state(cfg, opt, seed=0, device="cpu")
        card_state = on(host, dev)
        card_batch = on(batch, dev)
        grad_step = steps.make_grad_step(cfg, opt, loss_chunk=32)
        lc, mc, gc = grad_step(card_state["params"], card_batch)
        lh, mh, gh = grad_step(host["params"], batch)
        at = f"LM train {arch}"
        e_loss = max(rel(lc, lh), rel(mc["ce"], mh["ce"]),
                     abs(float(mc["aux"]) - float(mh["aux"]))
                     / max(abs(float(mh["aux"])), 1.0))
        check(e_loss <= TRAIN_CARD_RTOL,
              f"{at}: card vs cpu loss/ce/aux {e_loss:.3e}")
        want = dict(tree_items(gh))
        top = max(float(g.abs().max()) for g in want.values())
        e_grad = 0.0
        for path, g in tree_items(gc):
            w = want[path]
            g = g.cpu()
            scale = float(w.abs().max())
            if scale < 1e-6 * top:
                check(float(g.abs().max()) < 1e-6 * top
                      and "cross" in path and "bk" in path,
                      f"{at}: gradient {path} is not a zero leaf")
                continue
            e = float((g - w).abs().max()) / scale
            check(e <= TRAIN_CARD_RTOL,
                  f"{at}: gradient {path} card vs cpu {e:.3e}")
            e_grad = max(e_grad, e)
        del gc, gh
        step = steps.make_train_step(cfg, opt, loss_chunk=32)
        _, met_c = step(card_state, card_batch)
        _, met_h = step(host, batch)
        e_step = max(rel(met_c[k], met_h[k])
                     for k in ("loss", "ce", "grad_norm"))
        check(e_step <= TRAIN_CARD_RTOL,
              f"{at}: train step card vs cpu {e_step:.3e}")
        for k, e in (("loss", e_loss), ("grad", e_grad), ("step", e_step)):
            worst[k] = max(worst[k], e)
        print(f"{at}: card vs cpu loss/ce/aux {e_loss:.3e}, gradient "
              f"leaves {e_grad:.3e}, train step loss/ce/grad norm "
              f"{e_step:.3e} (<= {TRAIN_CARD_RTOL:g}) {card}", flush=True)

    # the reference's accumulation contract and convergence stream, on
    # the mini config of tests/test_train.py
    mini = dataclasses.replace(
        reduced(get_config("qwen3-0.6b")), n_layers=2, d_model=64,
        d_ff=128, n_heads=2, n_kv_heads=1, head_dim=32, vocab_size=64,
        vocab_pad_multiple=64)
    opt_acc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dacc = DataConfig(vocab_size=64, seq_len=32, global_batch=8)
    b_acc = {k: torch.as_tensor(v, device=dev)
             for k, v in batch_at(dacc, 0).items()}
    outs = []
    for accum in (1, 2):
        st = steps.init_train_state(mini, opt_acc, seed=0, device=dev)
        st, _ = steps.make_train_step(mini, opt_acc, accum=accum,
                                      loss_chunk=256)(st, b_acc)
        outs.append(tree_leaves(st["params"]))
    d_acc = max(float((a - b).abs().max()) for a, b in zip(*outs))
    check(d_acc < 5e-3, f"accum 2 vs 1: {d_acc:.3e}")
    opt_mini = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    st = steps.init_train_state(mini, opt_mini, seed=0, device=dev)
    step = steps.make_train_step(mini, opt_mini, loss_chunk=256)
    dmini = DataConfig(vocab_size=64, seq_len=64, global_batch=8,
                       pattern="cyclic")
    ces = []
    for i in range(60):
        st, m = step(st, {k: torch.as_tensor(v, device=dev)
                          for k, v in batch_at(dmini, i).items()})
        ces.append(float(m["ce"]))
    check(ces[0] > 3.0 and ces[-1] < 0.5 * ces[0],
          f"the mini stream's CE went {ces[0]:.4f} -> {ces[-1]:.4f}")
    counts_a = ops.launch_counts()
    check(not any(counts_a.values()),
          f"the reduced train steps launched {counts_a}")
    add(counts_a)
    print(f"LM train reduced: ten configs held in "
          f"{time.perf_counter() - t18:.2f} s, worst {worst}; accum 2 vs 1 "
          f"{d_acc:.3e} (< 5e-3); mini cyclic stream CE {ces[0]:.4f} -> "
          f"{ces[-1]:.4f} in 60 steps {card}", flush=True)
    del st, step, outs
    t_a = time.perf_counter() - t18

    # ------------------------------------- (b) qwen2-0.5b, published width
    B18, S18, A18 = TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM
    n_steps = TRAIN_WARM + TRAIN_TIMED
    rec = {}
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    check(lm_train.main(["--arch", TRAIN_ARCH, "--batch", str(B18),
                         "--seq", str(S18), "--accum", str(A18),
                         "--steps", str(n_steps), "--data-pattern",
                         "cyclic", "--log-every", "1", "--seed", "0",
                         "--device", str(dev)],
                        record=rec) == 0, "launch.train.main failed")
    t_run = time.perf_counter() - t_run
    counts_b = ops.launch_counts()
    check(not any(counts_b.values()), f"LM training launched {counts_b}")
    add(counts_b)
    cfg = rec["cfg"]
    check((cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias,
           cfg.tie_embeddings, cfg.dtype)
          == ("qwen2-0.5b", 24, 896, 14, 2, 64, 4864, 151936, True, True,
              "bfloat16"),
          f"qwen2-0.5b is not at its published width: {cfg}")
    hist = rec["history"]
    check(len(hist) == n_steps and all(np.isfinite(h["loss"])
                                       and np.isfinite(h["grad_norm"])
                                       for h in hist),
          f"non-finite train metrics {hist}")
    n_params = sum(p.numel() for p in tree_leaves(rec["state"]["params"]))
    timed = rec["times"][TRAIN_WARM:]
    s_step = statistics.median(timed)
    tokens = B18 * S18
    cost = costmodel.step_cost(cfg, ShapeSpec("train", S18, B18, "train"),
                               n_chips=1, tp=1)
    t_ops = cost.flops / costmodel.PEAK_FLOPS
    t_bytes = cost.hbm_bytes / costmodel.HBM_BW
    bound_s, bound_by = max((t_ops, "FLOPs"), (t_bytes, "bytes"))
    mfu = 6 * n_params * tokens / (s_step * costmodel.PEAK_FLOPS)

    # one more step, profiled: launches and device time
    state, step_fn = rec["state"], rec["step_fn"]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in batch_at(rec["data_cfg"], n_steps).items()}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        t_read = time.perf_counter()
        t_prof = t_read - t0
    counts_p = ops.launch_counts()
    check(not any(counts_p.values()), f"the profiled step launched "
          f"{counts_p}")
    add(counts_p)
    # the device events summed from the profiler's raw records: building
    # its FunctionEvents (events(), key_averages()) for a few hundred
    # thousand launches takes minutes
    by_kernel = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = by_kernel.get(e.name(), (0, 0))
            by_kernel[e.name()] = (n + 1, ns + e.duration_ns())
    launches = sum(n for n, _ in by_kernel.values())
    busy_s = sum(ns for _, ns in by_kernel.values()) * 1e-9
    t_read = time.perf_counter() - t_read
    check(launches > 0 and busy_s > 0,
          "the profiler saw no device event of a train step")
    top5 = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:5]
    state_bytes, held = rec["state_bytes"], rec["held_bytes"]
    above = rec["peak_bytes"] - held - state_bytes
    del state, step_fn, rec, m, prof, by_kernel
    torch.cuda.empty_cache()

    # the gates: the first step's bf16 loss and gradient norm against a
    # float32 step of the same weights (same seed on the card) and batch,
    # microbatch for microbatch as the trainer takes them
    t_gate = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    first = {k: torch.as_tensor(v, device=dev) for k, v in batch_at(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S18, global_batch=B18,
                   seed=0, pattern="cyclic"), 0).items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss32, _, grads32 = steps.make_grad_step(
        cfg32, OptConfig(), accum=A18, loss_chunk=min(2048, tokens))(
            params, first)
    loss32, gnorm32 = float(loss32), float(global_norm(grads32))
    del params, grads32
    torch.cuda.empty_cache()
    t_gate = time.perf_counter() - t_gate
    e_gate = rel(hist[0]["loss"], loss32)
    check(e_gate <= TRAIN_BF16_RTOL,
          f"{TRAIN_ARCH} first-step bf16 loss {hist[0]['loss']:.6f} vs "
          f"float32 {loss32:.6f}: {e_gate:.3e}")
    e_gnorm = rel(hist[0]["grad_norm"], gnorm32)
    check(e_gnorm <= TRAIN_BF16_GNORM_RTOL,
          f"{TRAIN_ARCH} first-step bf16 gradient norm "
          f"{hist[0]['grad_norm']:.6f} vs float32 {gnorm32:.6f}: "
          f"{e_gnorm:.3e}")
    print(f"LM train {TRAIN_ARCH} (published width, {n_params} "
          f"parameters, param_count() {cfg.param_count()}), bf16 compute, "
          f"f32 masters: batch {B18} x seq {S18}, accum {A18}; first-step "
          f"loss {hist[0]['loss']:.6f} vs float32 {loss32:.6f} on the same "
          f"weights and batch: {e_gate:.3e} (<= {TRAIN_BF16_RTOL:g}); "
          f"gradient norm {hist[0]['grad_norm']:.6f} vs float32 "
          f"{gnorm32:.6f}: {e_gnorm:.3e} (<= {TRAIN_BF16_GNORM_RTOL:g}); "
          f"the float32 step in {t_gate:.2f} s; losses "
          f"{[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 3) for h in hist]} {card}", flush=True)
    print(f"LM train {TRAIN_ARCH} step: {s_step:.4f} s per step (median of "
          f"{TRAIN_TIMED} after {TRAIN_WARM} warm-up: "
          f"{', '.join(f'{t:.4f}' for t in timed)}; host clock ending in "
          f"the loss read), {tokens / s_step:,.0f} tokens/s; cost model "
          f"{cost.flops / 1e12:.2f} TFLOP and {cost.hbm_bytes / 1e9:.2f} GB "
          f"per step: bound {bound_s:.4f} s by {bound_by} ({t_ops:.4f} s "
          f"at 989 TFLOP/s, {t_bytes:.4f} s at 3.35 TB/s), "
          f"{100 * bound_s / s_step:.1f}% of the step; MFU "
          f"{100 * mfu:.2f}% (6·N·tokens = "
          f"{6 * n_params * tokens / 1e12:.2f} TFLOP); run of {n_steps} "
          f"steps {t_run:.2f} s {card}", flush=True)
    print(f"LM train {TRAIN_ARCH} profiled step: {launches} launches, "
          f"device busy {busy_s:.4f} s of the {t_prof:.4f} s profiled step "
          f"({100 * busy_s / s_step:.1f}% of the median step; the trace "
          f"closed and read in {t_read:.2f} s); top kernels "
          f"(name, launches, ms) "
          f"{[(k[:60], n, round(ns * 1e-6, 1)) for k, (n, ns) in top5]}; "
          f"peak device memory above what was held before the run "
          f"{(above + state_bytes) / 2**30:.2f} GiB: masters + moments "
          f"{state_bytes / 2**30:.2f} GiB, the step {above / 2**30:.2f} GiB "
          f"above them; kernel launches {counts_b} {card}", flush=True)

    t_b = time.perf_counter() - t18 - t_a

    # ------------------------------------------ (c) the restart contract
    ops.reset_launch_counts()
    t_c = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-0.6b", "--reduced", "--steps", "14", "--batch", "2",
            "--seq", "32", "--ckpt-every", "5", "--log-every", "1",
            "--device", str(dev)]

    def final_loss(out: str) -> float:
        lines = [ln for ln in out.splitlines() if "step    13" in ln]
        check(bool(lines), f"no step 13 in {out}")
        return float(lines[-1].split("loss")[1].split()[0])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt-") as tmp:
        ck1, ck2 = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        runs = [subprocess.Popen(base + ["--ckpt-dir", d] + extra, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for d, extra in ((ck1, []), (ck2, ["--fail-at-step", "9"]))]
        (o1, e1), (o2, e2) = [r.communicate(timeout=300) for r in runs]
        check(runs[0].returncode == 0, f"uninterrupted run: {o1}{e1}")
        check(runs[1].returncode == 42 and "SIMULATED NODE FAILURE" in o2,
              f"--fail-at-step 9 exited {runs[1].returncode}: {o2}{e2}")
        r3 = subprocess.run(base + ["--ckpt-dir", ck2, "--resume"],
                            env=env, capture_output=True, text=True,
                            timeout=300)
        check(r3.returncode == 0 and "resumed from step 5" in r3.stdout,
              f"resumed run: {r3.stdout}{r3.stderr}")
    l1, l3 = final_loss(o1), final_loss(r3.stdout)
    check(abs(l1 - l3) <= 1e-4 * abs(l1),
          f"resumed final loss {l3} != uninterrupted {l1}")
    counts_c = ops.launch_counts()
    add(counts_c)
    print(f"LM train restart: qwen3-0.6b reduced, 14 steps, failure at "
          f"step 9 (exit 42), resumed from step 5: final loss {l3:.6f} vs "
          f"uninterrupted {l1:.6f} ({abs(l1 - l3) / abs(l1):.3e}, rtol "
          f"1e-4) in {time.perf_counter() - t_c:.2f} s; the processes "
          f"count their own launches (none of the three kernels runs in "
          f"training) {card}", flush=True)
    print(f"LM train: phase 18 in {time.perf_counter() - t18:.2f} s ((a) "
          f"{t_a:.2f} s, (b) {t_b:.2f} s, (c) "
          f"{time.perf_counter() - t_c:.2f} s) {card}", flush=True)
    return total, hist[0], tokens / s_step


def lm_dp_phase(card: str, first18: dict, tok_s18: float) -> dict:
    """Phase 19, LM training data-parallel over the D visible cards
    through ``launch.train.main(["--data-mesh", D])``: D worker processes,
    rank r on cuda:r under NCCL, each holding its block of the masters
    and moments (``train.dp``); on a one-card host D = 1 goes through the
    same process group.  A failed check exits.  The workers run the step
    that phase 18 ran in this process, which launches none of the three
    kernels: each worker counts its launches from 0 and hands them back
    in its rank's record; their sums over both runs are checked to be 0
    and returned.

    (a) Parity: qwen2-0.5b at its published width, phase 18 (b)'s
    arguments (bf16, ``--batch 8 --seq 4096 --accum 2``, seed 0, cyclic
    data), one step at ``--data-mesh D``: its loss and gradient norm
    within TRAIN_DP_RTOL (relative) of phase 18's one-card first step on
    the same weights and batch (bitwise expected at D = 1).
    (b) Weak scaling: ``--batch 8·D``, so that each card runs phase 18's
    rows, TRAIN_WARM warm-up and TRAIN_TIMED timed steps: s per step
    (host clock on rank 0 ending in the loss read), tokens/s against D
    times phase 18's, the share of the step that
    ``costmodel.roofline_terms(n_chips=D, tp=1)``'s bound is, each card's
    masters + moments at rest, its peak while the state was built and
    its peak above them in the steps, and the step's collective time
    (CUDA events around each gather, reduce-scatter and all-reduce on
    every rank): ``collective_s`` sums each collective's least time over
    the ranks (the last rank to arrive waits for no one), and
    ``collective_rank0_s`` rank 0's own, its waits for slower ranks
    included.
    """
    import torch

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import costmodel
    from repro_torch.launch import train as lm_train

    def rel(got, want) -> float:
        return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)

    d = torch.cuda.device_count()
    total = {}
    t19 = time.perf_counter()
    base = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--accum",
            str(TRAIN_ACCUM), "--data-pattern", "cyclic", "--log-every",
            "1", "--seed", "0", "--data-mesh", str(d)]

    def run(batch: int, steps: int) -> dict:
        rec = {}
        check(lm_train.main(base + ["--batch", str(batch), "--steps",
                                    str(steps)], record=rec) == 0,
              f"launch.train --data-mesh {d} failed")
        check(rec["data_mesh"] == d and len(rec["ranks"]) == d,
              f"data-parallel record: D {rec.get('data_mesh')}, "
              f"{len(rec.get('ranks', []))} ranks")
        for r in rec["ranks"]:
            check(set(r["launches"]) == set(ops.launch_counts())
                  and not any(r["launches"].values()),
                  f"a data-parallel worker launched {r['launches']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        check(len(rec["history"]) == steps
              and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                      for h in rec["history"]),
              f"data-parallel record: D {rec.get('data_mesh')}, history "
              f"{rec.get('history')}")
        return rec

    # ------------------------------------------------------- (a) parity
    t_a = time.perf_counter()
    h = run(TRAIN_BATCH, 1)["history"][0]
    t_a = time.perf_counter() - t_a
    e_loss = rel(h["loss"], first18["loss"])
    e_gnorm = rel(h["grad_norm"], first18["grad_norm"])
    check(e_loss <= TRAIN_DP_RTOL and e_gnorm <= TRAIN_DP_RTOL,
          f"D = {d} first step: loss {h['loss']!r} vs one card "
          f"{first18['loss']!r} ({e_loss:.3e}), gradient norm "
          f"{h['grad_norm']!r} vs {first18['grad_norm']!r} ({e_gnorm:.3e})")
    bitwise = (h["loss"] == first18["loss"]
               and h["grad_norm"] == first18["grad_norm"])
    print(f"LM data parallel {TRAIN_ARCH} D = {d} (NCCL, {d} worker "
          f"process(es)), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, accum "
          f"{TRAIN_ACCUM}: first-step loss {h['loss']!r} vs phase 18's one "
          f"card {first18['loss']!r} ({e_loss:.3e}), gradient norm "
          f"{h['grad_norm']!r} vs {first18['grad_norm']!r} ({e_gnorm:.3e}) "
          f"(<= {TRAIN_DP_RTOL:g}; bitwise: {bitwise}); run {t_a:.2f} s "
          f"{card}", flush=True)

    # ------------------------------------------------- (b) weak scaling
    B19 = TRAIN_BATCH * d
    t_b = time.perf_counter()
    rec = run(B19, TRAIN_WARM + TRAIN_TIMED)
    t_b = time.perf_counter() - t_b
    timed = rec["times"][TRAIN_WARM:]
    s_step = statistics.median(timed)
    tokens = B19 * TRAIN_SEQ
    tok_s = tokens / s_step
    rt = costmodel.roofline_terms(
        rec["cfg"], ShapeSpec("train", TRAIN_SEQ, B19, "train"),
        n_chips=d, tp=1)
    coll = [(hh["collective_s"], hh["collective_rank0_s"])
            for hh in rec["history"][TRAIN_WARM:]]
    per_card = [(r["state_bytes"] / 2**30,
                 (r["init_peak_bytes"] - r["held_bytes"]) / 2**30,
                 (r["peak_bytes"] - r["held_bytes"] - r["state_bytes"])
                 / 2**30) for r in rec["ranks"]]
    print(f"LM data parallel {TRAIN_ARCH} weak scaling D = {d}: batch "
          f"{B19} x seq {TRAIN_SEQ}, accum {TRAIN_ACCUM}; {s_step:.4f} s "
          f"per step (median of {TRAIN_TIMED} after {TRAIN_WARM} warm-up: "
          f"{', '.join(f'{t:.4f}' for t in timed)}; rank 0's host clock "
          f"ending in the loss read), {tok_s:,.0f} tokens/s, "
          f"{tok_s / (d * tok_s18):.3f} of D x phase 18's "
          f"{tok_s18:,.0f}; roofline_terms(n_chips={d}, tp=1) bound "
          f"{rt['step_time_lb']:.4f} s by {rt['bottleneck']} (compute "
          f"{rt['t_compute']:.4f} s, memory {rt['t_memory']:.4f} s, "
          f"collective {rt['t_collective']:.4f} s), "
          f"{100 * rt['step_time_lb'] / s_step:.1f}% of the step; losses "
          f"{[round(hh['loss'], 4) for hh in rec['history']]}; collectives "
          f"of the timed steps (CUDA events on every rank), least over the "
          f"ranks / rank 0's with its waits: "
          f"{', '.join(f'{a:.6f} / {b:.6f}' for a, b in coll)} s; per card "
          f"masters + moments / peak while built / peak above them in the "
          f"steps (GiB) "
          f"{[tuple(round(x, 3) for x in c) for c in per_card]}; run "
          f"{t_b:.2f} s {card}", flush=True)
    print(f"LM data parallel: phase 19 in {time.perf_counter() - t19:.2f} s "
          f"((a) {t_a:.2f} s, (b) {t_b:.2f} s); kernel launches of the "
          f"{d} worker(s), summed over both runs {total} {card}",
          flush=True)
    return total


def lm_tp_phase(card: str) -> dict:
    """Phase 20, LM training with tensor parallelism over 'model': qwen3-
    0.6b at its published width through ``launch.train.main`` on the
    ('data', 'model') = (D, T) meshes of the N visible cards (NCCL worker
    processes, rank r on cuda:r, each holding its block of the masters
    and moments on both axes; ``train.tp``).  A failed check exits.  The
    workers launch none of the three kernels: each counts from 0 and
    hands its counts back; their sums are checked to be 0 and returned.

    Arguments as phase 18 (b)'s, for TP_ARCH: bf16 compute, f32 masters
    and moments, seed 0, cyclic data, ``--batch 8 --seq 4096 --accum 2``
    (two microbatches of 4 × 4096), remat ``"full"``, loss chunks of
    2048, TRAIN_WARM warm-up and TRAIN_TIMED timed steps.  Cut:
    ``train_4k``'s 256 sequences to 8.

    (a) One card in this process (``--device cuda:0``, no process
        group): the baseline of s per step and tokens/s, and the first
        step's loss and gradient norm.
    (b) The meshes: (1, 1) through the spawned-rank path on a one-card
        host (``--data-mesh 1``), whose first step must equal (a)'s
        bitwise; on N cards (1, N), and (2, N // 2) when N >= 4, whose
        first step must be within TRAIN_TP_RTOL of (a)'s.  Each prints
        s per step and tokens/s against (a)'s, the share of
        ``costmodel.roofline_terms(n_chips=D·T, tp=T)``'s bound, each
        card's masters + moments, its peak while the state was built and
        its peak above the state in the steps, the 'data' and 'model'
        collective seconds of each timed step (least over the ranks /
        rank 0's), the gathered leaves and the workers' launches.
    (c) The same meshes for TP_ARCH in float32, batch 4 × 1024 (one
        step): the first step within TRAIN_TP_F32_RTOL of one card's
        (bitwise at (1, 1)), the check of the split math that bf16's
        rounding would hide.
    """
    import torch

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import costmodel
    from repro_torch.launch import train as lm_train

    def rel(got, want) -> float:
        return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)

    n = torch.cuda.device_count()
    total = {}
    t20 = time.perf_counter()
    steps_n = TRAIN_WARM + TRAIN_TIMED
    base = ["--arch", TP_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--accum", str(TRAIN_ACCUM), "--steps",
            str(steps_n), "--data-pattern", "cyclic", "--log-every", "1",
            "--seed", "0"]
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def run(extra) -> dict:
        rec = {}
        check(lm_train.main(base + extra, record=rec) == 0,
              f"launch.train {' '.join(extra)} failed")
        for r in rec["ranks"]:
            check(set(r["launches"]) == set(ops.launch_counts())
                  and not any(r["launches"].values()),
                  f"a tensor-parallel rank launched {r['launches']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        check(len(rec["history"]) == steps_n
              and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                      for h in rec["history"]),
              f"{extra}: history {rec.get('history')}")
        return rec

    # ------------------------------------------------- (a) one card
    ops.reset_launch_counts()
    t_a = time.perf_counter()
    one = run(["--device", "cuda:0"])
    counts_a = ops.launch_counts()
    check(not any(counts_a.values()), f"LM training launched {counts_a}")
    t_a = time.perf_counter() - t_a
    cfg = one["cfg"]
    check((cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.qk_norm,
           cfg.tie_embeddings, cfg.dtype)
          == ("qwen3-0.6b", 28, 1024, 16, 8, 128, 3072, 151936, True, True,
              "bfloat16"),
          f"qwen3-0.6b is not at its published width: {cfg}")
    first = one["history"][0]
    s_one = statistics.median(one["times"][TRAIN_WARM:])
    r0 = one["ranks"][0]
    print(f"LM tensor parallel {TP_ARCH} (published width, "
          f"{cfg.param_count()} parameters) one card in this process: "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, accum {TRAIN_ACCUM}; "
          f"first-step loss {first['loss']!r}, gradient norm "
          f"{first['grad_norm']!r}; {s_one:.4f} s per step (median of "
          f"{TRAIN_TIMED} after {TRAIN_WARM} warm-up: "
          f"{', '.join(f'{t:.4f}' for t in one['times'][TRAIN_WARM:])}), "
          f"{tokens / s_one:,.0f} tokens/s; masters + moments "
          f"{r0['state_bytes'] / 2**30:.3f} GiB, peak above them "
          f"{(r0['peak_bytes'] - r0['held_bytes'] - r0['state_bytes']) / 2**30:.3f}"
          f" GiB; run {t_a:.2f} s {card}", flush=True)
    del one["state"], one["step_fn"]
    torch.cuda.empty_cache()

    # ------------------------------------------------- (b) the meshes
    meshes = [(1, 1)] if n == 1 else [(1, n)] + (
        [(2, n // 2)] if n >= 4 else [])
    for d, t in meshes:
        t_b = time.perf_counter()
        rec = run(["--data-mesh", str(d)])
        t_b = time.perf_counter() - t_b
        check((rec["data_mesh"], rec["model_mesh"]) == (d, t)
              and len(rec["ranks"]) == d * t,
              f"mesh ({rec['data_mesh']}, {rec['model_mesh']}) with "
              f"{len(rec['ranks'])} ranks, not ({d}, {t})")
        h = rec["history"][0]
        e_loss = rel(h["loss"], first["loss"])
        e_gnorm = rel(h["grad_norm"], first["grad_norm"])
        if d * t == 1:
            check(h["loss"] == first["loss"]
                  and h["grad_norm"] == first["grad_norm"],
                  f"(1, 1) first step: loss {h['loss']!r} vs one card "
                  f"{first['loss']!r}, gradient norm {h['grad_norm']!r} vs "
                  f"{first['grad_norm']!r}: not bitwise")
        check(e_loss <= TRAIN_TP_RTOL and e_gnorm <= TRAIN_TP_RTOL,
              f"({d}, {t}) first step: loss {h['loss']!r} vs one card "
              f"{first['loss']!r} ({e_loss:.3e}), gradient norm "
              f"{h['grad_norm']!r} vs {first['grad_norm']!r} "
              f"({e_gnorm:.3e})")
        timed = rec["times"][TRAIN_WARM:]
        s_step = statistics.median(timed)
        rt = costmodel.roofline_terms(
            cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
            n_chips=d * t, tp=t)
        coll = [(hh["collective_s"], hh["collective_rank0_s"],
                 hh["model_collective_s"], hh["model_collective_rank0_s"])
                for hh in rec["history"][TRAIN_WARM:]]
        per_card = [(r["coord"], round(r["state_bytes"] / 2**30, 3),
                     round((r["init_peak_bytes"] - r["held_bytes"])
                           / 2**30, 3),
                     round((r["peak_bytes"] - r["held_bytes"]
                            - r["state_bytes"]) / 2**30, 3),
                     round(r["collective_s"]["data"], 4),
                     round(r["collective_s"]["model"], 4))
                    for r in rec["ranks"]]
        print(f"LM tensor parallel {TP_ARCH} mesh ({d}, {t}) (NCCL, "
              f"{d * t} worker process(es)): first-step loss {h['loss']!r} "
              f"({e_loss:.3e}), gradient norm {h['grad_norm']!r} "
              f"({e_gnorm:.3e}) against one card's (<= {TRAIN_TP_RTOL:g}"
              f"{'; bitwise' if d * t == 1 else ''}); {s_step:.4f} s per "
              f"step (median of {TRAIN_TIMED} after {TRAIN_WARM} warm-up: "
              f"{', '.join(f'{x:.4f}' for x in timed)}; rank 0's host clock "
              f"ending in the loss read), {tokens / s_step:,.0f} tokens/s, "
              f"{s_step / s_one:.3f} of one card's s per step and "
              f"{s_one / s_step:.3f} of its tokens/s; roofline_terms("
              f"n_chips={d * t}, tp={t}) bound {rt['step_time_lb']:.4f} s by "
              f"{rt['bottleneck']} (compute {rt['t_compute']:.4f} s, memory "
              f"{rt['t_memory']:.4f} s, collective {rt['t_collective']:.4f} "
              f"s), {100 * rt['step_time_lb'] / s_step:.2f}% of the step; "
              f"losses {[round(x['loss'], 4) for x in rec['history']]}; "
              f"collectives of the timed steps, 'data' least over the ranks "
              f"/ rank 0's, 'model' least / rank 0's: "
              f"{'; '.join(f'{a:.6f} / {b:.6f}, {c:.6f} / {e:.6f}' for a, b, c, e in coll)}"
              f" s; per card (coord, masters + moments, peak while built, "
              f"peak above the state in the steps, GiB; its own 'data' and "
              f"'model' collective seconds over all steps, waits included) "
              f"{per_card}; "
              f"gathered leaves ({len(rec['gathered'])}) "
              f"{rec['gathered'][:6]}{' ...' if len(rec['gathered']) > 6 else ''}"
              f"; run {t_b:.2f} s {card}", flush=True)

    # ----------------------------------------- (c) float32 on the meshes
    t_c = time.perf_counter()
    base = ["--arch", TP_F32_ARCH, "--batch", str(TP_F32_BATCH), "--seq",
            str(TP_F32_SEQ), "--accum", str(TRAIN_ACCUM), "--steps", "1",
            "--data-pattern", "cyclic", "--log-every", "1", "--seed", "0"]
    steps_n = 1
    one32 = run(["--device", "cuda:0"])["history"][0]
    torch.cuda.empty_cache()
    f32_meshes = [(1, 1)] if n == 1 else [(1, n)] + (
        [(2, n // 2)] if n >= 4 else [])
    gaps = []
    for d, t in f32_meshes:
        rec = run(["--data-mesh", str(d)])
        check((rec["data_mesh"], rec["model_mesh"]) == (d, t),
              f"float32 mesh ({rec['data_mesh']}, {rec['model_mesh']})")
        h = rec["history"][0]
        e = (rel(h["loss"], one32["loss"]),
             rel(h["grad_norm"], one32["grad_norm"]))
        check(d * t > 1 or (h["loss"] == one32["loss"]
                            and h["grad_norm"] == one32["grad_norm"]),
              f"float32 (1, 1) first step not bitwise one card's: {h}")
        check(max(e) <= TRAIN_TP_F32_RTOL,
              f"float32 ({d}, {t}) first step: loss {h['loss']!r} vs one "
              f"card {one32['loss']!r}, gradient norm {h['grad_norm']!r} "
              f"vs {one32['grad_norm']!r}: {e[0]:.3e}, {e[1]:.3e}")
        gaps.append(((d, t), h["loss"], h["grad_norm"], e))
    print(f"LM tensor parallel {TP_ARCH} in float32 (TF32 off), batch "
          f"{TP_F32_BATCH} x seq {TP_F32_SEQ}, accum {TRAIN_ACCUM}, first "
          f"step: one card loss {one32['loss']!r}, gradient norm "
          f"{one32['grad_norm']!r}; "
          f"{'; '.join(f'{m}: {lo!r}, {gn!r} ({e[0]:.3e}, {e[1]:.3e})' for m, lo, gn, e in gaps)}"
          f" (<= {TRAIN_TP_F32_RTOL:g}); {time.perf_counter() - t_c:.2f} "
          f"s {card}", flush=True)
    print(f"LM tensor parallel: phase 20 in {time.perf_counter() - t20:.2f} "
          f"s; kernel launches of the workers, summed {total} {card}",
          flush=True)
    return total


def lm_serve_tp_phase(card: str) -> dict:
    """Phase 21, LM serving with tensor parallelism over 'model'
    (``launch.serve.serve_on_mesh``: rank r on cuda:r under NCCL, each
    holding its rows, its part of the model made once at load and its
    block of the KV cache), which launches none of the three kernels: the
    counts are set to 0 before each run in this process and must read 0
    after it, and each worker counts from 0 and hands its counts back;
    their sums are checked to be 0 and returned.  A failed check exits.

    Every run: batch B21, prompt P21 through the decode path, G21 greedy
    tokens (or one card's tokens fed, where logits are compared), then
    ``make_prefill_step`` over every position fed; weights from seed 0
    (each rank draws its blocks of the one-card draw); logits kept at
    KEEP21.

    (a) SERVE_TP_ARCH at its published width in bf16, one card in this
        process and (1, 1) through one spawned rank: tokens, decode and
        prefill logits bitwise.
    (b) On N >= 2 cards: SERVE_TP_ARCH at (1, 2) and, on four, (1, 4),
        and SERVE_SPLIT_ARCH (one KV head: its cache's sequence axis
        split over 'model', the ranks' partial softmaxes combined) at
        (1, 2), each fed its one-card run's tokens, decode and prefill
        logits within LM_TP_BF16_RTOL of one card's; in float32,
        SERVE_TP_ARCH at (1, min(N, 4)) and SERVE_SPLIT_ARCH at (1, 2)
        within LM_TP_F32_RTOL of a float32 card's.  Each prints ms
        per decode step and tokens/s against one card's, each card's
        KV-cache and parameter bytes at rest (the rules' blocks) and as
        served, and the 'model' collective seconds a generated token.
    (c) The dry-run's two contract cells (``python -m repro_torch.
        launch.dryrun`` in subprocesses on the host's cores, started
        first, read last): status "ok", ``n_chips``, ``hlo_flops`` > 0
        and a known bottleneck.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_on_mesh

    def rel_err(got, want) -> float:
        got, want = got.float(), want.float()
        scale = want.abs().amax(dim=-1) + 1e-6
        return float(((got - want).abs().amax(dim=-1) / scale).max())

    n = torch.cuda.device_count()
    t21 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="dryrun-")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cells = {c: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", c[0],
         "--shape", c[1], "--mesh", c[2], "--out", out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in DRYRUN_CELLS}
    total = {}

    def run(arch, mesh, **kw) -> dict:
        ops.reset_launch_counts()
        rec = serve_on_mesh(arch, mesh, batch=B21, prompt_len=P21,
                            gen=G21, keep=KEEP21,
                            device="cuda:0" if mesh is None else "cuda",
                            **kw)
        mine = ops.launch_counts()
        check(not any(mine.values()), f"LM serving launched {mine}")
        for r in rec["ranks"]:
            check(not any(r["launches"].values()),
                  f"a serving rank launched {r['launches']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        S = P21 + G21
        check(rec["tokens"].shape == (B21, S)
              and rec["logits"].shape == rec["prefill_logits"].shape
              == (B21, len(KEEP21), rec["cfg"].padded_vocab)
              and bool(torch.isfinite(rec["logits"]).all())
              and bool(torch.isfinite(rec["prefill_logits"]).all()),
              f"{mesh}: tokens {tuple(rec['tokens'].shape)}, logits "
              f"{tuple(rec['logits'].shape)}, or not finite")
        return rec

    def figures(rec, one) -> str:
        r0 = rec["ranks"][0]
        tok_s = B21 * G21 / rec["t_gen"]
        line = (f"{rec['ms_per_step']:.3f} ms per decode step "
                f"({rec['ms_per_step'] / one['ms_per_step']:.3f} of one "
                f"card's), {tok_s:.1f} tokens/s "
                f"({tok_s * one['t_gen'] / (B21 * G21):.3f} of one card's), "
                f"prompt through the decode path {rec['t_prompt']:.2f} s, "
                f"prefill step {rec['t_prefill']:.3f} s; a card: KV cache "
                f"{r0['cache_at_rest_bytes'] / 2**20:.2f} MiB at rest / "
                f"{r0['cache_bytes'] / 2**20:.2f} MiB served (one card "
                f"{one['ranks'][0]['cache_bytes'] / 2**20:.2f}), parameters "
                f"{r0['params_at_rest_bytes'] / 2**30:.3f} GiB at rest / "
                f"{r0['params_serving_bytes'] / 2**30:.3f} GiB served + "
                f"{r0['cast_bytes'] / 2**30:.3f} GiB cast (one card "
                f"{one['ranks'][0]['params_at_rest_bytes'] / 2**30:.3f})")
        if "model_collective_s" in rec:
            line += (f"; 'model' collectives a generated token "
                     f"{rec['model_collective_s'] * 1e3:.3f} ms least over "
                     f"the ranks / {rec['model_collective_rank0_s'] * 1e3:.3f}"
                     f" ms rank 0's")
        return line

    # ------------------------------------------------ (a) one card, (1, 1)
    one = run(SERVE_TP_ARCH, None)
    cfg = one["cfg"]
    check((cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == ("qwen3-0.6b", 28, 1024, 16, 8, 128, 3072, 151936, "bfloat16"),
          f"qwen3-0.6b is not at its published width: {cfg}")
    print(f"LM serve over 'model' {SERVE_TP_ARCH} (published width) one card "
          f"in this process, bf16, batch {B21}, prompt {P21} + gen {G21}: "
          f"{figures(one, one)} {card}", flush=True)
    r11 = run(SERVE_TP_ARCH, (1, 1))
    check(r11["mesh"] == (1, 1), f"mesh {r11['mesh']}")
    for k in ("tokens", "logits", "prefill_logits"):
        check(bool(torch.equal(r11[k], one[k])),
              f"(1, 1) {k} differ from one card's: not bitwise")
    print(f"LM serve over 'model' {SERVE_TP_ARCH} mesh (1, 1) (one NCCL "
          f"worker): tokens, decode and prefill logits bitwise one card's; "
          f"{figures(r11, one)} {card}", flush=True)
    del r11

    # ------------------------------------------------- (b) N >= 2 cards
    if n >= 2:
        runs = [(SERVE_TP_ARCH, (1, 2), one)]
        if n >= 4:
            runs.append((SERVE_TP_ARCH, (1, 4), one))
        runs.append((SERVE_SPLIT_ARCH, (1, 2), None))
        for arch, mesh in ((SERVE_TP_ARCH, (1, min(n, 4))),
                           (SERVE_SPLIT_ARCH, (1, 2))):
            runs.append((dataclasses.replace(get_config(arch),
                                             dtype="float32"), mesh, None))
        for arch, mesh, base in runs:
            if base is None:
                base = run(arch, None)
                print(f"LM serve over 'model' {base['cfg'].name} "
                      f"{base['cfg'].dtype} one card in this process: "
                      f"{figures(base, base)} {card}", flush=True)
            rec = run(arch, mesh, tokens=base["tokens"].numpy())
            f32 = rec["cfg"].dtype == "float32"
            gate = LM_TP_F32_RTOL if f32 else LM_TP_BF16_RTOL
            e_dec = rel_err(rec["logits"], base["logits"])
            e_pre = rel_err(rec["prefill_logits"], base["prefill_logits"])
            name = rec["cfg"].name
            check(rec["mesh"] == mesh and e_dec <= gate and e_pre <= gate,
                  f"{name} {'float32 ' if f32 else ''}mesh {rec['mesh']}: "
                  f"decode logits {e_dec:.3e}, prefill {e_pre:.3e} from one "
                  f"card's (gate {gate:g})")
            if name == SERVE_SPLIT_ARCH:
                check(not rec["plan"]["kv"],
                      f"{name}: plan {rec['plan']}: no split sequence")
            print(f"LM serve over 'model' {name} "
                  f"{'float32' if f32 else 'bf16'} mesh {mesh} (NCCL, "
                  f"{mesh[1]} worker processes), fed one card's tokens: "
                  f"decode logits {e_dec:.3e}, prefill {e_pre:.3e} from one "
                  f"card's (<= {gate:g}); plan {rec['plan']}; "
                  f"{figures(rec, base)} {card}", flush=True)
            del rec
            if base is not one:
                del base
            torch.cuda.empty_cache()

    # -------------------------------------------- (c) the dry-run cells
    for cell, proc in cells.items():
        log, _ = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"dry-run {cell}: {log[-2000:]}")
        with open(os.path.join(out, "__".join(cell) + ".json")) as f:
            res = json.load(f)
        chips = 512 if cell[2] == "multipod" else 256
        check(res["status"] == "ok" and res["n_chips"] == chips
              and res["hlo_flops"] > 0
              and res["bottleneck"] in ("compute", "memory", "collective"),
              f"dry-run {cell}: {res}")
        print(f"LM dry-run {' x '.join(cell)} on the meta device (fake "
              f"process group, {res['n_chips']} ranks, rank 0 traced): "
              f"status {res['status']}, traced in {res['trace_s']} s, "
              f"hlo_flops {res['hlo_flops']:.4e}, traced_flops "
              f"{res['traced_flops']:.4e}, bottleneck {res['bottleneck']}, "
              f"collectives {res['collectives']}, link traffic "
              f"{res['link_traffic_bytes']:.4e} B, at rest "
              f"{res['bytes_at_rest_per_device'] / 2**30:.3f} GiB a device",
              flush=True)
    print(f"LM serve over 'model': phase 21 in "
          f"{time.perf_counter() - t21:.2f} s; kernel launches of the "
          f"workers, summed {total} {card}", flush=True)
    return total


def main() -> int:
    import torch

    # ------------------------------------------------------------ 1. card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        from repro_torch.core import engine, jointree, lattice
        from repro_torch.core import querygraph as qg
        from repro_torch.core.baselines import dpsub
        from repro_torch.core.ccap import ccap
        from repro_torch.core.dpccp import dpccp_with_tree
        from repro_torch.core.dpconv_max import dpconv_max_ref
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.ranked_conv import ranked_conv_cuda
        from repro_torch.kernels.zeta_cuda import (launch_cluster,
                                                   launch_high, launch_plan)
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
    alone = {"20": lm_tp_phase, "21": lm_serve_tp_phase}
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" \
            and sys.argv[2] in alone:
        # one phase alone (a four-card call): its lines, no kernel table
        counts = alone[sys.argv[2]](card)
        print("kernels: " + ", ".join(f"{k} {counts.get(k, 0)}"
                                      for k in build.KERNELS))
        print(smi_line)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": kind,
                                                 "count": count}}))
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}: none, "
          "--phase 20 or --phase 21")

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
    # Every launch of the plan against its plain version, n = 0..17, and
    # for the zeta_high chunks (1, 2^n) at n = 18..21 (one chunk of 3..5
    # bits, then 5 + 1 bits) and (8, 2^20): full-range int32, integer and
    # random f32, integer and random f64 (bits in increasing order, each
    # add rounded alone, so all five are bitwise); each zeta_high launch
    # in place and into another tensor; the whole transform into a fresh
    # tensor and in place; mobius(zeta(x)) == x on the exact inputs.
    shapes = [(1 << n,) for n in range(18)]
    shapes += [(16, 1 << n) for n in range(18)]
    shapes += [(2, 16, 1 << n) for n in range(18)] + [(16, 16, 1 << 15)]
    shapes += [(1, 1 << n) for n in range(18, 22)] + [(8, 1 << 20)]
    for shape in shapes:
        n = shape[-1].bit_length() - 1
        inputs = [
            (rng.integers(-2**31, 2**31, shape, dtype=np.int64)
             .astype(np.int32), True),
            (rng.integers(-8, 9, shape).astype(np.float32), True),
            (rng.random(shape, dtype=np.float32), False),
            (rng.integers(-2**20, 2**20, shape).astype(np.float64), True),
            (rng.standard_normal(shape), False)]
        for a, exact in inputs:
            x = on_card(a)
            plan = launch_plan(n, x.element_size())
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
                for _, lo, hi in plan[1:]:
                    want = ref.zeta_stages_ref(x, sign, lo, hi)
                    y = x.clone()
                    launch_high(y, lo, hi, sign)
                    ok = record("zeta_high", y, want)
                    check(ok, f"zeta_high in place {x.dtype} {shape} bits "
                          f"{lo}..{hi - 1} sign {sign}")
                    y = torch.empty_like(x)
                    launch_high(x, lo, hi, sign, out=y)
                    ok = record("zeta_high", y, want)
                    check(ok, f"zeta_high {x.dtype} {shape} bits "
                          f"{lo}..{hi - 1} sign {sign}")
                want = ref.mobius_ref(x) if sign < 0 else ref.zeta_ref(x)
                check(torch.equal(ops.zeta_op(x, inverse=sign < 0), want),
                      f"zeta_op {x.dtype} {shape} sign {sign}")
                y = x.clone()
                ops.zeta_op(y, inverse=sign < 0, out=y)
                check(torch.equal(y, want),
                      f"zeta_op in place {x.dtype} {shape} sign {sign}")
            if exact:
                check(torch.equal(ops.mobius_op(ops.zeta_op(x)), x),
                      f"mobius(zeta(x)) != x on {x.dtype} {shape}")
    torch.cuda.synchronize()
    print(f"zeta: every launch == its plain version, bitwise, n = 0..17 on "
          f"(2^n,), (16, 2^n), (2, 16, 2^n) and (16, 16, 2^15), n = 18..21 "
          f"on (1, 2^n) and (8, 2^20), both signs, int32 full range, "
          f"integer and random f32 and f64, fresh and in place; "
          f"mobius(zeta(x)) == x", flush=True)

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

    @contextlib.contextmanager
    def eager_programs():
        """Programs built inside run eagerly on the card, as CPU ones do:
        a CUDA graph's replay runs no Python, so a wrapper around a
        kernel's launcher counts only eager calls.  The program cache is
        cleared on entry and on exit, so no eager program serves after."""
        keep = lattice.uses_graphs
        engine.clear_executable_cache()
        lattice.uses_graphs = lambda device, mesh: False
        try:
            yield
        finally:
            lattice.uses_graphs = keep
            engine.clear_executable_cache()

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
    # transforms counted apart from the kernel counters, around the
    # wrapper that runs a transform's launch plan, on eager programs (a
    # CUDA graph's replay runs no Python); the graphed solves after it
    # must make the same launches
    transforms5 = [0]
    zeta_cuda = ops.zeta_cuda

    def counted(*args, **kw):
        transforms5[0] += 1
        return zeta_cuda(*args, **kw)

    with eager_programs():
        lane.solve(items)                       # builds the programs
        ops.zeta_cuda = counted
        ops.reset_launch_counts()
        lane.solve(items)
        torch.cuda.synchronize()
        eager5 = ops.launch_counts()
        ops.zeta_cuda = zeta_cuda
    lane.solve(items)                           # builds, captures a part
    lane.solve(items)                           # captures the rest
    torch.cuda.synchronize()
    engine.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = lane.solve(items)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    counts5 = ops.launch_counts()
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
    check(eager5["zeta_cluster"] == transforms5[0] > 0
          and eager5["zeta_high"] == 0,
          f"the fused lane made {eager5} launches for {transforms5[0]} "
          f"transforms; one zeta_cluster launch per transform expected")
    check(counts5 == eager5,
          f"the graphed lane made {counts5} launches, eagerly {eager5}")
    check(engine.stats().graph_calls > 0,
          "the timed fused lane replayed no CUDA graph")
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
          and counts6["zeta_high"] == 0,
          f"the host lane's launches {counts6}: zeta_cluster and "
          f"ranked_conv expected, no zeta_high at n = 13")
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
    # the f64 tier launches the zeta kernels only, as launch_plan(18, 8)
    # says: one zeta_cluster and one zeta_high launch per transform
    counts7 = ops.launch_counts()
    high7 = len(launch_plan(18, 8)) - 1
    check(high7 == 1 and counts7["zeta_cluster"] > 0
          and counts7["zeta_high"] == high7 * counts7["zeta_cluster"]
          and counts7["ranked_conv"] == counts7["minplus_layer"] == 0,
          f"the f64 tier launched {counts7} at n = 18: zeta_cluster and "
          f"{high7} zeta_high per transform expected, nothing else")
    for (q, cq), r in zip(big, got7):
        check(r.tree.validate() and r.tree.cost_max(cq) == r.cost,
              "n=18: tree does not realize its optimum")
    qps7 = len(big) / t_big
    print(f"large: 4 clique(18) queries on the f64 tier in {t_big:.4f} s "
          f"(first call of this bucket), {qps7:.3f} queries/s, launches "
          f"{counts7} {card}", flush=True)

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
    # pass 1 runs the f64 tier (the zeta kernels only, as launch_plan(15,
    # 8) says: a zeta_cluster and a zeta_high launch per transform; no
    # ranked_conv); pass 2 is one minplus_layer launch per layer 2..15
    # of each program call
    check(counts8["minplus_layer"] > 0
          and counts8["minplus_layer"] % 14 == 0
          and counts8["zeta_cluster"] > 0
          and counts8["zeta_high"] == counts8["zeta_cluster"] * (
              len(launch_plan(15, 8)) - 1)
          and counts8["ranked_conv"] == 0,
          f"the cap lane launched {counts8}: its pass 1 runs the f64 tier "
          f"(a zeta_cluster and a zeta_high launch per transform), its "
          f"pass 2 14 minplus_layer launches a call")
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

    with eager_programs():
        # the build's first touch runs the program once: uncounted
        engine.fused_ccap(cl_cards, 15, backend="cuda", device=dev)
        ops.zeta_cuda = counted8
        ops.reset_launch_counts()
        k_cap = engine.fused_ccap(cl_cards, 15, backend="cuda", device=dev)
        torch.cuda.synchronize()
        counts8k = ops.launch_counts()
        ops.zeta_cuda = zeta_cuda
    for _ in range(2):                          # builds, captures
        engine.fused_ccap(cl_cards, 15, backend="cuda", device=dev)
    ops.reset_launch_counts()
    g_cap = engine.fused_ccap(cl_cards, 15, backend="cuda", device=dev)
    torch.cuda.synchronize()
    counts8g = ops.launch_counts()
    check(g_cap.gammas.tobytes() == k_cap.gammas.tobytes()
          and g_cap.couts.tobytes() == k_cap.couts.tobytes()
          and str(g_cap.trees) == str(k_cap.trees) and counts8g == counts8k,
          f"fused_ccap(backend='cuda') graphed differs from eager: launches "
          f"{counts8g} / {counts8k}")
    check([g.hex() for g in k_cap.gammas] == [g.hex() for g in f64_cap.gammas]
          and [c.hex() for c in k_cap.couts]
          == [c.hex() for c in f64_cap.couts]
          and [str(t) for t in k_cap.trees] == [str(t) for t in f64_cap.trees]
          and k_cap.rounds == f64_cap.rounds,
          "fused_ccap: the kernel tier differs from the f64 tier")
    check(counts8k["zeta_cluster"] == transforms8[0] > 0
          and counts8k["zeta_high"] == 0,
          f"fused_ccap(backend='cuda') made {counts8k} launches for "
          f"{transforms8[0]} transforms; one zeta_cluster each expected")
    print(f"cap: fused_ccap kernel tier == f64 tier on the 16 cliques, "
          f"{k_cap.rounds} rounds, {transforms8[0]} transforms, launches "
          f"{counts8k}", flush=True)

    # ------------------------------------------------------------ 9. out
    out_items = [(q, c, "out") for q, c in cliques15 + sparse15]
    got9, t_out, mem9, syncs9, counts9 = lane_run(BatchedSolver(), out_items)
    check(counts9["minplus_layer"] > 0
          and counts9["minplus_layer"] % 14 == 0
          and counts9["connmask"] == counts9["minplus_layer"] // 14
          and sum(counts9.values()) == counts9["minplus_layer"]
          + counts9["connmask"],
          f"the out lane launched {counts9}: a connmask launch (the "
          f"connected-subset masks) and 14 minplus_layer launches a call "
          f"expected, nothing else")
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
    # a sparse C_out request on a chain with a hyperedge: the router
    # sends it to the single lane's DPccp enumerator, which no sparse out
    # of the n = 12..15 stream reaches under the card's fused out
    # ceiling of 19
    q_o = qg.QueryGraph(14, qg.chain(14).edges, ((0b11, 0b11 << 7),))
    stream.append(PlanRequest(
        q=q_o, card=qg.make_cardinalities(q_o, seed=314),
        cost="out", arrival=stream[-1].arrival + 0.005,
        req_id=len(stream)))
    # a connected C_cap request on a clique with a hyperedge: the router
    # sends it to the single lane's host pipeline (core.ccap), which no
    # cap of the n = 12..15 stream reaches under the card's fused cap
    # ceiling of 19.  Every subset of a clique is connected, so a
    # cross-product-free plan attains the C_max optimum: the request is
    # feasible whatever its cardinalities
    q_h = qg.QueryGraph(12, qg.clique(12).edges, ((0b11, 0b11 << 5),))
    stream.append(PlanRequest(
        q=q_h, card=qg.make_cardinalities(q_h, seed=312,
                                          base_range=(1e1, 1e3)),
        cost="cap", connected=True, arrival=stream[-1].arrival + 0.005,
        req_id=len(stream)))
    router0 = Router()
    routes0 = [router0.route(r.q, r.cost, None,
                             signature=topology_signature(r.q),
                             connected=r.connected)
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
    check(Router().config.fused_cap_max_n == 19
          and all(rt.lane == "batch" for r, rt in zip(stream, routes0)
                  if r.cost == "cap" and not r.connected),
          "the stream's cap requests at n = 12..15 left the fused lane")
    check(Router().config.fused_out_max_n == 19
          and all(rt.lane == "batch" for r, rt in zip(stream, routes0)
                  if r.cost == "out" and rt.method == "dpccp"
                  and not r.q.hyperedges),
          "the stream's sparse out requests at n = 12..15 left the fused "
          "lane")

    def is_clique(q):
        return len(q.edges) == q.n * (q.n - 1) // 2

    # the answers a fresh server's plan_one gives, and numpy DPsub for
    # the clique max optima
    t0 = time.perf_counter()
    oracle_srv = PlanServer()
    want = {r.req_id: oracle_srv.plan_one(r.q, r.card, cost=r.cost,
                                          connected=r.connected)
            for r in stream}
    for r in stream[-1:]:
        h = ccap(r.q, r.card, engine="host", connected=True)
        check(want[r.req_id].meta.get("engine") == "host"
              and float(want[r.req_id].cost).hex() == h.cout.hex(),
              f"plan_one connected cap on a hypergraph n = {r.q.n}: "
              f"{want[r.req_id].meta.get('engine')} "
              f"{want[r.req_id].cost!r} != host pipeline {h.cout!r}")
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

    # ----------------------------------------------------- 12. early exit
    # The paper's Fig. 6 path: clique instances at n = 14..19 through the
    # host loop's early-exit binary search, the host loop's (G+1)-ary
    # search (G = 3) and the fused engine (f64; also the kernel tier at
    # n <= 15).  Optima, trees and pass counts are held as in the
    # reference: passes against the search replayed on the candidate
    # table with the optimum as oracle.
    from repro_torch.core.dpconv_max import dpconv_max

    def host_passes(cand, opt, G):
        """The host loop's pass count (the reference's definition): one
        per search round, binary (G = 1) or (G+1)-ary, plus the
        extraction pass; feasibility is ``cand[i] >= opt``."""
        lo, hi, passes = 0, len(cand) - 1, 0
        while lo < hi:
            passes += 1
            if G <= 1:
                mid = (lo + hi) // 2
                if cand[mid] >= opt:
                    hi = mid
                else:
                    lo = mid + 1
                continue
            piv = np.unique(np.linspace(lo, hi, G + 2)[1:-1]
                            .astype(np.int64))
            ok = cand[piv] >= opt
            if ok.any():
                hi = int(piv[np.nonzero(ok)[0][0]])
            if (~ok).any():
                lo = max(lo, int(piv[np.nonzero(~ok)[0][-1]]) + 1)
        return passes + 1

    ee_rows = []
    ops.reset_launch_counts()
    for n in range(14, 20):
        q, c = qg.paper_clique_instance(n, seed=n)
        cand = engine.candidate_table(c, n)
        variants = [("early exit", {"early_exit": True}),
                    ("host G=3", {"engine": "host", "gamma_batch": 3}),
                    ("fused f64", {"engine": "fused"})]
        if n <= 15:
            variants.append(("fused cuda", {"engine": "fused",
                                            "backend": "cuda"}))
        res = {}
        for label, kw in variants:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = dpconv_max(q, c, device=dev, **kw)
            torch.cuda.synchronize()
            res[label] = (r, time.perf_counter() - t0)
        base = res["early exit"][0]
        check(base.engine == "host" and res["fused f64"][0].engine
              == "fused", f"early exit n={n}: engines {base.engine}")
        for label, (r, _) in res.items():
            check(r.optimum.hex() == base.optimum.hex(),
                  f"early exit n={n}: {label} {r.optimum!r} != "
                  f"{base.optimum!r}")
            check(str(r.tree) == str(base.tree),
                  f"early exit n={n}: {label} tree differs")
        check(base.tree.validate() and base.tree.cost_max(c) == base.optimum,
              f"early exit n={n}: tree does not realize its optimum")
        for label, G in (("early exit", 1), ("host G=3", 3)):
            want_p = host_passes(cand, base.optimum, G)
            check(res[label][0].feasibility_passes == want_p,
                  f"early exit n={n}: {label} took "
                  f"{res[label][0].feasibility_passes} passes, the "
                  f"reference's search takes {want_p}")
        if n <= 15:
            oracle_n = dpsub(c, n, mode="max")[-1]
            check(base.optimum.hex() == float(oracle_n).hex(),
                  f"early exit n={n}: {base.optimum!r} != DPsub "
                  f"{oracle_n!r}")
        ee_rows.append((n, {k: (v[1], v[0].feasibility_passes)
                            for k, v in res.items()}))
        print(f"early exit n={n}: optimum {base.optimum!r}, "
              + ", ".join(f"{k} {v[1]:.4f} s / {v[0].feasibility_passes} "
                          f"passes" for k, v in res.items())
              + f"{'; == DPsub' if n <= 15 else ''} {card}", flush=True)
    counts12 = ops.launch_counts()
    check(counts12["zeta_cluster"] > 0,
          f"the early-exit phase's kernel tier launched {counts12}")
    print(f"early exit: optima, trees and passes == the reference's at "
          f"n = 14..19, launches {counts12} {card}", flush=True)

    # --------------------------------------------------------- 13. planner
    # The einsum planner at the ten configs' published widths (max, out,
    # cap), by optimize on the card and through one PlanServer; the
    # replay lane; execute_plan on the card; the data-join planner.
    from repro_torch import configs
    from repro_torch.core.baselines import dpsub_out
    from repro_torch.core.dpconv import optimize
    from repro_torch.planner import datajoin as dj
    from repro_torch.planner import einsum_path as ep
    from repro_torch.service.workload import make_einsum_workload

    PLAN_KW = {"max": {}, "cap": {},
               "out": {"method": "dpccp", "engine": "fused"}}
    ops.reset_launch_counts()
    engine.reset_stats()
    t0 = time.perf_counter()
    plan_srv = PlanServer()
    n_contractions = n_unique = 0
    trace_reqs = []
    for arch in sorted(configs.ARCHS):
        trace = ep.model_planner_trace(configs.get_config(arch))
        n_contractions += len(trace)
        solved = {}
        for ctr in trace:
            key = (ctr.operands, ctr.output, tuple(sorted(ctr.sizes.items())))
            qc, cc = ep.query_graph(ctr), ep.cardinalities(ctr)
            if key not in solved:
                n_unique += 1
                want_max = dpsub(cc, ctr.n, mode="max")[-1]
                want_out = dpsub_out(cc, ctr.n)[-1]
                got = {cost: optimize(qc, cc, cost=cost, device=dev, **kw)
                       for cost, kw in PLAN_KW.items()}
                check(got["max"].cost == want_max
                      and got["max"].tree.cost_max(cc) == want_max,
                      f"{arch} {ctr.operands}: C_max {got['max'].cost!r} "
                      f"!= DPsub {want_max!r}")
                check(got["out"].cost == want_out
                      and got["out"].tree.cost_out(cc) == want_out,
                      f"{arch} {ctr.operands}: C_out {got['out'].cost!r} "
                      f"!= DPsub {want_out!r}")
                h = ccap(qc, cc, engine="host")
                same_plan(f"{arch} {ctr.operands} cap", got["cap"], h.cout,
                          h.tree, h.gamma)
                solved[key] = got
            for cost in PLAN_KW:
                trace_reqs.append((qc, cc, cost, solved[key][cost]))
    t_opt = time.perf_counter() - t0

    def serve_trace(tag):
        hits0 = plan_srv.cache.stats.hits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resps = [plan_srv.plan_one(qc, cc, cost=cost)
                 for qc, cc, cost, _ in trace_reqs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for (qc, cc, cost, want), r in zip(trace_reqs, resps):
            check(r.status == "exact"
                  and float(r.cost).hex() == float(want.cost).hex(),
                  f"planner server {tag}: {cost} {r.cost!r} != optimize "
                  f"{want.cost!r}")
        hits = plan_srv.cache.stats.hits - hits0
        print(f"planner server {tag}: {len(resps)} requests in {dt:.4f} s, "
              f"{len(resps) / dt:.1f} requests/s, plan-cache hits {hits} "
              f"{card}", flush=True)
        return hits, dt

    serve_trace("first pass")
    hits2, _ = serve_trace("second pass")
    check(hits2 == len(trace_reqs),
          f"the second trace pass had {hits2} of {len(trace_reqs)} hits")
    print(f"planner: {n_contractions} contractions of the ten configs at "
          f"full width ({n_unique} distinct within their configs) planned as "
          f"max, out and cap by optimize in {t_opt:.3f} s: C_max == DPsub, "
          f"C_out (fused DPccp) == DPsub, C_cap == the host pipeline; "
          f"the server's answers == optimize's {card}", flush=True)

    # execute_plan on the card in float64 against one torch.einsum of the
    # whole expression
    EXEC_RTOL = 1e-10
    exec_cases = ep.model_planner_trace(
        configs.reduced(configs.get_config("qwen2-0.5b")))
    exec_cases = list({(x.operands, x.output): x for x in exec_cases}
                      .values())
    demo_c = ep.Contraction(
        operands=("ab", "bc", "ad", "be", "ef", "eg"), output="a",
        sizes={"a": 21, "b": 6, "c": 149, "d": 87, "e": 143, "f": 178,
               "g": 151})
    worst = 0.0
    for i, ctr in enumerate(exec_cases + [demo_c]):
        tree = optimize(ep.query_graph(ctr), ep.cardinalities(ctr),
                        cost="max", device=dev).tree
        xs = [on_card(rng.normal(size=tuple(ctr.sizes[a] for a in op)))
              for op in ctr.operands]
        got = ep.execute_plan(ctr, tree, xs)
        want_t = torch.einsum(",".join(ctr.operands) + "->" + ctr.output,
                              *xs)
        check(got.device == dev and got.dtype == torch.float64
              and got.shape == want_t.shape,
              f"execute_plan {ctr.operands}: {got.device} {got.shape}")
        scale = float(want_t.abs().max())
        e = float((got - want_t).abs().max()) / max(scale, 1e-300)
        worst = max(worst, e)
        check(e <= EXEC_RTOL,
              f"execute_plan {ctr.operands}: relative error {e:.3e}")
    print(f"planner execute_plan: {len(exec_cases)} distinct contractions "
          f"of reduced qwen2-0.5b and the demo's, float64 on the card, max "
          f"|plan - einsum| / max |einsum| = {worst:.3e} <= {EXEC_RTOL:g}",
          flush=True)

    # the demo's data-join pipeline: planned on the card and through the
    # server, executed on the host (numpy) in every order
    tables = [dj.Table("examples", ("doc",), 2_000_000),
              dj.Table("docs", ("doc", "src"), 500_000),
              dj.Table("sources", ("src",), 2_000),
              dj.Table("quality", ("doc",), 480_000),
              dj.Table("dedup", ("doc",), 450_000)]
    joins = [dj.JoinSpec(0, 1, "doc", 1 / 500_000),
             dj.JoinSpec(1, 2, "src", 1 / 2_000),
             dj.JoinSpec(1, 3, "doc", 1 / 490_000),
             dj.JoinSpec(1, 4, "doc", 1 / 470_000)]
    jq, jcard = dj.build_graph(tables, joins)
    jplans = {"cap": dj.plan_joins(tables, joins, "cap", device=dev)[0],
              "max": dj.plan_joins(tables, joins, "max", device=dev)[0],
              "server": dj.plan_joins(tables, joins, "cap",
                                      server=plan_srv)[0]}
    hj = ccap(jq, jcard, engine="host")
    same_plan("datajoin cap", jplans["cap"], hj.cout, hj.tree, hj.gamma)
    check(float(jplans["server"].cost).hex() == float(hj.cout).hex(),
          "datajoin: the server's plan differs from the host pipeline")
    drng = np.random.default_rng(7)
    ex = np.zeros(2000, dtype=[("doc", "i8"), ("w", "f8")])
    ex["doc"], ex["w"] = drng.integers(0, 500, 2000), drng.random(2000)
    dc = np.zeros(500, dtype=[("doc", "i8"), ("src", "i8")])
    dc["doc"], dc["src"] = np.arange(500), drng.integers(0, 20, 500)
    sr = np.zeros(20, dtype=[("src", "i8"), ("lic", "i8")])
    sr["src"] = np.arange(20)
    qu = np.zeros(480, dtype=[("doc", "i8"), ("q", "f8")])
    qu["doc"] = np.arange(480)
    dd = np.zeros(450, dtype=[("doc", "i8"), ("cl", "i8")])
    dd["doc"] = np.arange(450)
    jdata = [ex, dc, sr, qu, dd]
    def join_rows(tree):
        res = dj.execute(jdata, joins, tree)
        names = sorted(res.dtype.names)       # column order follows the tree
        return sorted(zip(*(res[k].tolist() for k in names)))

    jrows = [join_rows(p.tree) for p in jplans.values()]
    check(all(r == jrows[0] for r in jrows[1:])
          and len(jrows[0]) == int((ex["doc"] < 450).sum()),
          "datajoin: join orders return different rows")
    print(f"planner datajoin: the demo pipeline's cap plan == the host "
          f"pipeline (gamma {hj.gamma!r}, C_out {hj.cout!r}), three plans "
          f"execute to the same {len(jrows[0])} rows", flush=True)

    # the replay lane served by serve; each answer against optimize with
    # the route's method (the host loop for max and cap), as the lattice
    # parity test holds it
    ereqs = make_einsum_workload(WorkloadSpec(n_requests=96, seed=2))
    esrv = PlanServer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eresps, _ = esrv.serve(list(ereqs), closed_loop=True)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    held = 0
    for req, resp in zip(ereqs, eresps):
        if resp.route.method in ("goo", "approx"):
            continue
        if req.cost == "cap":
            want_r = optimize(req.q, req.card, cost="cap", engine="host",
                              device=dev)
        else:
            kw = dict(resp.route.kw())
            if resp.route.method == "dpconv" and req.cost == "max":
                kw["engine"] = "host"
            want_r = optimize(req.q, req.card, cost=req.cost,
                              method=resp.route.method, device=dev, **kw)
        check(float(resp.cost).hex() == float(want_r.cost).hex(),
              f"replay #{req.req_id}: {resp.cost!r} != optimize "
              f"{want_r.cost!r} ({resp.route.method})")
        held += 1
    check(held > 0, "the replay lane held no answer")
    counts13 = ops.launch_counts()
    print(f"planner replay lane: make_einsum_workload(96, seed 2) served in "
          f"{t_replay:.4f} s, {len(ereqs) / t_replay:.2f} requests/s; "
          f"{held} answers == optimize with the route's method, "
          f"{len(ereqs) - held} goo/approx; launches over the planner "
          f"phase {counts13} (no plan reaches n = 12: any zeta launch is "
          f"the f64 tier's) {card}", flush=True)

    # --------------------------------------------------------- 14. cluster
    # Three loopback replicas on the card (fused engine, batch lane) on
    # phase 11's stream; the loopback chaos run twice; two spawned TCP
    # replicas on the same card with cross-replica prewarm and dumps.
    import importlib.util
    import tempfile

    from repro_torch.service import cluster as cluster_mod
    from repro_torch.service import net as net_mod

    def loopback(plan=None):
        clk = VirtualClock()
        states = {}
        for i in range(3):
            srv = PlanServer(batch_policy=BatchPolicy(engine="fused"))
            observe = srv._observe_batch
            srv._observe_batch = (
                lambda timings, observe=observe: observe(
                    [(n, cnt, 1e-3 * cnt, eng, cost, tags)
                     for n, cnt, _, eng, cost, tags in timings]))
            rt = srv.make_runtime(clock=clk,
                                  config=RuntimeConfig(max_batch=1),
                                  duration_fn=lambda kind, info: 1e-3)
            states[f"r{i}"] = net_mod.ReplicaState(srv, replica_id=f"r{i}",
                                                   runtime=rt)
        inj = None if plan is None else faults.FaultInjector(plan)
        transport = cluster_mod.LoopbackTransport(states, clock=clk,
                                                  injector=inj)
        return clk, states, transport, cluster_mod.ClusterClient(
            transport, sorted(states))

    def cluster_run(plan=None):
        clk, states, transport, client = loopback(plan)
        out = []
        for r in stream:
            try:
                out.append(client.plan_request(r))
            except faults.NetworkError as e:
                out.append(e)
        return out, client, states, transport, clk

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lb_resps, lb_client, lb_states, lb_tr, _ = cluster_run()
    torch.cuda.synchronize()
    t_lb = time.perf_counter() - t0
    counts14 = ops.launch_counts()
    same_as_plan_one("cluster loopback", stream, lb_resps, want)
    owner_hits = sum(s.server.cache.stats.hits for s in lb_states.values())
    cross = sum(s.server.cache.stats.cross_hits for s in lb_states.values())
    check(counts14["zeta_cluster"] > 0,
          f"the loopback cluster launched {counts14}")
    print(f"cluster loopback: 3 replicas on the card, {len(stream)} requests "
          f"in {t_lb:.4f} s, {len(stream) / t_lb:.2f} requests/s, owner "
          f"cache hits {owner_hits}, publishes "
          f"{lb_client.stats['publishes']}, isomorph (cross) hits {cross}, "
          f"transport calls {lb_tr.calls}, launches {counts14}; every "
          f"answer == plan_one {card}", flush=True)

    # the shared plan-cache tier: a spread client (round robin, no
    # affinity) has non-owners solve and publish to the key's owner; an
    # affinity client then replays the stream through the owners
    _, sp_states, sp_tr, aff_client = loopback()
    sp_client = cluster_mod.ClusterClient(sp_tr, sorted(sp_states),
                                          affinity=False)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sp_resps = [sp_client.plan_request(r) for r in stream]
    hits0 = sum(s.server.cache.stats.hits for s in sp_states.values())
    rp_resps = [aff_client.plan_request(r) for r in stream]
    torch.cuda.synchronize()
    t_sp = time.perf_counter() - t0
    counts14s = ops.launch_counts()
    same_as_plan_one("cluster spread", stream, sp_resps, want)
    same_as_plan_one("cluster replay", stream, rp_resps, want)
    rp_hits = sum(r.cache_hit for r in rp_resps)
    remote = sum(s.server.cache.stats.remote_inserts
                 for s in sp_states.values())
    cross_sp = sum(s.server.cache.stats.cross_hits
                   for s in sp_states.values())
    check(sp_client.stats["publishes"] >= remote > 0 and rp_hits > 0,
          f"cluster spread: publishes {sp_client.stats['publishes']}, "
          f"remote inserts {remote}, replay hits {rp_hits}")
    counts14 = {k: counts14[k] + counts14s[k] for k in counts14}
    print(f"cluster spread + replay: {2 * len(stream)} requests in "
          f"{t_sp:.4f} s, {2 * len(stream) / t_sp:.2f} requests/s; the "
          f"spread client published {sp_client.stats['publishes']} plans "
          f"to their owners ({remote} inserted), the affinity replay hit "
          f"{rp_hits} of {len(stream)} (cross-relabeling hits {cross_sp}, "
          f"cache hits "
          f"over both passes "
          f"{sum(s.server.cache.stats.hits for s in sp_states.values())}, "
          f"{hits0} of them in the spread pass), launches {counts14s}; "
          f"every answer == plan_one {card}", flush=True)

    chaos_plan = faults.FaultPlan(seed=13, specs=(
        faults.FaultSpec("net", "raise", rate=0.3),
        faults.FaultSpec("net", "hang", rate=0.1, hang_s=0.2)))

    def chaos_key(out, client, clk):
        return ([repr(x) if isinstance(x, Exception) else
                 (x.req_id, x.status, float(x.cost).hex(), str(x.tree),
                  x.cache_hit, x.latency) for x in out],
                dict(client.stats), sorted(client.dead), clk.now())

    t0 = time.perf_counter()
    ca, cl_a, _, _, clk_a = cluster_run(chaos_plan)
    cb, cl_b, _, _, clk_b = cluster_run(chaos_plan)
    t_cc = time.perf_counter() - t0
    check(chaos_key(ca, cl_a, clk_a) == chaos_key(cb, cl_b, clk_b),
          "cluster chaos: the two runs differ")
    check(cl_a.stats["net_errors"] > 0, "cluster chaos: no fault fired")
    exact = [(r, x) for r, x in zip(stream, ca)
             if not isinstance(x, Exception) and x.status == "exact"]
    same_as_plan_one("cluster chaos", [r for r, _ in exact],
                     [x for _, x in exact], want)
    print(f"cluster chaos: two runs identical ({t_cc:.2f} s for both), "
          f"{len(exact)} exact answers == plan_one, "
          f"{sum(isinstance(x, Exception) for x in ca)} raised, client "
          f"{ {k: v for k, v in cl_a.stats.items() if v} }", flush=True)

    # two spawned TCP replicas on the same card
    tcp_reqs = [r for r in stream if r.q.n in (12, 13)][:24]
    spec_ot = importlib.util.spec_from_file_location(
        "obs_tail", ROOT / "scripts" / "obs_tail.py")
    obs_tail = importlib.util.module_from_spec(spec_ot)
    spec_ot.loader.exec_module(obs_tail)
    t0 = time.perf_counter()
    rc = cluster_mod.ReplicaCluster(2, config={
        "engine": "fused", "enable_batch": True,
        "prewarm_ns": (12, 13), "prewarm_costs": ("max",)},
        startup_timeout_s=300.0)
    procs = []
    try:
        tcp_client = rc.start()
        procs = list(rc.procs)
        t_start = time.perf_counter() - t0
        check(rc.manifest, "TCP cluster: replica 0 recorded no manifest")
        for rid in rc.replica_ids:
            check(tcp_client.transport.call(rid, {"op": "manifest"})
                  ["manifest"] == rc.manifest,
                  f"TCP cluster: {rid} did not take the manifest")
        t1 = time.perf_counter()
        tcp_resps = tcp_client.plan_many(tcp_reqs, threads=4)
        t_tcp = time.perf_counter() - t1
        same_as_plan_one("cluster TCP", tcp_reqs, tcp_resps, want)
        with tempfile.TemporaryDirectory() as tmp:
            dumps = rc.dump_recorders(tmp)
            check(all(v["ok"] for v in dumps.values()),
                  f"TCP cluster dumps {dumps}")
            recs = obs_tail.merge_records(
                [str(Path(tmp) / f"flight_{rid}.jsonl")
                 for rid in rc.replica_ids])
        summary = obs_tail.summarize(recs)
        check(summary["kinds"].get("completed", 0) == len(tcp_reqs),
              f"TCP cluster: obs_tail summary {summary['kinds']}")
    finally:
        rc.stop()
    check(procs and all(not p.is_alive() for p in procs),
          "TCP cluster: a replica process outlived stop()")
    print(f"cluster TCP: 2 spawned replicas on the card up in "
          f"{t_start:.2f} s (replica 0 prewarmed n = 12, 13, its manifest "
          f"{len(rc.manifest)} buckets shipped to r1), {len(tcp_reqs)} "
          f"requests in {t_tcp:.4f} s, {len(tcp_reqs) / t_tcp:.2f} "
          f"requests/s, every answer == plan_one; obs_tail merged "
          f"{summary['records']} records, by replica "
          f"{summary['replicas']} {card}", flush=True)

    # ----------------------------------------------------------- 15. times
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
            launches, shape, library=None, library_note=None, per_call=1,
            ops_per_s=F32_OPS_PER_S):
        """``launch`` makes ``per_call`` launches of the kernel; the row's
        times and bound are per call."""
        dev_ms, tries = device_ms(launch, names, per_call)
        cold_ms, tries_cold = device_ms(launch, names, per_call,
                                        between=flush_l2)
        call_ms = time_ms(launch)
        host = host_us(launch, max(1, 1000 // per_call)) / per_call
        plain_ms = time_ms(plain)
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        lib_ms = lib_cold = None
        lib_text = f"library: none ({library_note})"
        if library is not None:
            # one PyTorch call of the same function: one elementwise
            # add kernel a call
            lib_ms, _ = device_ms(library, ("CUDAFunctor_add",))
            lib_cold, _ = device_ms(library, ("CUDAFunctor_add",),
                                    between=flush_l2)
            lib_text = (f"library ({library_note}) {lib_ms:.5f} ms warm, "
                        f"{lib_cold:.5f} ms L2 cold")
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err[kernel], "ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "library_ms_l2_cold": lib_cold,
                     "library_note": library_note,
                     "ms_method": "torch.profiler self device time",
                     "profiler_sessions": [tries, tries_cold],
                     "ms_l2_cold": cold_ms,
                     "host_call_ms": call_ms, "host_us_per_launch": host,
                     "launches_per_call": per_call, "shape": shape})
        print(f"time {kernel} {shape}: device {dev_ms:.5f} ms per call "
              f"warm, {cold_ms:.5f} ms L2 cold (torch.profiler, "
              f"{per_call} kernel(s) per call, profiler sessions "
              f"{tries} / {tries_cold}), "
              f"host-launched call {call_ms:.5f} ms, host cost "
              f"{host:.2f} us per launch, plain {plain_ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}, {100 * b_ms / cold_ms:.1f}% of it "
              f"cold), {lib_text} {card}", flush=True)

    launches = {k: counts5[k] + counts6[k] + counts8[k] + counts8k[k]
                + counts9[k] + server_launches[k] + runtime_launches[k]
                + counts12[k] + counts13[k] + counts14[k]
                for k in build.KERNELS}
    # zeta_high serves transforms of more than 15 bits, 14 in f64: the
    # f64 tier's at n = 15..19 (phases 7, 8 and 12), none on the int32
    # tier (phases 5, 6 and the kernel tier of 8) or at n <= 14 (9)
    high15 = sum(c["zeta_high"] for c in (counts5, counts6, counts8k,
                                          counts9))
    check(high15 == 0 and counts7["zeta_high"] > 0
          and counts8["zeta_high"] > 0 and counts12["zeta_high"] > 0,
          f"zeta_high launches: {high15} on the int32 tier (none "
          f"expected), {counts7['zeta_high']}, {counts8['zeta_high']} and "
          f"{counts12['zeta_high']} in phases 7, 8 and 12 (the f64 tier "
          f"at n = 15..19)")
    check(launches["minplus_layer"] > 0,
          "phases 5-14 ran no minplus_layer: the cap and out lanes left "
          "the kernel sweep")
    no_library = "no PyTorch call computes a subset zeta"
    row("zeta_cluster", ("zeta_cluster_kernel",),
        "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:53",
        lambda: launch_cluster(x, out, 15, 1),
        lambda: ref.zeta_ref(x),
        8 * total, total // 2 * 15, launches["zeta_cluster"],
        "(16, 2^15) int32, 15 bits", library_note=no_library)
    # zeta_high serves bits >= 15 only.  Bit 15 of an (8, 2^16) table (as
    # many elements as the row above): a launch over b bits reads 4 T
    # bytes and writes 4 T (1 - 2^-b); one bit is one PyTorch add_ on two
    # strided views.  Then bits 15..19 of (8, 2^20) in one launch, which
    # no one PyTorch call computes.
    xp = on_card(rng.integers(0, 2, (8, 1 << 16)).astype(np.int32))
    xpv = xp.view(-1, 2, 1 << 15)
    row("zeta_high", ("zeta_high_kernel",), "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:101",
        lambda: launch_high(xp, 15, 16, 1),
        lambda: ref.zeta_stages_ref(xp, 1, 15, 16),
        4 * total + 4 * total // 2, total // 2, launches["zeta_high"],
        "(8, 2^16) int32, bit 15",
        library=lambda: xpv[:, 1].add_(xpv[:, 0]),
        library_note="x.view(-1, 2, 2^15): v[:, 1].add_(v[:, 0])")
    xq = on_card(rng.integers(0, 2, (8, 1 << 20)).astype(np.int32))
    tq = xq.numel()
    row("zeta_high", ("zeta_high_kernel",), "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:101",
        lambda: launch_high(xq, 15, 20, 1),
        lambda: ref.zeta_stages_ref(xq, 1, 15, 20),
        4 * tq + 4 * tq * 31 // 32, 5 * tq // 2, launches["zeta_high"],
        "(8, 2^20) int32, bits 15..19",
        library_note="no one PyTorch call applies several bits")
    k = 8
    rest = Z[0].numel()
    row("ranked_conv", ("ranked_conv",), "src/repro_torch/csrc/ranked_conv.cu",
        "src/repro/kernels/ranked_conv.py:31",
        lambda: ranked_conv_cuda(Z, k),
        lambda: ref.ranked_conv_ref(Z, k),
        4 * rest * (k - 1) + 4 * rest, rest * k, launches["ranked_conv"],
        "(16, 16, 2^15) int32, k = 8",
        library_note="no PyTorch call computes a ranked convolution")
    # The (min,+) sweep kernel against the gather sweep it replaces on
    # the card (lattice._minplus_sweep, the plain version's arithmetic),
    # bitwise, with the launch counts reset just before each kernel
    # sweep: n = 13, B = 16 connected and seeded (sparse C_out/C_cap,
    # batched: chain, star, cycle and sparse rows), and n = 19, B = 1
    # value (C_cap's pass 2 on a Fig. 6 clique gated at its C_max
    # optimum).  Then a kernel-table row for each, timed as whole sweeps.
    from repro_torch.core.bitset import popcounts
    from repro_torch.core.dpccp import connectivity_masks
    from repro_torch.kernels.minplus import layer_offsets, minplus_layer

    def mp_kernel(n, t):
        dp = lattice._minplus_init(t["card"], n)
        sets = lattice.layer_sets_on(n, dev)
        offs = layer_offsets(n)
        for kk in range(2, n + 1):
            minplus_layer(dp, t["card"], t["ok"], sets[offs[kk]:offs[kk + 1]],
                          n, kk, t["conn"], t["seed_vals"], t["seed_ok"])
        return dp

    def mp_gather(n, t):
        if t["conn"] is None:
            layer, inputs = lattice._value_layer, (t["card"], t["ok"])
        else:
            layer = lattice._connected_layer
            inputs = (t["card"], t["conn"]) + (
                () if t["seed_ok"] is None else (t["seed_vals"], t["seed_ok"]))
        return lattice._minplus_sweep(t["card"], n, layer, inputs, None,
                                      lattice.SHARD_CHUNK_ELEMS)

    def mp_check(label, n, t):
        want = mp_gather(n, t)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = mp_kernel(n, t)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts["minplus_layer"] == n - 1
              and sum(counts.values()) == n - 1,
              f"minplus {label}: launches {counts}, {n - 1} expected")
        check(got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes(),
              f"minplus {label}: the kernel differs from the gather sweep")
        return int(torch.isfinite(got[..., -1]).sum())

    n13, b13 = 13, 16
    makers13 = (qg.chain, qg.star, qg.cycle,
                lambda m: qg.random_sparse(m, extra_edges=2, seed=m))
    qs13 = [makers13[b % 4](n13) for b in range(b13)]
    cards13 = np.stack([qg.make_cardinalities(
        q, seed=600 + b, base_range=(1e2, 1e6),
        selectivity_range=(1e-4, 1.0), cap=1e8) for b, q in enumerate(qs13)])
    conn13 = on_card(np.stack([connectivity_masks(q) for q in qs13]))
    t13 = {"card": on_card(cards13), "ok": conn13, "conn": conn13,
           "seed_vals": None, "seed_ok": None}
    cold13 = mp_gather(n13, t13)
    # seeds as a layer cache replays them: the sets of up to three
    # relations and every fifth larger set, every tenth off the sweep's
    # own value
    pc13 = on_card(popcounts(n13))
    ids13 = torch.arange(1 << n13, device=dev)
    t13["seed_ok"] = (((pc13 <= 3) | (ids13 % 5 == 0))[None, :]
                      & conn13).contiguous()
    t13["seed_vals"] = torch.where(ids13 % 10 == 0, cold13 * 1.5,
                                   cold13).contiguous()
    fin13 = mp_check("n=13 B=16 connected seeded", n13, t13)
    check(fin13 == b13, f"minplus n=13: {fin13} of {b13} rows finite")
    n19 = 19
    q19 = qg.clique(n19)
    card19 = qg.make_cardinalities(q19, seed=619, base_range=(1e2, 1e6),
                                   selectivity_range=(1e-4, 1.0), cap=1e8)
    gamma19 = float(engine.fused_dpconv_max(card19[None, :], n19,
                                            extract_tree=False,
                                            device=dev).optima[0])
    ok19 = (card19 <= gamma19) | (popcounts(n19) < 2)
    t19 = {"card": on_card(card19[None, :]), "ok": on_card(ok19[None, :]),
           "conn": None, "seed_vals": None, "seed_ok": None}
    fin19 = mp_check("n=19 B=1 value", n19, t19)
    check(fin19 == 1, "minplus n=19: the full set's value is not finite")
    print(f"minplus: minplus_layer == gather sweep bitwise at n=13 B=16 "
          f"(connected, seeded; 12 launches) and n=19 B=1 (value, gated "
          f"at gamma* {gamma19!r}, {int(ok19.sum())} of {1 << n19} sets "
          f"on; 18 launches) {card}", flush=True)

    def mp_splits(n):
        return sum(math.comb(n, kk) * ((1 << (kk - 1)) - 1)
                   for kk in range(2, n + 1))

    no_minplus = "no PyTorch call computes a (min,+) subset sweep"
    # least bytes: every table the sweep reads once (card 8 B, the
    # connectivity mask that is also the gate 1 B, seed values 8 B and
    # flags 1 B) and dp read once and written once (16 B), per set and
    # row; operations: an add and a min per split of layers 2..n
    row("minplus_layer", ("minplus_layer_kernel",),
        "src/repro_torch/csrc/minplus.cu",
        "src/repro/core/lattice.py:357 (XLA gathers, no pallas_call)",
        lambda: mp_kernel(n13, t13), lambda: mp_gather(n13, t13),
        b13 * (1 << n13) * (8 + 1 + 8 + 1 + 16), 2 * b13 * mp_splits(n13),
        launches["minplus_layer"],
        "(16, 2^13) float64, connected, seeded, layers 2..13",
        library_note=no_minplus, per_call=n13 - 1,
        ops_per_s=F64_OPS_PER_S)
    # card 8 B, gate 1 B, dp 16 B per set
    row("minplus_layer", ("minplus_layer_kernel",),
        "src/repro_torch/csrc/minplus.cu",
        "src/repro/core/lattice.py:357 (XLA gathers, no pallas_call)",
        lambda: mp_kernel(n19, t19), lambda: mp_gather(n19, t19),
        (1 << n19) * (8 + 1 + 16), 2 * mp_splits(n19),
        launches["minplus_layer"], "(1, 2^19) float64, value, layers 2..19",
        library_note=no_minplus, per_call=n19 - 1,
        ops_per_s=F64_OPS_PER_S)
    # The connected-subset mask kernel against QueryGraph.connected_mask
    # and against its plain version, bitwise, one launch a call: at (4,
    # 2^19) (chain, star, cycle and a JOB-like sparse graph) and at
    # qs13's (16, 2^13); then a row at (1, 2^19), the chain (the deepest
    # fixpoint), and at (16, 2^13).  Bound: the masks written once, the
    # adjacency read once.
    from repro_torch.kernels.connmask import connmask_cuda

    def adj_on_card(qs):
        return on_card(np.stack([q.adjacency() for q in qs]).astype(np.int32))

    qs19 = [qg.chain(n19), qg.star(n19), qg.cycle(n19),
            qg.random_sparse(n19, extra_edges=12, seed=n19)]
    for n_, qs_ in ((n19, qs19), (n13, qs13)):
        a_ = adj_on_card(qs_)
        ops.reset_launch_counts()
        got_ = connmask_cuda(a_, n_)
        torch.cuda.synchronize()
        counts_ = ops.launch_counts()
        check(counts_["connmask"] == 1 and sum(counts_.values()) == 1,
              f"connmask n={n_}: launches {counts_}, one expected")
        want_ = on_card(np.stack([q.connected_mask() for q in qs_]))
        check(record("connmask", got_, want_)
              and torch.equal(got_, ref.connmask_ref(a_, n_)),
              f"connmask n={n_}: the kernel differs from connected_mask")
    print(f"connmask: connmask_kernel == QueryGraph.connected_mask == "
          f"connmask_ref bitwise at (4, 2^19) and (16, 2^13) {card}",
          flush=True)
    a19 = adj_on_card(qs19[:1])
    a13 = adj_on_card(qs13)
    no_connmask = "no PyTorch call computes connected-subset masks"
    no_pallas = ("none: the reference builds the masks on the host "
                 "(QueryGraph.connected_mask, numpy), no pallas_call")
    for a_, n_, shape in ((a19, n19, "(1, 2^19) bool, chain(19)"),
                          (a13, n13, "(16, 2^13) bool, chain/star/cycle/"
                                     "sparse rows")):
        rows_ = a_.shape[0]
        row("connmask", ("connmask_kernel",),
            "src/repro_torch/csrc/connmask.cu", no_pallas,
            lambda a_=a_, n_=n_: connmask_cuda(a_, n_),
            lambda a_=a_, n_=n_: ref.connmask_ref(a_, n_),
            rows_ * (1 << n_) + 4 * rows_ * n_, 0, launches["connmask"],
            shape, library_note=no_connmask)
    check(launches["connmask"] > 0,
          "phases 5-14 ran no connmask: the out lane left the kernel masks")
    # drop the gather sweep's split tables (18.6 GB at n = 19, as much
    # again on the host) before the phases that follow
    for key in [key for key in lattice._DEVICE_TABLES
                if key[0] == "direct" and key[1] in (n13, n19)
                and key[2] > 4]:
        del lattice._DEVICE_TABLES[key]
    lattice.direct_layer_indices.cache_clear()
    del t13, t19, cold13
    torch.cuda.empty_cache()
    # one whole transform, warm in L2 and after a 64 MB write (L2 cold);
    # its bound sums the plan's launches: the cluster launch reads and
    # writes the table, a zeta_high launch over b bits reads it and
    # writes 1 - 2^-b of it
    for shape in [(16, 1 << 15), (16, 16, 1 << 15), (8, 1 << 20)]:
        xt = on_card(rng.integers(0, 2, shape).astype(np.int32))
        ot = torch.empty_like(xt)
        fn = lambda: ops.zeta_op(xt, out=ot)    # noqa: E731
        tt, nt = xt.numel(), shape[-1].bit_length() - 1
        per_call = len(launch_plan(nt))
        warm, tries = device_ms(fn, ZETA_KERNELS, per_call)
        cold, tries_cold = device_ms(fn, ZETA_KERNELS, per_call,
                                     between=flush_l2)
        call_ms = time_ms(fn)
        plain = time_ms(lambda: ref.zeta_ref(xt))
        b_ms, _ = bound(sum(8 * tt if kn == "zeta_cluster"
                            else 4 * tt + 4 * tt - (4 * tt >> (hi - lo))
                            for kn, lo, hi in launch_plan(nt)),
                        tt // 2 * nt)
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

    # --------------------------------------------------------- 16. sharded
    # The sharded lattice solve: force_device_count(4) lets cuda:0 fill
    # four solve-mesh slots; with more than one card visible, a mesh of
    # distinct cards (cuda:0..D-1) runs the same solves after it.
    # Direct solves of paper_clique_instance(n, n) (and a cycle for the
    # connected cap) at n = 14, 15 over each D, once to build the
    # program and then timed three times, held bitwise against the
    # unsharded fused solve (D = 1) and the host pipelines; then a
    # solve_shards=4 server over phase 11's stream on the repeated card,
    # held against a fresh unsharded server's plan_one.
    from repro_torch.launch import mesh as mesh_mod

    def sharded_solve(cost, q, c, D):
        """One direct solve on a D-slot mesh: (value(s), tree, dp)."""
        if cost == "max":
            r = dpconv_max(q, c, engine="fused", backend="cuda", shards=D,
                           device=dev)
            return (r.optimum,), r.tree, None
        if cost in ("cap", "cap_conn"):
            r = ccap(q, c, engine="fused", connected=cost == "cap_conn",
                     shards=D, device=dev)
            return (r.gamma, r.cout), r.tree, None
        r = optimize(q, c, cost="out", method="dpccp", engine="fused",
                     shards=D, device=dev)
        return (r.cost,), r.tree, r.meta["dp_table"]

    n_cards = torch.cuda.device_count()
    meshes16 = [("repeated card", 4, (1, 2, 4))]
    if n_cards > 1:
        meshes16.append(("distinct cards", None,
                         tuple(D for D in (1, 2, 4) if D <= n_cards)))
    peak16: dict = {}        # (mesh, n, D) -> most bytes above those held
    ops.reset_launch_counts()
    t16 = time.perf_counter()
    for n in (14, 15):
        q, c = qg.paper_clique_instance(n, seed=n)
        qc = qg.cycle(n)
        cc = qg.make_cardinalities(qc, seed=500 + n)
        hm = dpconv_max(q, c, engine="host", device=dev)
        hc = ccap(q, c, engine="host", device=dev)
        hn = ccap(qc, cc, engine="host", connected=True, device=dev)
        dpo = dpsub(c, n, mode="out")
        host = {"max": ((hm.optimum,), hm.tree, None),
                "cap": ((hc.gamma, hc.cout), hc.tree, None),
                "cap_conn": ((hn.gamma, hn.cout), hn.tree, None),
                "out": ((dpo[-1],), jointree.extract_tree_out(dpo, c, n),
                        dpo)}
        for mesh_kind, forced, shard_widths in meshes16:
            mesh_mod.force_device_count(forced)
            for cost in ("max", "cap", "cap_conn", "out"):
                qq, cq = (qc, cc) if cost == "cap_conn" else (q, c)
                base = None
                for D in shard_widths:
                    slots = engine.solve_mesh(D, dev)
                    devs = sorted(set(slots), key=str)
                    names = (("cuda:0",) * D if forced
                             else tuple(f"cuda:{i}" for i in range(D)))
                    at = f"sharded {cost} n={n} D={D} on {mesh_kind}"
                    check(mesh_mod.mesh_fingerprint(slots) == names,
                          f"{at}: mesh {slots}")
                    # one connmask launch per connected call, on the
                    # mesh's lead card; none for max and cap.  The
                    # building call may add one: a program's build runs
                    # its tail once eagerly before the call itself
                    masks16 = int(cost in ("cap_conn", "out"))
                    c0 = ops.launch_counts()["connmask"]
                    sharded_solve(cost, qq, cq, D)    # builds the program
                    c1 = ops.launch_counts()["connmask"] - c0
                    check(c1 in (masks16, 2 * masks16),
                          f"{at}: the building call launched {c1} "
                          f"connmask, {masks16} or {2 * masks16} expected")
                    walls, above, peak = [], 0, 0
                    for _ in range(3):
                        held = {}
                        for d in devs:
                            torch.cuda.synchronize(d)
                            torch.cuda.reset_peak_memory_stats(d)
                            held[d] = torch.cuda.memory_allocated(d)
                        mark = engine.dispatch_mark()
                        c0 = ops.launch_counts()["connmask"]
                        t0 = time.perf_counter()
                        got = sharded_solve(cost, qq, cq, D)
                        for d in devs:
                            torch.cuda.synchronize(d)
                        walls.append(time.perf_counter() - t0)
                        c1 = ops.launch_counts()["connmask"] - c0
                        check(c1 == masks16,
                              f"{at}: a call launched {c1} connmask, "
                              f"{masks16} expected")
                        for d in devs:
                            p = torch.cuda.max_memory_allocated(d)
                            above = max(above, p - held[d])
                            peak = max(peak, p)
                        (rec,) = engine.dispatches_since(mark)
                        check(rec.shards == D and rec.devices == names,
                              f"{at}: record {rec}")
                        for label, want16 in (("unsharded fused", base),
                                              ("host pipeline",
                                               host[cost])):
                            if want16 is None:
                                continue
                            check([float(v).hex() for v in got[0]]
                                  == [float(v).hex() for v in want16[0]]
                                  and str(got[1]) == str(want16[1]),
                                  f"{at}: {got[0]} {got[1]} != {label} "
                                  f"{want16[0]} {want16[1]}")
                            if got[2] is not None:
                                check(got[2].tobytes()
                                      == want16[2].tobytes(),
                                      f"{at}: DP table != {label}")
                    if D == 1:
                        base = got
                    key16 = (mesh_kind, n, D)
                    peak16[key16] = max(peak16.get(key16, 0), above)
                    print(f"{at} ({','.join(names)}): median "
                          f"{statistics.median(walls):.4f} s per solve of "
                          f"{', '.join(f'{w:.4f}' for w in walls)}, peak "
                          f"device memory {peak / 2**20:.1f} MiB on a "
                          f"card, at most {above / 2**20:.1f} MiB above "
                          f"what it held before the solve; == unsharded "
                          f"fused and host pipeline {card}", flush=True)
    counts16 = ops.launch_counts()
    # the kernel tier's max solves launch zeta_cluster and ranked_conv;
    # the f64 tier's transforms at n = 15 (cap's pass 1) zeta_high too
    check(counts16["zeta_cluster"] > 0 and counts16["ranked_conv"] > 0,
          f"the sharded max solves launched {counts16}")
    print(f"sharded: max (kernel tier), cap, connected cap and out at "
          f"n = 14, 15 on {', '.join(f'{k} D = {w}' for k, _, w in meshes16)}"
          f" == the unsharded fused solve and the host pipelines in "
          f"{time.perf_counter() - t16:.2f} s; most device memory a solve "
          f"took above what a card held, per (mesh, n, D): "
          f"{ {k: round(v / 2**20, 1) for k, v in peak16.items()} } MiB; "
          f"launches {counts16} {card}", flush=True)

    mesh_mod.force_device_count(4)
    ops.reset_launch_counts()
    srv16 = PlanServer(batch_policy=BatchPolicy(solve_shards=4))
    cfg16 = srv16.router.config
    check((cfg16.fused_cap_max_n, cfg16.fused_out_max_n) == (15, 15)
          and srv16.solver._shards(15) == 4
          and srv16.solver._shards(13) == 1,
          f"solve_shards=4: ceilings {cfg16.fused_cap_max_n}/"
          f"{cfg16.fused_out_max_n}, shards {srv16.solver._shards(15)}")
    pw16 = srv16.prewarm(range(12, 16))
    mark = engine.dispatch_mark()
    t0 = time.perf_counter()
    resps16, _ = srv16.serve(list(stream), closed_loop=True)
    torch.cuda.synchronize()
    t_srv16 = time.perf_counter() - t0
    recs16 = engine.dispatches_since(mark)
    server16 = ops.launch_counts()
    same_as_plan_one("sharded server", stream, resps16, want)
    no_faults("sharded server", srv16.last_runtime)
    # phase 11's hyperedge chain(14) C_out request takes the single
    # lane's DPccp enumerator on every server, so it is left out here
    lanes16 = Counter(f"n={r.q.n} {r.cost} {resp.route.lane}"
                      for r, resp in zip(stream, resps16)
                      if r.q.n >= 14 and r.cost in ("cap", "out")
                      and not r.q.hyperedges)
    check(lanes16 and all(k.endswith(" batch") for k in lanes16),
          f"sharded server: n >= 14 cap/out lanes {dict(lanes16)}")
    big16 = [r for r in recs16 if r.n >= 14]
    check(big16 and all(r.shards == 4 for r in big16)
          and all(r.shards == 1 for r in recs16 if r.n < 14),
          "sharded server: records "
          f"{[(r.n, r.cost, r.shards) for r in recs16]}")
    mesh_mod.force_device_count(None)
    print(f"sharded server: solve_shards=4, ceilings cap "
          f"{cfg16.fused_cap_max_n} / out {cfg16.fused_out_max_n}, "
          f"prewarm {pw16['compiled']} programs in {pw16['seconds']:.2f} s; "
          f"{len(stream)} requests in {t_srv16:.4f} s, "
          f"{len(stream) / t_srv16:.2f} requests/s, every answer == "
          f"plan_one of an unsharded server; n >= 14 cap/out lanes "
          f"{dict(sorted(lanes16.items()))}; {len(big16)} of "
          f"{len(recs16)} dispatches on the 4-slot mesh; launches "
          f"{server16} {card}", flush=True)
    for r in rows:
        r["launches"] += counts16[r["name"]] + server16[r["name"]]
    for k in build.KERNELS:
        launches[k] += counts16[k] + server16[k]

    lm_serve_phase(dev, card)
    counts18, first18, tok_s18 = lm_train_phase(dev, card)
    counts19 = lm_dp_phase(card, first18, tok_s18)
    counts20 = lm_tp_phase(card)
    counts21 = lm_serve_tp_phase(card)
    lm_counts = (counts18, counts19, counts20, counts21)
    for r in rows:
        r["launches"] += sum(c.get(r["name"], 0) for c in lm_counts)
    for k in build.KERNELS:
        launches[k] += sum(c.get(k, 0) for c in lm_counts)

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
