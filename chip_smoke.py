#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. card      — name, count, and ``nvidia-smi`` name and power limit;
2. build     — ``nvcc`` builds every kernel of ``src/repro_torch/csrc``;
3. zeta      — each zeta/Moebius kernel launch against its plain
               PyTorch version on the card, bitwise (int32 and f32);
4. conv      — the ranked-convolution kernel against its plain version;
5. fused     — the DPconv[max] batch lane (``BatchedSolver``, default
               policy: fused engine, int32 kernel tier for n = 12..15) on
               16 paper Sec. 9 clique(15) queries plus chain/star/cycle
               at n = 12..15 and one clique(12); optima and trees equal
               the f64 tier's, the clique(12) optimum equals the O(3^n)
               oracle;
6. host      — the same lane on the host engine (n = 13, B = 4), where
               the ranked-convolution kernel runs; optima equal the f64
               tier's;
7. large     — 4 clique(18) queries, above the int32 envelope: ``auto``
               takes the f64 tier and launches no kernel;
8. times     — each kernel at the path's shapes beside its bound and its
               plain version, launches per solve, solved queries per
               second.

Launch counters are set to 0 just before each main-path phase (5, 6) and
read just after.  Data comes from fixed seeds through numpy.  The
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
TILE_BITS = 12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, between CUDA events after warm-up."""
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
        from repro_torch.core import engine, querygraph as qg
        from repro_torch.core.dpconv_max import dpconv_max_ref
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.ranked_conv import ranked_conv_cuda
        from repro_torch.kernels.zeta_cuda import launch_local, launch_pair
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
    shapes = [(16, 1 << 15), (16, 16, 1 << 15), (1 << 12,), (3, 1 << 5)]
    for shape in shapes:
        n = shape[-1].bit_length() - 1
        x = on_card(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                    .astype(np.int32))
        for sign in (1, -1):
            b = min(n, TILE_BITS)
            out = torch.empty_like(x)
            launch_local(x, out, b, sign)
            ok = record("zeta_local", out, ref.zeta_stages_ref(x, sign, 0, b))
            check(ok, f"zeta_local int32 {shape} sign {sign}")
            for j in range(b, n):
                y = x.clone()
                launch_pair(y, j, sign)
                ok = record("zeta_pair", y,
                            ref.zeta_stages_ref(x, sign, j, j + 1))
                check(ok, f"zeta_pair int32 {shape} bit {j} sign {sign}")
            full = ops.zeta_op(x, inverse=sign < 0)
            want = ref.mobius_ref(x) if sign < 0 else ref.zeta_ref(x)
            check(torch.equal(full, want), f"zeta_op int32 {shape} {sign}")
        check(torch.equal(ops.mobius_op(ops.zeta_op(x)), x),
              f"mobius(zeta(x)) != x on {shape}")
        # f32 on integer values below 2^24: exact, so bitwise
        xf = on_card(rng.integers(-8, 9, shape).astype(np.float32))
        for sign in (1, -1):
            got = ops.zeta_op(xf, inverse=sign < 0)
            want = ref.mobius_ref(xf) if sign < 0 else ref.zeta_ref(xf)
            check(torch.equal(got, want), f"zeta_op f32 {shape} {sign}")
        check(torch.equal(ops.mobius_op(ops.zeta_op(xf)), xf),
              f"f32 mobius(zeta(x)) != x on {shape}")
    torch.cuda.synchronize()
    print(f"zeta: kernels == plain versions, bitwise, on {shapes}, both "
          f"signs, int32 and f32; mobius(zeta(x)) == x", flush=True)

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
    engine.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = lane.solve(items)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    counts5 = ops.launch_counts()
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
    check(counts5["zeta_local"] > 0 and counts5["zeta_pair"] > 0,
          f"the fused lane launched no zeta kernel: {counts5}")
    qps5 = len(items) / t_fused
    print(f"fused: {len(items)} queries in {chunks5} chunks, {rounds5} "
          f"search rounds, {t_fused:.4f} s, {qps5:.2f} queries/s, launches "
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
    check(all(v > 0 for v in counts6.values()),
          f"the host lane did not launch every kernel: {counts6}")
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

    # ----------------------------------------------------------- 8. times
    x = on_card(rng.integers(0, 2, (16, 1 << 15)).astype(np.int32))
    total = x.numel()
    out = torch.empty_like(x)
    rows = []

    def row(kernel, source, replaces, ms, plain_ms, nbytes, nops, launches):
        b_ms, b_by = bound(nbytes, nops)
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err[kernel], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        print(f"time {kernel}: {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}) {card}", flush=True)

    launches = {k: counts5[k] + counts6[k] for k in build.KERNELS}
    row("zeta_local", "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:53",
        time_ms(lambda: launch_local(x, out, TILE_BITS, 1)),
        time_ms(lambda: ref.zeta_stages_ref(x, 1, 0, TILE_BITS)),
        8 * total, total // 2 * TILE_BITS, launches["zeta_local"])
    row("zeta_pair", "src/repro_torch/csrc/zeta.cu",
        "src/repro/kernels/zeta_pallas.py:103",
        time_ms(lambda: launch_pair(out, 13, 1)),
        time_ms(lambda: ref.zeta_stages_ref(x, 1, 13, 14)),
        4 * total + 4 * total // 2, total // 2, launches["zeta_pair"])
    k = 8
    rest = Z[0].numel()
    row("ranked_conv", "src/repro_torch/csrc/ranked_conv.cu",
        "src/repro/kernels/ranked_conv.py:31",
        time_ms(lambda: ranked_conv_cuda(Z, k)),
        time_ms(lambda: ref.ranked_conv_ref(Z, k)),
        4 * rest * (k - 1) + 4 * rest, rest * k, launches["ranked_conv"])
    for shape in [(16, 1 << 15), (16, 16, 1 << 15)]:
        xt = on_card(rng.integers(0, 2, shape).astype(np.int32))
        ms = time_ms(lambda: ops.zeta_op(xt))
        plain = time_ms(lambda: ref.zeta_ref(xt))
        b_ms, _ = bound(8 * xt.numel(), xt.numel() // 2 * 15)
        print(f"time zeta transform {shape}: {ms:.5f} ms (1 local + 3 pair "
              f"launches), plain {plain:.5f} ms, bound {b_ms:.5f} ms "
              f"{card}", flush=True)
    print(f"launches per solve: fused lane "
          f"{ {k: v / chunks5 for k, v in counts5.items()} } over "
          f"{chunks5} chunk solves; host lane {counts6} over 1 solve",
          flush=True)
    print(f"throughput: fused lane (phase 5) {qps5:.3f} queries/s, f64 "
          f"tier n=18 (phase 7) {qps7:.4f} queries/s {card}", flush=True)

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
