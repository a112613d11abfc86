#!/usr/bin/env python3
"""Time one zeta transform of the port on one card, for any tree of it.

    python3 scripts/bench_zeta.py [--src DIR/src] [--label NAME] [--out F]
                                  [--dtype int32|float64]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so an unpacked older commit and this one can be timed in one
call, in turns.  For int32 tables of (16, 2^15) and (16, 16, 2^15) —
the int32 lane's shapes — and (8, 2^20), or with ``--dtype float64``
tables of (1, 2^16..2^19) and (16, 2^13) — the float64 tier's (a large
clique's search, C_cap's pass 1 on a batch) — it prints, per transform
through ``kernels.ops.zeta_op``:

* device time, warm and with L2 cold (a 64 MB write before each call):
  torch.profiler's self device time of the port's zeta kernels, and the
  launches per transform;
* a copy of the same table (``Tensor.copy_``, a device-to-device
  memcpy), warm and cold: what one pass over the table costs on this
  card;
* the host-launched call: CUDA events around 50 calls from Python;
* the host's cost per call: perf_counter over 1000 calls, no sync;
* the bound: the bytes of the tree's launch plan over 3.35 TB/s (the
  low-bit launch reads and writes the table; a launch over b high bits
  reads it and writes 1 - 2^-b of it);
* the plain version (``kernels.ref.zeta_ref``: ``core.zeta``'s
  butterfly, one strided PyTorch add per bit after a copy) on the same
  table: device time, warm and cold (every device op of the call), and
  the host-launched call.

Then the high bits alone, in place, as the tree's plan launches them
(``zeta_high`` chunks, or one ``zeta_pair`` launch per bit in trees
before it): bit 15 of (8, 2^16) and bits 15..19 of (8, 2^20) (float64:
bits 14..15 of (1, 2^16) and 14..18 of (1, 2^19)), with the same times,
the bound of one launch over those bits and that of the tree's launches.
A tree whose kernels refuse float64 gets the plain version's numbers
alone.

Uses the timing helpers of ``chip_smoke.py``.  Needs a card; imports
nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="append the numbers to this JSON-lines "
                                  "file")
    ap.add_argument("--dtype", choices=["int32", "float64"],
                    default="int32")
    args = ap.parse_args()
    smoke = _smoke()
    # the smoke module put this checkout's src first and imported its
    # repro_torch: forget both, so that --src decides what is timed
    sys.path.remove(str(ROOT / "src"))
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 1
    from repro_torch.kernels import build, ops
    check = Path(build.__file__).resolve()
    if not check.is_relative_to(Path(args.src).resolve()):
        print(f"FAIL: imported {check}, not from {args.src}")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
    scratch = torch.empty(16 << 20, dtype=torch.int32, device=dev)
    flush = lambda: scratch.fill_(1)               # noqa: E731
    from repro_torch.kernels import ref, zeta_cuda
    own = ("zeta_local_kernel", "zeta_pair_kernel", "zeta_cluster_kernel",
           "zeta_high_kernel")
    copy = ("Memcpy DtoD",)
    dtype = {"int32": np.int32, "float64": np.float64}[args.dtype]
    esize = np.dtype(dtype).itemsize
    try:
        build.dtype_code(torch.zeros(1, dtype=getattr(torch, args.dtype)))
        kernels = True
    except TypeError:                   # a tree before float64 kernels
        kernels = False

    def plan_of(n):
        """The tree's launch plan (trees before float64 take n alone)."""
        if esize == 4:
            return zeta_cuda.launch_plan(n)
        return zeta_cuda.launch_plan(n, esize) if kernels else ()

    def launch_bytes(total, lo, hi):
        e = esize * total
        return e + e - (e >> (hi - lo))

    def plan_bound(plan, total):
        nbytes = sum(2 * esize * total if k == "zeta_cluster"
                     else launch_bytes(total, lo, hi) for k, lo, hi in plan)
        return smoke.bound(nbytes, 0)[0]

    def all_device_ms(fn, between=None, iters=200):
        """Device ms per call of every device op ``fn`` makes (the plain
        version's copy and adds), less ``between``'s."""
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
        us = sum(smoke._device_us(e) for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA)
        if between is not None:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    between()
                torch.cuda.synchronize()
            us -= sum(smoke._device_us(e) for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA)
        return us * 1e-3 / iters

    def table(shape):
        if dtype == np.int32:
            a = rng.integers(0, 2, shape).astype(np.int32)
        else:
            a = rng.integers(0, 1 << 20, shape).astype(np.float64)
        return torch.from_numpy(a).to(dev)

    def high(x, lo, hi):
        """The tree's launches of bits lo..hi-1, in place."""
        if hasattr(zeta_cuda, "launch_high"):
            return lambda: zeta_cuda.launch_high(x, lo, hi, 1)
        return lambda: [zeta_cuda.launch_pair(x, j, 1)
                        for j in range(lo, hi)]

    def timed(fn, shape, per, **rec):
        rec = {"label": args.label, "card": smi, "dtype": args.dtype,
               "shape": list(shape), **rec}
        if kernels:
            warm, _ = smoke.device_ms(fn, own, per)
            cold, _ = smoke.device_ms(fn, own, per, between=flush)
            rec.update(device_ms_warm=warm, device_ms_cold=cold,
                       launches_per_call=per,
                       host_call_ms=smoke.time_ms(fn),
                       host_us_per_call=smoke.host_us(fn))
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    lines = []
    shapes = ([(16, 1 << 15), (16, 16, 1 << 15), (8, 1 << 20)]
              if dtype == np.int32 else
              [(1, 1 << n) for n in range(16, 20)] + [(16, 1 << 13)])
    for shape in shapes:
        x = table(shape)
        y = torch.empty_like(x)
        cp = lambda: y.copy_(x)                    # noqa: E731
        cp_warm, _ = smoke.device_ms(cp, copy)
        cp_cold, _ = smoke.device_ms(cp, copy, between=flush)
        plain = lambda: ref.zeta_ref(x, out=y)     # noqa: E731
        n = shape[-1].bit_length() - 1
        plan = plan_of(n)
        timed(lambda: ops.zeta_op(x, out=y), shape, len(plan),
              what="transform",
              copy_ms_warm=cp_warm, copy_ms_cold=cp_cold,
              bound_ms=plan_bound(plan, x.numel()),
              plain_device_ms_warm=all_device_ms(plain),
              plain_device_ms_cold=all_device_ms(plain, between=flush),
              plain_host_call_ms=smoke.time_ms(plain))
    highs = ([((8, 1 << 16), 15, 16), ((8, 1 << 20), 15, 20)]
             if dtype == np.int32 else
             [((1, 1 << 16), 14, 16), ((1, 1 << 19), 14, 19)])
    for shape, lo, hi in highs:
        x = table(shape)
        n = shape[-1].bit_length() - 1
        plan = plan_of(n)[1:]                   # the high bits, from lo
        timed(high(x, lo, hi), shape, len(plan),
              what=f"bits {lo}..{hi - 1}",
              bound_ms=smoke.bound(launch_bytes(x.numel(), lo, hi), 0)[0],
              plan_bound_ms=plan_bound(plan, x.numel()))
    if args.out:
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
