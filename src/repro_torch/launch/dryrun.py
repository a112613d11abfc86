"""The multi-pod dry-run (counterpart of ``repro.launch.dryrun``).

For every (architecture × shape × mesh) cell, in one process on the
``meta`` device:
    join a fake process group of the production mesh's size (256 or 512)
        as rank 0, and build the mesh (``launch.mesh.make_production_mesh``)
    build rank 0's arguments at their local shapes (``specs.build_cell``)
    run the step once, recording every collective
        (``train.dp.CollectiveLog``) and counting the matrix FLOPs
        (``torch.utils.flop_counter.FlopCounterMode``)
plus the roofline terms of ``launch.costmodel.roofline_terms`` (H100
constants).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]

Results are written as JSON per cell (``<arch>__<shape>__<mesh>.json``)
under ``--out`` (``dryrun_out/`` by default).  The fake process group
(``torch.testing._internal.distributed.fake_pg``) is imported by
``run_cell`` only, never when the package is imported.

Fields, with the reference's names where the meaning carries over:
``status``, ``n_chips``, ``model_flops``, ``hlo_flops``/``hlo_bytes``
(the analytic model's FLOPs and HBM bytes of the whole step, as in the
reference), ``useful_flop_frac``, ``collectives`` (per kind, count and
result bytes of rank 0's step; the reference parses them from the
post-SPMD HLO), ``avg_group``, ``coll_bytes`` (the model's), ``accum``,
``params``, ``active_params``, ``t_compute``/``t_memory``/
``t_collective``, ``roofline_frac``, ``mfu_bound``, ``bottleneck``,
``opts``.  The port's own: ``traced_flops`` (rank 0's counted FLOPs
times ``n_chips``: the whole step's, as every rank runs rank 0's
shapes), ``link_traffic_bytes`` (``hlo_parse.link_traffic_bytes`` of
rank 0's collectives, groups of 8 by default), ``bytes_at_rest_per_device``
(rank 0's arguments as the reference places them: parameter, moment
and cache blocks, its rows), ``trace_s`` (building and running the
cell); a serve cell also has ``load_collectives``, the gathers that make
its serving leaves once.  ``--all`` ends with a ``summary`` of the out
directory: statuses, summed ``trace_s``, and ``traced_flops /
hlo_flops`` per architecture family and shape.  No counterpart, and so absent: ``lower_s``,
``compile_s``, ``xla_flops_loops_once``, ``xla_bytes_loops_once``
(there is no compiled program: ``trace_s`` and ``traced_flops`` stand
in), ``mem_*`` (XLA's ``memory_analysis`` of the compiled program) and
``hlo_link_traffic_bytes_loops_once`` (``link_traffic_bytes`` counts
every collective of the step, loops unrolled).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch import costmodel
from repro_torch.launch.hlo_parse import link_traffic_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (ServeCell, accum_for, build_cell,
                                      cache_bytes_at_rest)
from repro_torch.tree import tree_leaves

OUT = "dryrun_out"
MODEL_GROUP = 8             # 'model' of the production meshes


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per step: 6·N·D train (N = active params for MoE),
    2·N·tokens for inference — matmul-parameter convention."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch
    return 2.0 * n_act * shape.global_batch          # decode: 1 token/seq


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


def _coll(log) -> dict:
    stats = log.stats()
    return {k: v for k, v in stats.items() if not k.startswith("_")}, stats


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, opts: dict | None = None) -> dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train.dp import CollectiveLog

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    multi = mesh_kind == "multipod"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    t0 = time.perf_counter()
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        n_chips = mesh.size()
        log = CollectiveLog()
        fn, args, _ = build_cell(cfg, shape, mesh, opts=opts, log=log)
        rest = _nbytes(args)
        if shape.kind == "decode":      # the cache as the rules place it
            rest += cache_bytes_at_rest(cfg, mesh, shape.global_batch,
                                        shape.seq_len) - _nbytes(args[1])
        load = None
        with torch.no_grad():
            if isinstance(fn, ServeCell):
                loaded = fn.load(args[0])
                load, _ = _coll(log)
                log.entries = []
        with FlopCounterMode(display=False) as counter:
            if isinstance(fn, ServeCell):
                fn.step(loaded, *args[1:])
            else:
                fn(*args)
        trace_s = time.perf_counter() - t0
    except Exception as e:  # a failure here is a bug in the system
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    finally:
        dist.destroy_process_group()

    coll, stats = _coll(log)
    mf = model_flops(cfg, shape)
    rf = costmodel.roofline_terms(cfg, shape, n_chips=n_chips,
                                  tp=MODEL_GROUP, opts=opts)
    traced = float(counter.get_total_flops()) * n_chips
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "n_chips": n_chips,
        "trace_s": round(trace_s, 2),
        "model_flops": mf,
        "hlo_flops": rf["flops"], "hlo_bytes": rf["hbm_bytes"],
        "traced_flops": traced,
        "useful_flop_frac": (mf / rf["flops"]) if rf["flops"] else None,
        "collectives": coll,
        "avg_group": stats.get("_avg_group", 0),
        "link_traffic_bytes": link_traffic_bytes(
            stats, default_group=MODEL_GROUP),
        "coll_bytes": rf["coll_bytes"],
        "accum": accum_for(cfg, shape),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "bytes_at_rest_per_device": rest,
        # roofline terms in seconds (analytic model, per chip)
        "t_compute": rf["t_compute"],
        "t_memory": rf["t_memory"],
        "t_collective": rf["t_collective"],
        "roofline_frac": rf["roofline_frac"],
        "mfu_bound": rf["mfu_bound"],
        "opts": opts or {},
    }
    if load is not None:
        result["load_collectives"] = load
    result["bottleneck"] = rf["bottleneck"]
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: "
              f"traced {trace_s:.1f}s flops {rf['flops']:.3e} (traced "
              f"{traced:.3e}) bytes {rf['hbm_bytes']:.3e} coll "
              f"{rf['coll_bytes']:.3e} -> {result['bottleneck']}"
              f"-bound frac {rf['roofline_frac']:.2f}; at rest "
              f"{rest / 1e9:.2f}GB a device", flush=True)
    return result


def summary(out: str) -> dict:
    """The cells written under ``out``: their count per status, their
    summed ``trace_s``, and per (architecture family, shape) the range of
    ``traced_flops / hlo_flops`` over the architectures and meshes."""
    status: dict = {}
    trace_s, ratio = 0.0, {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            res = json.load(f)
        status[res["status"]] = status.get(res["status"], 0) + 1
        if res["status"] != "ok":
            continue
        trace_s += res["trace_s"]
        key = f"{get_config(res['arch']).family} {res['shape']}"
        r = res["traced_flops"] / res["hlo_flops"]
        lo, hi = ratio.get(key, (r, r))
        ratio[key] = (min(lo, r), max(hi, r))
    return {"status": status, "trace_s": round(trace_s, 1),
            "traced_over_hlo_flops": {k: (round(lo, 3), round(hi, 3))
                                      for k, (lo, hi) in
                                      sorted(ratio.items())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="§Perf configuration: zigzag causal attention + "
                         "dots remat (write to a separate --out dir!)")
    args = ap.parse_args(argv)
    opts = ({"attn_scheme": "zigzag", "remat": "dots"}
            if args.optimized else None)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                for mesh in ("pod", "multipod"):
                    cells.append((arch, shape, mesh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape, args.mesh))

    n_err = 0
    for arch, shape, mesh in cells:
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    continue
        res = run_cell(arch, shape, mesh, opts=opts)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        if res["status"] == "error":
            n_err += 1
            print(f"[dryrun] ERROR {arch} x {shape} x {mesh}: "
                  f"{res['error']}", flush=True)
    print(f"[dryrun] finished: {len(cells)} cells, {n_err} errors",
          flush=True)
    if args.all:
        print(f"[dryrun] {args.out}: {json.dumps(summary(args.out))}",
              flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
