"""Fault-tolerant training driver (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --batch 8 --seq 4096 --accum 2 --steps 6 [--data-mesh D]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 14 --batch 2 --seq 32 --ckpt-dir CKPT \\
        --ckpt-every 5 [--fail-at-step 9] [--resume] --device cpu \\
        [--data-mesh 2]

Trains on CUDA cards unless ``--device`` names another device (``cpu``,
or one card as ``cuda:k``), and raises without a card.

**The (D, T) mesh.**  As the reference's trainer, it trains on the host
mesh ('data', 'model') = (D, N // D) over N devices: ``--data-mesh D``
is the data axis, 0 (the default) takes D = N.  N is the visible cards
with ``--device cuda``; one card with ``cuda:k``; on the CPU, the count
``launch.mesh.force_device_count`` sets (the port's counterpart of XLA's
forced host device count), else D.  D must divide ``batch / accum`` (the
reference would replicate the batch there; ROADMAP queue 3).  With
``--data-mesh`` above 0, or more than one device, ``main`` spawns D·T
worker processes (start method ``spawn``, a ``FileStore`` rendezvous in
a temporary directory), one per rank of a process group: NCCL with rank
r on ``cuda:r``, gloo with ``--device cpu``.  There is no fallback: no
gloo on cards, no single process instead of D·T.  Each worker builds
``launch.mesh.make_host_mesh(D, T)`` (rank r at (r // T, r % T)) and
trains through ``train.dp.DataParallel`` over its 'data' group and
``train.tp.TensorParallel`` over its 'model' group: explicit collectives
over the port's parameter dicts (see ``train.dp`` for the step and why
not FSDP2, ``train.tp`` for the split math).  Each rank holds its block,
on both axes, of the float32 masters, both moments and the ef-sim
residual by ``models.sharding``'s rules, from the start: a fresh state
is drawn one leaf at a time and each rank keeps its block of each (the
blocks of the one-process draw with the same seed), so no rank ever
holds the whole state.  The ranks of one data index run the same 1/D of
every microbatch's rows, each its 1/T of the math; a leaf split over
'model' at rest but not in its math is gathered over 'model' before use
(``sharding.gathered_leaves``; the record lists them).  At T = 1 the
same code runs, every 'model' collective a copy.  A worker that fails
stops the others; ``main`` returns when all have ended.  Otherwise (the
default on one card or the CPU) it trains in this process, with no
process group.

  * checkpoint every k steps (atomic) + ``--resume`` picks up from the
    latest complete checkpoint; on a mesh rank 0 writes the state
    gathered to the host (the reference's files and keys) and every rank
    waits for the write, and on ``--resume`` every rank loads the whole
    file and keeps its blocks, so a run resumes at another (D, T);
  * ``--fail-at-step`` simulates a node failure (exit code 42, also of
    the launcher); a relaunch with ``--resume`` reproduces the same loss
    trajectory (deterministic data keyed by step — a restart-safe
    pipeline);
  * straggler watchdog: logs any step slower than ``straggler_factor`` ×
    the running median.
The batch goes to the device once per step; a step's time is taken on
the host clock and ends in the host read of its loss (a sync).  Only
rank 0 prints.

``main(argv, record=...)`` also hands a caller what the run made: pass a
dict and it receives the config, each step's metrics and time, ``D``
and ``T`` (``data_mesh``, ``model_mesh``), the gathered leaves
(``gathered``) and per rank (``ranks``) its mesh coordinates
(``coord``), the device memory held before the run (``held_bytes``),
the bytes of its masters and moments at rest (``state_bytes``), its
peak while the state was built (``init_peak_bytes``) and from the first
step on (``peak_bytes``), its own seconds in the 'data' and 'model'
collectives of the steps (``collective_s``, waits included), and the
kernel launch counts of its process at the end (``launches``; a worker
counts from 0).  On a mesh rank 0 sends it, and each step's metrics
also hold the 'data' collectives' seconds, ``collective_s`` and
``collective_rank0_s`` (``train.dp.DataParallel.collective_times``),
and the 'model' ones', ``model_collective_s`` and
``model_collective_rank0_s``; in this process it also holds the state,
the step function and the figures of its one rank at the top level.
"""
from __future__ import annotations

import argparse
import os
import pickle
import statistics
import sys
import tempfile
import time
from multiprocessing.connection import wait

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.kernels.build import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import forced_device_count
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

FAILURE_EXIT = 42          # --fail-at-step's simulated node failure


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data axis size (0 = all devices)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-pattern", default="random",
                    choices=["random", "cyclic"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda: every "
                         "visible card; cuda:k trains on card k alone)")
    return ap


def _mesh_shape(ap, args, dev: torch.device) -> tuple:
    """(D, T), the (D, devices // D) mesh; refuses what the port cannot
    run."""
    if dev.type == "cuda" and dev.index is None:
        ndev = torch.cuda.device_count()
    elif dev.type == "cpu":           # gloo processes
        ndev = forced_device_count() or max(args.data_mesh, 1)
    else:
        ndev = 1
    d = args.data_mesh or ndev
    if d < 1 or d > ndev:
        ap.error(f"--data-mesh {args.data_mesh}: {ndev} {dev} "
                 f"device(s) visible")
    if (args.batch // args.accum) % d:
        ap.error(f"--data-mesh {d} must divide batch / accum = "
                 f"{args.batch // args.accum}")
    return d, ndev // d


def main(argv=None, record: dict | None = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    d, t = _mesh_shape(ap, args, dev)
    if args.data_mesh == 0 and d * t == 1:
        _train(args, dev, record=record)
        return 0
    return _launch(args, (d, t), dev, record)


def _launch(args, shape: tuple, dev: torch.device, record,
            target=None) -> int:
    """D·T worker processes, one per rank, each running ``target(args,
    dev, record=..., mesh=...)`` (``_train`` by default; a module-level
    function, which the spawned processes import) on its rank of the
    (D, T) host mesh; returns when all have ended, with rank 0's record
    in ``record``."""
    ctx = torch.multiprocessing.get_context("spawn")
    world = shape[0] * shape[1]
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh-") as tmp:
        procs = [ctx.Process(target=_worker,
                             args=(r, shape, args, dev.type, tmp,
                                   torch.get_num_threads(),
                                   target or _train))
                 for r in range(world)]
        for p in procs:
            p.start()
        code = _wait(procs)
        out = os.path.join(tmp, "record.pkl")
        if code == 0 and record is not None:
            with open(out, "rb") as f:
                record.update(pickle.load(f))
    if code == FAILURE_EXIT:
        sys.exit(FAILURE_EXIT)
    if code:
        raise RuntimeError(f"a worker process exited with {code}")
    return 0


def _wait(procs) -> int:
    """Waits for every worker; the first nonzero exit code stops the
    others (they would wait for it in a collective) and is returned."""
    pending, code = list(procs), 0
    while pending:
        ready = wait([p.sentinel for p in pending])
        for p in [p for p in pending if p.sentinel in ready]:
            p.join()
            pending.remove(p)
            if p.exitcode and not code:
                code = p.exitcode
                for q in pending:
                    q.terminate()
    return code


def _worker(rank: int, shape: tuple, args, device_type: str, tmp: str,
            threads: int, target) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    world = shape[0] * shape[1]
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device(device_type)
        torch.set_num_threads(max(1, threads // world))
        backend = "gloo"
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world,
        device_id=dev if device_type == "cuda" else None)
    try:
        rec = {}
        reset_launch_counts()
        target(args, dev, record=rec, mesh=make_host_mesh(*shape))
        if rank == 0:
            part = os.path.join(tmp, "record.pkl.tmp")
            with open(part, "wb") as f:
                pickle.dump(rec, f)
            os.replace(part, os.path.join(tmp, "record.pkl"))
    finally:
        dist.destroy_process_group()


def _rank_rows(batch: dict, accum: int, rank: int, world: int) -> dict:
    """This rank's rows of each microbatch, microbatch by microbatch:
    rows [i·mb + r·mb/D, i·mb + (r+1)·mb/D) of microbatch i."""
    mb = batch["tokens"].shape[0] // accum
    per = mb // world
    rows = np.concatenate([np.arange(i * mb + rank * per,
                                     i * mb + (rank + 1) * per)
                           for i in range(accum)])
    return {k: v[rows] for k, v in batch.items()}


def _save(state, dp, ckpt_dir: str, step: int) -> None:
    if dp is None:
        ckpt_lib.save(state, ckpt_dir, step)
        return
    whole = dp.gather_state(state)
    if whole is not None:               # rank 0 of the mesh
        ckpt_lib.save(whole, ckpt_dir, step)
    dp.barrier()


def _train(args, dev: torch.device, record=None, mesh=None) -> None:
    """The training loop of one process: alone, or one rank of
    ``mesh``'s process group."""
    cuda = dev.type == "cuda"
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps,
                        grad_dtype=args.grad_dtype)
    ef = args.grad_dtype == "bfloat16"
    if cuda:
        torch.cuda.synchronize(dev)        # initialises CUDA, if not yet
        torch.cuda.reset_peak_memory_stats(dev)
    dp = tp = keep = None
    if mesh is not None:
        from repro_torch.models.transformer import init_params
        from repro_torch.train.dp import keep_blocks
        from repro_torch.train.tp import mesh_layout
        dp, tp = mesh_layout(cfg, mesh, dev)
        keep = keep_blocks(init_params(cfg, device="meta"), dp.placements,
                           dp.coord, dp.shape)
    state = init_train_state(cfg, opt_cfg, seed=args.seed,
                             error_feedback_state=ef, device=dev, keep=keep)
    init_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    rank = 0 if dp is None else torch.distributed.get_rank()

    start_step = 0
    if args.resume and args.ckpt_dir:
        try:
            if dp is None:
                state, start_step = ckpt_lib.load(state, args.ckpt_dir)
            else:
                whole = init_train_state(cfg, opt_cfg,
                                         error_feedback_state=ef,
                                         device="meta")
                whole, start_step = ckpt_lib.load(whole, args.ckpt_dir,
                                                  device="cpu")
                state = dp.shard_state(whole)
                del whole
            if rank == 0:
                print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            if rank == 0:
                print("[train] no checkpoint found — fresh start")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      pattern=args.data_pattern)
    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum,
                              loss_chunk=min(2048, args.batch * args.seq),
                              dp=dp, tp=tp)

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    times: list = []
    history: list = []
    own = {"data": 0.0, "model": 0.0}   # this rank's collective seconds
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            if rank == 0:
                print(f"[train] SIMULATED NODE FAILURE at step {step}",
                      flush=True)
            sys.exit(FAILURE_EXIT)
        batch = batch_at(dcfg, step)
        if dp is not None:
            batch = _rank_rows(batch, args.accum, dp.rank, dp.world)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        times.append(dt)
        history.append({"step": step, "loss": loss,
                        **{k: float(metrics[k])
                           for k in ("ce", "aux", "grad_norm", "lr")}})
        if dp is not None:
            for axis, c in (("data", dp), ("model", tp)):
                got = c.collective_times()
                own[axis] += got.pop("own_s")
                history[-1].update({("" if axis == "data" else "model_")
                                    + k: v for k, v in got.items()})
        if len(times) > 5:
            med = statistics.median(times[1:])
            if dt > args.straggler_factor * med and rank == 0:
                print(f"[train] STRAGGLER step {step}: {dt:.2f}s "
                      f"(median {med:.2f}s)", flush=True)
        if rank == 0 and (step % args.log_every == 0
                          or step == args.steps - 1):
            tok_s = args.batch * args.seq / dt
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {history[-1]['ce']:.4f} "
                  f"gnorm {history[-1]['grad_norm']:.3f} "
                  f"{tok_s:,.0f} tok/s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(state, dp, args.ckpt_dir, step + 1)
    if args.ckpt_dir:
        _save(state, dp, args.ckpt_dir, args.steps)
    if rank == 0:
        print("[train] done")
    if record is None:
        return
    mine = {"coord": (0, 0) if dp is None else dp.coord,
            "held_bytes": held,
            "state_bytes": _nbytes(state["params"]) + _nbytes(
                [state["opt"]["mu"], state["opt"]["nu"]]),
            "init_peak_bytes": init_peak,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if cuda else None),
            "collective_s": own,
            "launches": launch_counts()}
    record.update(cfg=cfg, opt_cfg=opt_cfg, data_cfg=dcfg, times=times,
                  history=history, data_mesh=1 if dp is None else dp.world,
                  model_mesh=1 if tp is None else tp.world)
    if dp is None:
        record.update(state=state, step_fn=step_fn, ranks=[mine],
                      gathered=[], **mine)
    else:
        import torch.distributed as dist
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        record.update(ranks=ranks, gathered=tp.gathered)


if __name__ == "__main__":
    sys.exit(main())
