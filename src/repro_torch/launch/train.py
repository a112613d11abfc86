"""Fault-tolerant training driver (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --batch 8 --seq 4096 --accum 2 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 14 --batch 2 --seq 32 --ckpt-dir CKPT \\
        --ckpt-every 5 [--fail-at-step 9] [--resume] --device cpu

Trains on one device: the CUDA card unless ``--device`` names another,
and it raises without a card.  ``--data-mesh`` above 1 is refused; the
LM meshes and multi-card data parallelism are not ported yet.
  * checkpoint every k steps (atomic) + ``--resume`` picks up from the
    latest complete checkpoint;
  * ``--fail-at-step`` simulates a node failure (exit code 42); a
    relaunch with ``--resume`` reproduces the same loss trajectory
    (deterministic data keyed by step — a restart-safe pipeline);
  * straggler watchdog: logs any step slower than ``straggler_factor`` ×
    the running median.
The batch goes to the device once per step; a step's time is taken on
the host clock and ends in the host read of its loss (a sync).

``main(argv, record=...)`` also hands a caller what the run made: pass a
dict and it receives the config, the state, the step function, each
step's metrics and time, and the memory figures (the device memory held
before the run, the bytes of the masters and moments, and the peak from
the first step on).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import tree_leaves


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


def main(argv=None, record: dict | None = None) -> int:
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
                    help="data axis size; the port trains on one device "
                         "(0 or 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-pattern", default="random",
                    choices=["random", "cyclic"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    if args.data_mesh not in (0, 1):
        ap.error(f"--data-mesh {args.data_mesh}: the port trains on one "
                 "device; the LM meshes and multi-card data parallelism "
                 "come with ROADMAP queue 1 item 7c")

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps,
                        grad_dtype=args.grad_dtype)
    state = init_train_state(
        cfg, opt_cfg, seed=args.seed,
        error_feedback_state=(args.grad_dtype == "bfloat16"), device=dev)

    start_step = 0
    if args.resume and args.ckpt_dir:
        try:
            state, start_step = ckpt_lib.load(state, args.ckpt_dir)
            print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            print("[train] no checkpoint found — fresh start")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      pattern=args.data_pattern)
    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum,
                              loss_chunk=min(2048, args.batch * args.seq))

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    times: list = []
    history: list = []
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            print(f"[train] SIMULATED NODE FAILURE at step {step}",
                  flush=True)
            sys.exit(42)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_at(dcfg, step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        times.append(dt)
        history.append({"step": step, "loss": loss,
                        **{k: float(metrics[k])
                           for k in ("ce", "aux", "grad_norm", "lr")}})
        if len(times) > 5:
            med = statistics.median(times[1:])
            if dt > args.straggler_factor * med:
                print(f"[train] STRAGGLER step {step}: {dt:.2f}s "
                      f"(median {med:.2f}s)", flush=True)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / dt
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {history[-1]['ce']:.4f} "
                  f"gnorm {history[-1]['grad_norm']:.3f} "
                  f"{tok_s:,.0f} tok/s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(state, args.ckpt_dir, step + 1)
    if args.ckpt_dir:
        ckpt_lib.save(state, args.ckpt_dir, args.steps)
    print("[train] done")
    if record is not None:
        record.update(
            cfg=cfg, opt_cfg=opt_cfg, data_cfg=dcfg, state=state,
            step_fn=step_fn, times=times, history=history,
            held_bytes=held,
            state_bytes=_nbytes(state["params"]) + _nbytes(
                [state["opt"]["mu"], state["opt"]["nu"]]),
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if cuda else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
