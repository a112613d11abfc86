"""Batched LM serving driver (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --batch 4 --prompt-len 32 --gen 32 --device cpu

Static-batch engine with per-request state: each slot holds its own
position; prompts are consumed through the decode path (prefill ==
teacher forcing), then tokens are chosen greedily.  Runs on the CUDA
card unless ``--device`` names another device, and raises without one.
The decode step runs eagerly, one PyTorch call after another.

``main(argv, record=...)`` also hands a caller what the run made: pass a
dict and it receives the model, the cache, the step, the tokens fed at
each position, the timings and the memory figures (the device memory
held before the run, the weights, the cast weights, the cache and the
peak from the first decode step on), and, with
``record["logits"] = True``, the decode logits of every position as one
(B, prompt_len + gen, padded_vocab) tensor in the compute dtype.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.train.steps import make_decode_step


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, record: dict | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    rng = np.random.default_rng(args.seed)
    B = args.batch
    max_seq = args.prompt_len + args.gen

    model = tfm.LM(cfg, tfm.init_params(cfg, seed=args.seed, device=dev))
    cache = tfm.init_cache(cfg, B, max_seq=max_seq, device=dev)
    if cfg.family == "encdec":
        frames = torch.as_tensor(
            rng.normal(size=(B, cfg.n_frames, cfg.d_model)),
            device=dev).to(cfg.cdtype)
        with torch.no_grad():
            enc_out, _ = tfm.encode(model, cfg, frames)
            tfm.build_cross_cache(model, cfg, enc_out, cache)

    step = make_decode_step(cfg)
    prompts = rng.integers(0, cfg.vocab_size, (B, args.prompt_len))
    fed = torch.zeros((B, max_seq), dtype=torch.int64, device=dev)
    fed[:, :args.prompt_len] = torch.as_tensor(prompts, device=dev)
    keep = None
    if record is not None and record.get("logits"):
        keep = torch.empty((B, max_seq, cfg.padded_vocab),
                           dtype=cfg.cdtype, device=dev)
    out_tokens = [[] for _ in range(B)]

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(args.prompt_len):            # prefill via decode path
        logits, cache = step(model, cache, fed[:, i],
                             torch.full((B,), i, device=dev))
        if keep is not None:
            keep[:, i] = logits
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    for i in range(args.gen):
        p = args.prompt_len + i
        for b, t in enumerate(tok.tolist()):
            out_tokens[b].append(t)
        fed[:, p] = tok
        logits, cache = step(model, cache, tok,
                             torch.full((B,), p, device=dev))
        if keep is not None:
            keep[:, p] = logits
        tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t_gen = time.perf_counter() - t0

    print(f"[serve] {cfg.name} on {dev}: batch {B}, prefill "
          f"{args.prompt_len} tok in {t_prefill:.2f}s, generated "
          f"{args.gen} tok/slot in {t_gen:.2f}s "
          f"({B * args.gen / max(t_gen, 1e-9):,.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  slot {b}: {out_tokens[b][:16]} ...")
    if record is not None:
        master = _nbytes(model.params())         # float32 leaves
        cast = (master * cfg.cdtype.itemsize // 4
                if cfg.cdtype != torch.float32 else 0)
        record.update(
            cfg=cfg, model=model, cache=cache, step=step,
            tokens=fed, out_tokens=out_tokens, logits=keep,
            t_prefill=t_prefill, t_gen=t_gen,
            weights_bytes=master, cast_bytes=cast,
            cache_bytes=_nbytes(cache), held_bytes=held,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
