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

``serve_on_mesh`` runs the same loop split over a ('data', 'model') =
(D, T) host mesh, with no CLI flag (the reference's ``launch.serve`` has
no mesh): D·T spawned ranks (``launch.train``'s spawn and ``FileStore``
rendezvous; NCCL with rank r on ``cuda:r``, gloo on the CPU), each
holding its rows of the batch and its part of the model
(``train.tp``'s "Serving"), and the whole loop in this process without
a mesh, for comparison.  There is no fallback: on ``cuda`` a mesh of
more ranks than visible cards raises.

``main`` runs the loop of ``serve_rank`` without a mesh.
``main(argv, record=...)`` also hands a caller what the run made: pass a
dict and it receives ``serve_rank``'s record (the parameters, the cache,
the step, the tokens fed at each position, the timings and, under
``ranks``, the memory figures), and, with ``record["logits"] = True``,
the decode logits of every position as one (B, prompt_len + gen,
padded_vocab) tensor in the compute dtype and ``make_prefill_step``'s
over the same tokens.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.device import resolve_device
from repro_torch.launch.specs import cache_bytes_at_rest
from repro_torch.models.common import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.train.steps import make_decode_step, make_prefill_step


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
    flags = ap.parse_args(argv)

    dev = resolve_device(flags.device)
    cfg = get_config(flags.arch)
    if flags.reduced:
        cfg = make_reduced(cfg)
    want = record is not None and record.get("logits")
    args = serve_args(cfg, batch=flags.batch, prompt_len=flags.prompt_len,
                      gen=flags.gen, keep=None if want else [])
    args.seed = flags.seed
    rec: dict = {}
    serve_rank(args, dev, rec)
    B, G = flags.batch, flags.gen
    print(f"[serve] {cfg.name} on {dev}: batch {B}, prefill "
          f"{flags.prompt_len} tok in {rec['t_prompt']:.2f}s, generated "
          f"{G} tok/slot in {rec['t_gen']:.2f}s "
          f"({B * G / max(rec['t_gen'], 1e-9):,.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  slot {b}: {rec['out_tokens'][b][:16]} ...")
    if record is not None:
        record.update(rec)
    return 0


# ------------------------------------------------------------ on a mesh
def serve_on_mesh(arch, mesh_shape: "tuple | None" = None, *,
                  batch: int, prompt_len: int, gen: int, device="cuda",
                  tokens=None, keep=None) -> dict:
    """The serve loop (``serve_rank``) on a ('data', 'model') =
    ``mesh_shape`` host mesh of spawned ranks, or in this process without
    a mesh (``None``); returns rank 0's record, its tensors on the CPU.

    Each rank draws its blocks of the parameters at rest (seed 0, the
    blocks of the one-process draw), makes its serving leaves once
    (``train.tp.TensorParallel.serve_leaf``: gathered over 'data' and,
    where storage-only, over 'model'), builds its block of the cache
    (``init_cache(tp=...)``) and serves its ``batch // D`` rows: the
    prompt through the decode path, then ``gen`` greedy tokens, then one
    ``make_prefill_step`` over every position fed.  ``tokens`` (a (batch,
    prompt_len + gen) integer array) are fed instead of the prompt and
    the greedy tokens (teacher forcing: the logits of two runs then
    compare position by position).  ``arch`` is a config name or a
    ``ModelConfig``.

    The record: ``cfg``, ``tokens`` (fed, whole batch), ``logits`` (the
    decode path's) and ``prefill_logits`` at the positions ``keep``
    (every position by default), gathered to rank 0 in the compute
    dtype; ``t_prompt``, ``t_gen``, ``ms_per_step`` (``t_gen / gen``,
    each step's argmax included) and ``t_prefill``; per rank (``ranks``)
    its coordinates, its bytes of parameters at rest (the blocks
    ``param_placements`` gives, float32) and in the serving layout
    (float32 leaves and their cast), of the cache at rest (the blocks of
    ``sharding.cache_placements``) and as served, its 'model' and 'data'
    collective seconds per generated token (its own, waits included),
    its device memory held before the run and its peak until the last
    decode step, and its kernel launches; per generated token, each
    collective's least time over the ranks (``model_collective_s``,
    ``data_collective_s``); ``plan`` and ``gathered`` (``train.tp``)."""
    dev = resolve_device(device)
    if batch % (mesh_shape or (1,))[0]:
        raise ValueError(f"the data axis {mesh_shape[0]} must divide the "
                         f"batch {batch}")
    args = serve_args(arch, batch=batch, prompt_len=prompt_len, gen=gen,
                      tokens=tokens, keep=keep)
    rec: dict = {}
    if mesh_shape is None:
        serve_rank(args, dev, rec)
        rec.update({k: rec[k].cpu()
                    for k in ("tokens", "logits", "prefill_logits")})
        return rec
    n = math.prod(mesh_shape)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a {tuple(mesh_shape)} mesh needs {n} cards; "
                           f"{torch.cuda.device_count()} visible")
    from repro_torch.launch import train as lm_train
    lm_train._launch(args, tuple(mesh_shape), dev, rec,
                     target=serve_rank)
    return rec


def serve_args(arch, *, batch: int, prompt_len: int, gen: int,
               tokens=None, keep=None) -> argparse.Namespace:
    """``serve_rank``'s arguments (the weights' seed 0)."""
    return argparse.Namespace(
        arch=arch, batch=batch, prompt_len=prompt_len, gen=gen, seed=0,
        keep=None if keep is None else list(keep),
        tokens=None if tokens is None else np.asarray(tokens, np.int64))


def serve_rank(args, dev: torch.device, record: dict, mesh=None) -> None:
    """The serve loop on this process's rank of ``mesh`` (a ('data',
    'model') ``DeviceMesh`` whose process group this process has joined),
    or alone without one; fills ``record`` (see ``serve_on_mesh``).
    ``make_prefill_step`` runs only where ``args.keep`` keeps a position.
    Without a mesh the record's tensors stay on ``dev`` and it also holds
    what the run made: the parameters (``model``), the cache, the decode
    step (``step``) and the greedy tokens (``out_tokens``, lists)."""
    import torch.distributed as dist

    from repro_torch.kernels.build import launch_counts
    cuda = dev.type == "cuda"
    cfg = (args.arch if isinstance(args.arch, ModelConfig)
           else get_config(args.arch))
    B, P, G = args.batch, args.prompt_len, args.gen
    S = P + G
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    dp = tp = None
    if mesh is None:
        params = tfm.init_params(cfg, seed=args.seed, device=dev)
        at_rest = _nbytes(params)
        cache = tfm.init_cache(cfg, B, S, device=dev)
        cache_rest = _nbytes(cache)
        rows = slice(0, B)
    else:
        from repro_torch.train.dp import keep_blocks
        from repro_torch.train.tp import mesh_layout
        dp, tp = mesh_layout(cfg, mesh, dev)
        shapes = tfm.init_params(cfg, device="meta")
        params = tfm.init_params(cfg, seed=args.seed, device=dev,
                                 keep=keep_blocks(shapes, dp.placements,
                                                  dp.coord, dp.shape))
        at_rest = _nbytes(params)
        params = tp.serving_leaves(params)
        cache = tfm.init_cache(cfg, B, S, device=dev, tp=tp)
        cache_rest = cache_bytes_at_rest(cfg, mesh, B, S)
        rows = slice(dp.rank * (B // dp.world),
                     (dp.rank + 1) * (B // dp.world))
    decode = make_decode_step(cfg, tp=tp)
    rng = np.random.default_rng(args.seed)
    if cfg.family == "encdec":
        frames = torch.as_tensor(
            rng.normal(size=(B, cfg.n_frames, cfg.d_model)),
            device=dev).to(cfg.cdtype)[rows]
        with torch.no_grad():
            enc_out, _ = tfm.encode(
                params if tp is None else tp.narrow_kv(params), cfg,
                frames, tp=tp)
            tfm.build_cross_cache(params, cfg, enc_out, cache, tp=tp)
    else:
        frames = None
    fed = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, P)) if args.tokens is None
        else args.tokens, device=dev)[rows]
    if fed.shape[1] < S:
        fed = torch.cat([fed, fed.new_zeros((fed.shape[0], S - P))], 1)
    keep = list(range(S)) if args.keep is None else args.keep
    where = {p: i for i, p in enumerate(keep)}
    logits_kept = torch.empty((fed.shape[0], len(keep), cfg.padded_vocab),
                              dtype=cfg.cdtype, device=dev)

    def flush() -> dict:
        if tp is None:
            return {}
        return {"model": tp.collective_times(),
                "data": dp.collective_times()}

    def step(i):
        logits, _ = decode(params, cache, fed[:, i],
                           torch.full((fed.shape[0],), i, device=dev))
        if i in where:
            logits_kept[:, where[i]] = logits
        return logits

    flush()                                 # the load's gathers
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(P):
        logits = step(i)
    _sync(dev)
    t_prompt = time.perf_counter() - t0
    flush()
    t0 = time.perf_counter()
    for i in range(P, S):
        if args.tokens is None:
            fed[:, i] = torch.argmax(logits, dim=-1)
        logits = step(i)
    fed[:, 0].tolist()                      # the host read ends the loop
    _sync(dev)
    t_gen = time.perf_counter() - t0
    coll = flush()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    pre, t_prefill = logits_kept, None
    if keep:
        prefill = make_prefill_step(cfg, tp=tp)
        prefill(params, fed[:, :8], frames)     # the weights' cast
        _sync(dev)
        t0 = time.perf_counter()
        pre = prefill(params, fed, frames)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        if args.keep is not None:
            pre = pre[:, keep]
        flush()
    mine = {"coord": (0, 0) if dp is None else dp.coord,
            "params_at_rest_bytes": at_rest,
            "params_serving_bytes": _nbytes(params),
            "cast_bytes": (_nbytes(params) * cfg.cdtype.itemsize // 4
                           if cfg.cdtype != torch.float32 else 0),
            "cache_at_rest_bytes": cache_rest,
            "cache_bytes": _nbytes(cache),
            "collective_s": {k: v["own_s"] / G for k, v in coll.items()},
            "held_bytes": held,
            "peak_bytes": peak,
            "launches": launch_counts()}
    record.update(cfg=cfg, tokens=fed, logits=logits_kept,
                  prefill_logits=pre, t_prompt=t_prompt, t_gen=t_gen,
                  ms_per_step=t_gen / G * 1e3, t_prefill=t_prefill,
                  mesh=(1, 1) if tp is None else (dp.world, tp.world),
                  plan=None if tp is None else tp.plan,
                  gathered=[] if tp is None else tp.gathered)
    if tp is None:
        record.update(ranks=[mine], model=params, cache=cache, step=decode,
                      out_tokens=fed[:, P:].tolist())
        return
    for k in ("tokens", "logits", "prefill_logits"):
        v = record[k]
        if dp.world > 1:
            v = dp._gather(v.contiguous(), 0)
        record[k] = v.cpu()
    for axis, got in coll.items():
        record[f"{axis}_collective_s"] = got["collective_s"] / G
        record[f"{axis}_collective_rank0_s"] = got["collective_rank0_s"] / G
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    record.update(ranks=ranks)


if __name__ == "__main__":
    sys.exit(main())
