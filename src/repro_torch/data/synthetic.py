"""Deterministic synthetic LM data pipeline: a copy of
``repro.data.synthetic`` (numpy only).

Infinite stream of (tokens, labels) batches, reproducible from (seed,
step) alone — restart-safe by construction (resuming at step k regenerates
exactly the batch k stream; no data-loader state in checkpoints).
Batches are numpy int32 arrays; the trainer moves them to its device.

``host_slice`` yields only the rows one process owns under a
data-parallel layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # mixture of synthetic "sources" with different token statistics
    source_weights: tuple = (1.0,)
    # "random": uniform tokens (loss floor = ln(vocab)); "cyclic":
    # fully-predictable arithmetic sequences (loss should -> 0) — used by
    # convergence tests
    pattern: str = "random"


def _rng_for(seed: int, step: int, source: int = 0):
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, source]))


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Global batch for ``step``: {"tokens", "labels"} (B, S) int32."""
    n_src = len(cfg.source_weights)
    w = np.asarray(cfg.source_weights, np.float64)
    w = w / w.sum()
    counts = np.floor(w * cfg.global_batch).astype(int)
    counts[0] += cfg.global_batch - counts.sum()
    rows = []
    for s, c in enumerate(counts):
        if c == 0:
            continue
        rng = _rng_for(cfg.seed, step, s)
        # source s biases a different token band — distinguishable streams
        lo = (s * cfg.vocab_size // max(n_src, 1)) % cfg.vocab_size
        hi = max(lo + cfg.vocab_size // max(n_src, 1), lo + 2)
        if cfg.pattern == "cyclic":
            start = rng.integers(0, cfg.vocab_size, (c, 1))
            stride = rng.integers(1, 4, (c, 1))
            idx = np.arange(cfg.seq_len + 1)[None, :]
            base = (start + stride * idx) % cfg.vocab_size
        else:
            base = rng.integers(lo, min(hi, cfg.vocab_size),
                                (c, cfg.seq_len + 1), dtype=np.int64)
        rows.append(base)
    data = np.concatenate(rows, axis=0)
    perm = _rng_for(cfg.seed, step, 10_000).permutation(len(data))
    data = data[perm]
    return {"tokens": data[:, :-1].astype(np.int32),
            "labels": data[:, 1:].astype(np.int32)}


def host_slice(batch: dict, process_index: int, process_count: int) -> dict:
    b = batch["tokens"].shape[0]
    per = b // process_count
    sl = slice(process_index * per, (process_index + 1) * per)
    return {k: v[sl] for k, v in batch.items()}


def stream(cfg: DataConfig, start_step: int = 0):
    step = start_step
    while True:
        yield step, batch_at(cfg, step)
        step += 1
