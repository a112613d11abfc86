"""Checkpointing: atomic save and restore of a train state (counterpart
of ``repro.checkpoint.ckpt``, the same files).

Format: one .npz per checkpoint step (flattened path -> array) plus a
JSON manifest.  A leaf's key is its path in ``jax.tree`` order, dict
keys and list indices joined by ``/`` (``params/segments/0/slot0/attn/
wq``, ``opt/step``), as ``tree_flatten_with_path`` builds them, so a
checkpoint written by either package loads into the other.  Writes are
atomic (tmp + rename), so a preempted save never corrupts the
latest-step pointer, and ``available_steps`` skips incomplete
checkpoints.  ``load`` places each leaf on its template leaf's device,
or on ``device``: a checkpoint written from the card loads on the CPU,
and the reverse.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from repro_torch.tree import tree_items


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict:
    """Path -> numpy copy of every leaf (a copy: the trainer updates its
    state in place while a background save may still be writing)."""
    return {_key(path): leaf.detach().cpu().numpy().copy()
            for path, leaf in tree_items(tree)}


def _unflatten_like(template, flat: dict, device=None):
    def leaf(path, tmpl):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"model {tuple(tmpl.shape)}")
        return torch.from_numpy(arr).to(
            tmpl.device if device is None else device)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, prefix + (i,)) for i, v in enumerate(tree)]
        return leaf(prefix, tree)
    return walk(template, ())


def save(state, ckpt_dir: str, step: int, blocking: bool = True):
    """Atomic checkpoint write; optionally in a background thread (the
    state is copied to the host first).  Returns the thread or None."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp-{step}.npz")
        final = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
        np.savez(tmp, **flat)
        os.replace(tmp, final)
        manifest = {"step": step,
                    "leaves": {k: [list(v.shape), str(v.dtype)]
                               for k, v in flat.items()}}
        mtmp = os.path.join(ckpt_dir, f".tmp-{step}.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(ckpt_dir,
                                      f"step-{step:08d}.json"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def available_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("step-") and f.endswith(".json"):
            s = int(f[len("step-"):-len(".json")])
            if os.path.exists(os.path.join(ckpt_dir, f[:-5] + ".npz")):
                steps.append(s)
    return sorted(steps)


def load(template, ckpt_dir: str, step: int | None = None, device=None):
    """Restore a state tree.  ``template`` gives the structure, shapes and
    (without ``device``) each leaf's device.  Returns (state, step)."""
    steps = available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    with np.load(os.path.join(ckpt_dir, f"step-{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_like(template, flat, device), step
