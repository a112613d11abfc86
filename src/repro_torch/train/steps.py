"""Serve step builders (counterpart of the serving part of
``repro.train.steps``): ``cast_tree``, ``make_prefill_step`` and
``make_decode_step``.  The loss and the train step come with the
optimizer.

The reference casts the float32 parameters to the compute dtype inside
every jitted step, where XLA fuses the cast away.  Run eagerly, that
cast would read and write every weight on every decode step, so each
step here casts once, the first time it sees a parameter tree, and
keeps the cast copy for as long as it is handed the same tree (the same
``LM`` or dict object).  The cast is deterministic, so the numbers are
those of a cast per call.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig


def cast_tree(tree, dtype):
    """Floating leaves to ``dtype`` (a leaf already of ``dtype`` is kept,
    not copied); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class _CastOnce:
    """The compute-dtype copy of the last parameter tree handed in."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._src = None
        self._cast = None

    def __call__(self, params):
        if params is not self._src:
            self._src = params
            self._cast = cast_tree(tfm._as_tree(params), self.cfg.cdtype)
        return self._cast


def make_prefill_step(cfg: ModelConfig, attn_scheme: str = "simple"):
    cast = _CastOnce(cfg)

    @torch.no_grad()
    def prefill(params, tokens, frames=None):
        logits, _ = tfm.forward(cast(params), cfg, tokens, frames=frames,
                                remat=False, attn_scheme=attn_scheme)
        return logits
    return prefill


def make_decode_step(cfg: ModelConfig):
    cast = _CastOnce(cfg)

    @torch.no_grad()
    def decode(params, cache, token, pos):
        return tfm.decode_step(cast(params), cfg, cache, token, pos)
    return decode
