"""Carry a query or a model from ``repro`` to the port, and a plan back.

The join-order side has no weights: what crosses over is the query graph
and its dense cardinality table.  ``from_reference`` takes the fields of
a ``repro.core.querygraph.QueryGraph`` and its (2^n,) float64 table;
``plan_key`` turns a plan into what the two packages are compared on —
the optimum's ``float.hex`` and the tree's string.  The LM side carries
parameter and cache pytrees over path for path
(``lm_params_from_reference``, ``lm_cache_from_reference``), and a
train state leaf for leaf (``train_state_from_reference``): the port
keeps the reference's paths and shapes, so nothing is transposed.  Plain
values only: this module imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.querygraph import QueryGraph
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM, layer_plan


def from_reference(n: int, edges, hyperedges, card, device=None):
    """The port's ``QueryGraph`` and a float64 cardinality tensor on
    ``device`` (CUDA unless given)."""
    card = np.asarray(card, np.float64)
    if card.shape != (1 << n,):
        raise ValueError(f"card of shape {card.shape} does not fit n={n}")
    q = QueryGraph(int(n), tuple((int(u), int(v)) for u, v in edges),
                   tuple((int(a), int(b)) for a, b in hyperedges))
    return q, torch.tensor(card, device=resolve_device(device))


def plan_key(optimum, tree) -> tuple:
    """``(float.hex(optimum), str(tree))`` — bitwise comparable."""
    return float(optimum).hex(), str(tree)


def _tensor_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensor_tree(v, dev) for v in tree]
    return torch.tensor(np.array(tree), device=dev)


def lm_params_from_reference(cfg: ModelConfig, params_np,
                             device=None) -> LM:
    """The port's model (``models.transformer.LM``) holding the values of
    a ``repro`` parameter pytree given as nested numpy arrays
    (``jax.tree.map(np.asarray, params)``), on ``device`` (CUDA unless
    given).  Every leaf keeps its path, shape and dtype."""
    return LM(cfg, _tensor_tree(params_np, resolve_device(device)))


def lm_cache_from_reference(cache_np, device=None) -> dict:
    """A ``repro`` decode cache (nested numpy arrays) as the port's cache
    tree on ``device`` (CUDA unless given)."""
    return _tensor_tree(cache_np, resolve_device(device))


def train_state_from_reference(cfg: ModelConfig, state_np,
                               device=None) -> dict:
    """The port's train state (``train.steps.init_train_state``'s tree:
    ``{"params", "opt": {"mu", "nu", "step"}[, "residual"]}``) holding
    the values of a ``repro`` train state given as nested numpy arrays,
    on ``device`` (CUDA unless given).  Every leaf keeps its path, shape
    and dtype."""
    params = state_np["params"]
    embed = tuple(np.shape(params["embed"]))
    if (embed != (cfg.padded_vocab, cfg.d_model)
            or len(params["segments"]) != len(layer_plan(cfg))):
        raise ValueError(f"the state's parameters (embed {embed}, "
                         f"{len(params['segments'])} segments) do not fit "
                         f"{cfg.name}")
    return _tensor_tree(state_np, resolve_device(device))
