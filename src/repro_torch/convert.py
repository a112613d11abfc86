"""Carry a query from ``repro`` to the port, and a plan back.

The system has no weights: what crosses over is the query graph and its
dense cardinality table.  ``from_reference`` takes the fields of a
``repro.core.querygraph.QueryGraph`` and its (2^n,) float64 table;
``plan_key`` turns a plan into what the two packages are compared on —
the optimum's ``float.hex`` and the tree's string.  Plain values only:
this module imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.querygraph import QueryGraph
from repro_torch.device import resolve_device


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
