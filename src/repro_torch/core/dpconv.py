"""DPconv façade of the port (counterpart of ``repro.core.dpconv``).

    result = optimize(q, card, cost="max")      # DPconv[max], Alg. 3

Only ``cost="max"`` with ``method="dpconv"`` is ported; every other
(cost, method) pair raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import jointree
from repro_torch.core.dpconv_max import dpconv_max, dpconv_max_batch
from repro_torch.core.engine import host_cards
from repro_torch.core.querygraph import QueryGraph


@dataclasses.dataclass
class PlanResult:
    cost: float
    tree: "jointree.JoinTree | None"
    meta: dict


def _ported(cost: str, method: str) -> None:
    if (cost, method) != ("max", "dpconv"):
        raise NotImplementedError(
            f"(cost={cost!r}, method={method!r}) is not ported yet; "
            "repro_torch plans cost='max' with method='dpconv'")


def optimize(q: QueryGraph, card, cost: str = "max",
             method: str = "dpconv", extract_tree: bool = True,
             **kw) -> PlanResult:
    _ported(cost, method)
    r = dpconv_max(q, card, extract_tree=extract_tree, **kw)
    return PlanResult(r.optimum, r.tree,
                      {"passes": r.feasibility_passes, "engine": r.engine,
                       "dispatches": r.dispatches})


def optimize_batch(qs, cards, cost: str = "max", method: str = "dpconv",
                   extract_tree: bool = True, dp_fn=None,
                   **kw) -> "list[PlanResult]":
    """Plan B queries at once.  Same-``n`` batches stack on a leading axis
    (``dpconv_max_batch``) — bit-identical to B single ``optimize``
    calls; mixed-``n`` batches loop per query."""
    _ported(cost, method)
    qs = list(qs)
    cards = [host_cards(c) for c in cards]
    if len(qs) > 1 and len({q.n for q in qs}) == 1:
        rs = dpconv_max_batch(np.stack(cards), qs[0].n,
                              extract_tree=extract_tree, dp_fn=dp_fn, **kw)
        return [PlanResult(r.optimum, r.tree,
                           {"passes": r.feasibility_passes,
                            "engine": r.engine,
                            "dispatches": r.dispatches,
                            "batched": True}) for r in rs]
    return [optimize(q, c, cost=cost, method=method,
                     extract_tree=extract_tree, **kw)
            for q, c in zip(qs, cards)]
