"""DPconv façade of the port (counterpart of ``repro.core.dpconv``): Alg. 1
of the paper, instantiated per cost function.

    result = optimize(q, card, cost="max")       # DPconv[max], Alg. 3
    result = optimize(q, card, cost="out")       # exact C_out (small W!)
    result = optimize(q, card, cost="out", method="approx", eps=0.25)
    result = optimize(q, card, cost="cap")       # C_cap, Sec. 8
    result = optimize(q, card, cost="smj", method="approx")
    result = optimize(q, card, cost="out", method="dpsub")   # baseline
    result = optimize(q, card, cost="out", method="dpccp")   # baseline

Every (cost, method) pair of the reference runs, with the same routing.
``device`` (CUDA unless given) reaches the paths that run tensor code;
the numpy oracles (``dpsub``, the host ``dpccp`` enumerator) run on the
host, as in the reference.  Warm-start seeds ride as in the reference:
``seed_opt`` reaches the fused max and cap searches, ``seed_vals``/
``seed_ok`` the fused DPccp sweep only (the host enumerator drops them).
The solve-mesh width ``shards`` reaches the fused max, cap and DPccp
programs (the host enumerator drops it; the host loops raise on
``shards > 1``, as in the reference).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import baselines, dpccp as dpccp_mod, jointree
from repro_torch.core import engine as engine_mod
from repro_torch.core.approx import approx_out
from repro_torch.core.ccap import ccap, ccap_batch
from repro_torch.core.dpconv_max import dpconv_max, dpconv_max_batch
from repro_torch.core.dpconv_out import dpconv_out
from repro_torch.core.engine import host_cards
from repro_torch.core.querygraph import QueryGraph

_SEEDS = ("seed_opt", "seed_vals", "seed_ok")


@dataclasses.dataclass
class PlanResult:
    cost: float
    tree: "jointree.JoinTree | None"
    meta: dict


def _fusable_out(q: QueryGraph) -> bool:
    return (q.n >= 2 and not q.hyperedges
            and q.is_connected(q.full_mask))


def optimize(q: QueryGraph, card, cost: str = "max",
             method: str = "dpconv", extract_tree: bool = True,
             **kw) -> PlanResult:
    n = q.n
    if cost == "max":
        if method == "dpconv":
            r = dpconv_max(q, card, extract_tree=extract_tree, **kw)
            return PlanResult(r.optimum, r.tree,
                              {"passes": r.feasibility_passes,
                               "engine": r.engine,
                               "dispatches": r.dispatches})
        if method == "dpsub":
            kw.pop("device", None)
            card = host_cards(card)
            dp = baselines.dpsub_max(card, n, **kw)
            tree = jointree.extract_tree_max(dp, card, n) \
                if extract_tree else None
            return PlanResult(float(dp[-1]), tree, {})
    if cost == "out":
        if method == "dpconv":
            out = dpconv_out(card, n, extract_tree=extract_tree,
                             device=kw.get("device"))
            tree = out[2] if extract_tree else None
            return PlanResult(float(out[0]), tree, {})
        if method == "approx":
            val, dp = approx_out(card, n, cost="out", **kw)
            return PlanResult(val, None, {"dp": dp})
        if method == "dpsub":
            kw.pop("device", None)
            card = host_cards(card)
            dp = baselines.dpsub_out(card, n, **kw)
            tree = jointree.extract_tree_out(dp, card, n) \
                if extract_tree else None
            return PlanResult(float(dp[-1]), tree, {})
        if method == "dpccp":
            engine = kw.pop("engine", "host")
            device = kw.pop("device", None)
            # the solve-mesh width rides the fused path only; the host
            # enumerator has no device to shard
            shards = int(kw.pop("shards", 1) or 1)
            # value seeds ride the fused path only: the host enumerator
            # has no slot for them, so they are dropped, never an error
            seed_vals = kw.pop("seed_vals", None)
            seed_ok = kw.pop("seed_ok", None)
            card = host_cards(card)
            if engine not in ("host", "fused"):
                raise ValueError(f"unknown dpccp engine {engine!r}")
            if engine == "fused" and not kw and _fusable_out(q):
                fo = engine_mod.fused_out(
                    [q], card[None, :], n, extract_tree=extract_tree,
                    shards=shards, seed_vals=None if seed_vals is None
                    else np.asarray(seed_vals, np.float64)[None, :],
                    seed_ok=None if seed_ok is None
                    else np.asarray(seed_ok, bool)[None, :],
                    device=device)
                meta = {"engine": "fused", "dispatches": fo.dispatches}
                if fo.dp is not None:
                    meta["dp_table"] = np.asarray(fo.dp[0], np.float64)
                return PlanResult(float(fo.couts[0]), fo.trees[0], meta)
            # host enumeration: the parity reference, and the only route
            # for hyperedge/disconnected graphs and prune_gamma variants
            dp, nccp = dpccp_mod.dpccp(q, card, mode="out", **kw)
            tree = jointree.extract_tree_out(dp, card, n) \
                if extract_tree else None
            meta = {"ccp": nccp, "engine": "host"}
            if not kw:          # pruned/variant tables aren't the plain dp
                meta["dp_table"] = np.asarray(dp, np.float64)
            return PlanResult(float(dp[-1]), tree, meta)
    if cost == "cap":
        r = ccap(q, card, extract_tree=extract_tree, **kw)
        return PlanResult(r.cout, r.tree,
                          {"gamma": r.gamma, "engine": r.engine,
                           "dispatches": r.dispatches,
                           "passes": r.passes.get("pass1_fsc_passes"),
                           **r.passes})
    if cost == "smj":
        if method == "approx":
            val, dp = approx_out(card, n, cost="smj", **kw)
            return PlanResult(val, None, {"dp": dp})
        if method == "dpsub":
            kw.pop("device", None)
            dp = baselines.dpsub(host_cards(card), n, mode="smj", **kw)
            return PlanResult(float(dp[-1]), None, {})
    raise ValueError(f"unsupported (cost={cost}, method={method})")


def optimize_batch(qs, cards, cost: str = "max", method: str = "dpconv",
                   extract_tree: bool = True, dp_fn=None,
                   **kw) -> "list[PlanResult]":
    """Plan B queries at once, routed as in the reference.

    Same-``n`` batches of ``(max, dpconv)`` stack on a leading axis
    (``dpconv_max_batch``); ``(cap, dpconv)`` run the fused two-pass
    C_cap program (``ccap_batch``) unless ``engine="host"``; ``(out,
    dpccp, engine="fused")`` batches of connected simple-edge graphs run
    the connectivity-masked C_out program (``engine.fused_out``).  All
    are bit-identical to B single ``optimize`` calls.  Every other pair,
    and mixed-``n`` batches, loop per query.
    """
    qs = list(qs)
    cards = [host_cards(c) for c in cards]
    same_n = len(qs) > 1 and len({q.n for q in qs}) == 1
    if cost == "max" and method == "dpconv" and same_n:
        rs = dpconv_max_batch(np.stack(cards), qs[0].n,
                              extract_tree=extract_tree, dp_fn=dp_fn, **kw)
        return [PlanResult(r.optimum, r.tree,
                           {"passes": r.feasibility_passes,
                            "engine": r.engine,
                            "dispatches": r.dispatches,
                            "batched": True}) for r in rs]
    if (cost == "out" and method == "dpccp" and same_n and dp_fn is None
            and set(kw) <= {"engine", "device", "shards", "seed_vals",
                            "seed_ok"}
            and kw.get("engine") == "fused"
            and all(_fusable_out(q) for q in qs)):
        fo = engine_mod.fused_out(qs, np.stack(cards), qs[0].n,
                                  extract_tree=extract_tree,
                                  shards=int(kw.get("shards", 1) or 1),
                                  seed_vals=kw.get("seed_vals"),
                                  seed_ok=kw.get("seed_ok"),
                                  device=kw.get("device"))
        out = []
        for b in range(len(qs)):
            meta = {"engine": "fused", "dispatches": fo.dispatches,
                    "batched": True}
            if fo.dp is not None:
                meta["dp_table"] = np.asarray(fo.dp[b], np.float64)
            out.append(PlanResult(float(fo.couts[b]), fo.trees[b], meta))
        return out
    if (cost == "cap" and method == "dpconv" and same_n and dp_fn is None
            and kw.get("engine", "auto") != "host"):
        kw.pop("engine", None)
        rs = ccap_batch(qs, np.stack(cards), qs[0].n,
                        extract_tree=extract_tree, **kw)
        return [PlanResult(r.cout, r.tree,
                           {"gamma": r.gamma, "engine": r.engine,
                            "dispatches": r.dispatches,
                            "passes": r.passes.get("pass1_fsc_passes"),
                            "batched": True}) for r in rs]
    # the per-query fallback: batch-shaped seeds do not apply to single
    # solves, so they are dropped (seeds are never load-bearing)
    for hint in _SEEDS:
        kw.pop(hint, None)
    return [optimize(q, c, cost=cost, method=method,
                     extract_tree=extract_tree, **kw)
            for q, c in zip(qs, cards)]
