"""C_cap — joint optimization of C_out and C_max (paper Sec. 8);
counterpart of ``repro.core.ccap``.

Minimize the sum of intermediate join sizes subject to the largest one
being (at most) the optimal C_max value:

  pass 1: optimal gamma* = C_max optimum      (DPconv[max] — Alg. 3)
  pass 2: pruned C_out optimization: any set S with c(S) > gamma* is
          infeasible (DPsub[out] / DPccp[out] with prune_gamma).

Engines: the default (``engine="auto"`` with the paper's
``dpconv``/``dpsub`` pass combination) runs both passes and the
witness-tree extraction as one fused lattice program on the device
(``engine.fused_ccap``); ``engine="host"`` is the host pipeline (the
parity reference, and the only route for ``engine_pass1="dpsub"``).
Caps, C_out values and trees are bit-identical between the two and to
``repro``.

``gamma_slack`` > 1 is the Sec. 11 resource-aware trade-off: cap at
gamma = slack * gamma* instead of the optimum.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import engine as engine_mod
from repro_torch.core import jointree
from repro_torch.core.baselines import dpsub, dpsub_max
from repro_torch.core.dpccp import dpccp
from repro_torch.core.dpconv_max import dpconv_max
from repro_torch.core.engine import host_cards
from repro_torch.core.querygraph import QueryGraph


@dataclasses.dataclass
class CcapResult:
    gamma: float            # the cap (= optimal C_max when slack == 1)
    cout: float             # optimal C_out subject to the cap
    tree: "jointree.JoinTree | None"
    passes: dict            # diagnostics
    engine: str = "host"    # which pipeline produced it
    dispatches: "int | None" = None


def _fused_combo(engine_pass1: str, engine_pass2: str) -> bool:
    return engine_pass1 == "dpconv" and engine_pass2 == "dpsub"


def _fused_result(fc, b: int, connected: bool) -> CcapResult:
    cout = float(fc.couts[b])
    assert np.isfinite(cout), (
        "connected cap infeasible — no cross-product-free plan attains "
        "gamma; raise gamma_slack" if connected else
        "cap infeasible — gamma below C_max optimum?")
    return CcapResult(gamma=float(fc.gammas[b]), cout=cout,
                      tree=fc.trees[b],
                      passes={"pass1_fsc_passes": fc.rounds},
                      engine="fused", dispatches=fc.dispatches)


def ccap(
    q: QueryGraph,
    card,
    engine_pass1: str = "dpconv",      # "dpconv" (paper) | "dpsub" (naive)
    engine_pass2: str = "dpsub",       # "dpsub" | "dpccp"
    gamma_slack: float = 1.0,
    extract_tree: bool = True,
    engine: str = "auto",              # "auto" | "fused" | "host"
    gamma_batch: int = 1,              # pass-1 probe width (fused only)
    connected: bool = False,           # exclude cross products in pass 2
    shards: int = 1,                   # solve-mesh width (fused only)
    seed_opt: "float | None" = None,
    device=None,
) -> CcapResult:
    """``connected=True`` restricts pass 2 to the DPccp search space (no
    cross products): fused runs the connectivity-gated (min,+) sweep,
    host runs ``dpccp(prune_gamma=gamma)``, i.e. it implies
    ``engine_pass2="dpccp"``.  The cap stays the full-lattice C_max
    optimum; if no cross-product-free plan attains it, the assertion
    fires (loosen ``gamma_slack``).  The fused engine runs on ``device``
    (CUDA unless given) on the f64 tier, as the reference's runs XLA.
    ``seed_opt`` (a cached C_max optimum) warm-starts the fused pass 1;
    the host pipeline ignores it."""
    n = q.n
    card = host_cards(card)
    if engine not in ("auto", "fused", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    seeds = None if seed_opt is None else [seed_opt]
    if connected:
        if engine_pass2 == "dpsub":
            engine_pass2 = "dpccp"
        if engine_pass2 != "dpccp":
            raise ValueError("connected C_cap means DPccp pass-2 "
                             "semantics")
        fusable = (engine_pass1 == "dpconv" and not q.hyperedges
                   and q.is_connected(q.full_mask))
        if engine == "fused" and not fusable:
            raise ValueError("the fused connected C_cap program needs "
                             "dpconv pass 1 and a connected simple-edge "
                             "graph")
        if engine in ("fused", "auto") and fusable:
            fc = engine_mod.fused_ccap(
                card[None, :], n, gamma_slack=gamma_slack,
                extract_tree=extract_tree, gamma_batch=gamma_batch,
                qs=[q], shards=shards, seed_opt=seeds, device=device)
            return _fused_result(fc, 0, True)
        # fall through to the host pipeline (engine_pass2 == "dpccp")
    elif engine == "fused" and not _fused_combo(engine_pass1,
                                                engine_pass2):
        raise ValueError("the fused C_cap program implements the "
                         "dpconv/dpsub pass combination; other passes "
                         "run on engine='host'")
    use_fused = not connected and (
        engine == "fused" or (
            engine == "auto" and _fused_combo(engine_pass1, engine_pass2)))
    if use_fused:
        fc = engine_mod.fused_ccap(
            card[None, :], n, gamma_slack=gamma_slack,
            extract_tree=extract_tree, gamma_batch=gamma_batch,
            shards=shards, seed_opt=seeds, device=device)
        return _fused_result(fc, 0, False)

    diagnostics = {}
    if engine_pass1 == "dpconv":
        # under engine="auto" with a dpccp pass 2, pass 1 itself still
        # runs on the fused engine; engine="host" pins the whole pipeline
        # to the per-round host loop
        res = dpconv_max(q, card, extract_tree=False, engine=engine,
                         device=device)
        gamma = res.optimum
        diagnostics["pass1_fsc_passes"] = res.feasibility_passes
        diagnostics["pass1_engine"] = res.engine
    elif engine_pass1 == "dpsub":
        gamma = float(dpsub_max(card, n)[-1])
    else:
        raise ValueError(engine_pass1)
    gamma = gamma * gamma_slack

    if engine_pass2 == "dpsub":
        dp = dpsub(card, n, mode="out", prune_gamma=gamma)
    elif engine_pass2 == "dpccp":
        dp, nccp = dpccp(q, card, mode="out", prune_gamma=gamma)
        diagnostics["pass2_ccp"] = nccp
    else:
        raise ValueError(engine_pass2)

    cout = float(dp[-1])
    assert np.isfinite(cout), "cap infeasible — gamma below C_max optimum?"
    tree = jointree.extract_tree_out(dp, card, n) if extract_tree else None
    return CcapResult(gamma=gamma, cout=cout, tree=tree,
                      passes=diagnostics, engine="host")


# --------------------------------------------------------- batched queries
def ccap_batch(
    qs: list,
    cards,
    n: int,
    gamma_slack: float = 1.0,
    extract_tree: bool = True,
    engine: str = "fused",
    gamma_batch: int = 1,
    connected: bool = False,
    shards: int = 1,                   # solve-mesh width (fused only)
    seed_opt=None,
    device=None,
) -> "list[CcapResult]":
    """Solve B same-``n`` C_cap instances in lockstep — the batch lane's
    entry point.  ``engine="fused"`` runs the whole batch (both passes
    and the extraction) in one program call on the f64 tier; ``"host"``
    loops the host pipeline per query.

    ``connected=True`` is the batched no-cross-products cap.  Any
    non-fusable member (hyperedges / disconnected) drops the whole chunk
    to the per-query host pipeline, as in the reference.  ``seed_opt``:
    per-row cached C_max optima for the fused pass 1.
    """
    cards = host_cards(cards)
    if cards.shape[1] != 1 << n:
        raise ValueError(f"cards of width {cards.shape[1]} do not fit n={n}")
    fusable = not connected or all(
        not q.hyperedges and q.is_connected(q.full_mask) for q in qs)
    if engine in ("fused", "auto") and fusable:
        fc = engine_mod.fused_ccap(cards, n, gamma_slack=gamma_slack,
                                   extract_tree=extract_tree,
                                   gamma_batch=gamma_batch,
                                   qs=list(qs) if connected else None,
                                   shards=shards, seed_opt=seed_opt,
                                   device=device)
        return [_fused_result(fc, b, connected)
                for b in range(cards.shape[0])]
    return [ccap(q, cards[b], gamma_slack=gamma_slack,
                 extract_tree=extract_tree, engine="host",
                 connected=connected, device=device)
            for b, q in enumerate(qs)]
