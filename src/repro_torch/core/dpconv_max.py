"""DPconv[max] — Alg. 3 of the paper: optimal C_max in O(2^n n^3)
(counterpart of ``repro.core.dpconv_max``).

C_max minimizes the largest intermediate join cardinality.  The optimum
is one of the 2^n join cardinalities, so Alg. 3 binary-searches the
smallest feasible threshold gamma, where *feasible* means that V splits
into a join tree whose intermediates are all <= gamma — one layered
counting pass per probe (Kosaraju's {0,1} trick, Sec. 6).

Two engines, as in the reference: ``"fused"`` (``core.engine``: the
whole lockstep search and the Alg. 2 extraction scan on the device) and
``"host"`` (one feasibility pass per round, host recursion for the tree;
the parity reference and the ``dp_fn`` hook that the kernel tier's
ranked convolution runs through).  ``seed_opt`` (a cached optimum from
the layer cache) warm-starts the fused search and is ignored by the host
loop, as in the reference: a seed is a perf hint, never an input to the
result.  The single-query host loop carries the reference's two
variants: ``gamma_batch > 1`` ((G+1)-ary search, G gates per pass on a
leading axis) and ``early_exit`` (each binary-search probe runs the
layer-by-layer pass of ``core.layered`` that stops at the first empty
dyadic window).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import jointree
from repro_torch.core.bitset import popcounts
from repro_torch.core.engine import (candidate_table, fused_dpconv_max,
                                     host_cards)
from repro_torch.core.lattice import popcounts_on
from repro_torch.core.layered import (layered_feasibility_dp,
                                      layered_feasibility_early_exit)
from repro_torch.core.querygraph import QueryGraph
from repro_torch.device import resolve_device


@dataclasses.dataclass
class CmaxResult:
    optimum: float                 # optimal C_max value
    tree: "jointree.JoinTree | None"
    feasibility_passes: int
    engine: str = "host"
    dispatches: "int | None" = None


def _check_engine(engine: str) -> None:
    if engine not in ("auto", "fused", "host"):
        raise ValueError(f"unknown engine {engine!r}")


def _gate_for(card: torch.Tensor, gamma, pc: torch.Tensor) -> torch.Tensor:
    """gate(S) = [c(S) <= gamma] for |S| >= 2; singletons and the empty
    set do not gate.  ``gamma`` may be a scalar or (G,): the gate is then
    (G, 2^n)."""
    gamma = torch.as_tensor(gamma, dtype=torch.float64, device=card.device)
    g = card[None, :] <= gamma[..., None] if gamma.ndim else card <= gamma
    return torch.where(pc >= 2, g.to(torch.float64), 1.0)


def feasible(card, gamma, n: int, direct_layers: int = 4,
             device=None) -> bool:
    """One feasibility probe (single gamma)."""
    dev = resolve_device(device)
    gate = _gate_for(torch.as_tensor(host_cards(card), device=dev), gamma,
                     popcounts_on(n, dev))
    dp = layered_feasibility_dp(gate, n, direct_layers, True)
    return bool(dp[..., -1] > 0.5)


def dpconv_max(
    q: QueryGraph,
    card,
    gamma_batch: int = 1,
    direct_layers: int = 4,
    extract_tree: bool = True,
    early_exit: bool = False,
    engine: str = "auto",
    backend: str = "f64",
    shards: int = 1,
    seed_opt: "float | None" = None,
    device=None,
) -> CmaxResult:
    """Optimal C_max value (and join tree) for query graph ``q`` with the
    dense cardinality table ``card`` (2^n,).  Clique semantics: every
    split is allowed, cross products priced by ``card``.

    ``engine`` ``"fused"`` runs the fused engine (``backend`` selects its
    tier, ``gamma_batch`` its probe width); ``"host"`` runs the per-round
    host loop on the f64 tier: binary search, ``early_exit`` probes, or
    (G+1)-ary search for ``gamma_batch`` = G > 1.  ``"auto"`` is the
    fused engine unless ``early_exit`` asks for the host loop (its layer
    abort is a host decision by construction).  ``seed_opt`` warm-starts
    the fused search (bit-identical results; the host loop ignores it)."""
    _check_engine(engine)
    card = host_cards(card)
    n = q.n
    if engine == "fused" or (engine == "auto" and not early_exit):
        if early_exit:
            raise ValueError("early_exit is a host-loop variant; "
                             "use engine='host' or 'auto'")
        fs = fused_dpconv_max(card[None, :], n, direct_layers=direct_layers,
                              extract_tree=extract_tree, backend=backend,
                              gamma_batch=gamma_batch, shards=shards,
                              seed_opt=None if seed_opt is None
                              else [seed_opt], device=device)
        return CmaxResult(optimum=float(fs.optima[0]), tree=fs.trees[0],
                          feasibility_passes=fs.passes, engine="fused",
                          dispatches=fs.dispatches)
    if shards != 1:
        raise ValueError("shards > 1 is a fused-engine concept; the "
                         "host loop runs on one device")
    if gamma_batch <= 1 and not early_exit:    # the plain binary search
        return dpconv_max_batch(card[None, :], n,
                                direct_layers=direct_layers,
                                extract_tree=extract_tree, engine="host",
                                device=device)[0]
    if card.shape != (1 << n,):
        raise ValueError(f"card of shape {card.shape} does not fit n={n}")
    dev = resolve_device(device)
    pc = popcounts_on(n, dev)
    cj = torch.as_tensor(card, device=dev)

    # the candidate thresholds, shared with the fused engine: identical
    # arrays keep the two pivot sequences aligned
    cand = candidate_table(card, n)             # ascending, unique
    lo, hi = 0, len(cand) - 1                   # invariant: cand[hi] feasible
    passes = 0
    if gamma_batch <= 1:                        # binary, early-exit probes
        while lo < hi:
            mid = (lo + hi) // 2
            passes += 1
            gate = _gate_for(cj, float(cand[mid]), pc)
            if layered_feasibility_early_exit(gate, n, direct_layers):
                hi = mid
            else:
                lo = mid + 1
    else:
        G = gamma_batch
        while lo < hi:
            # G interior pivots split [lo, hi] into G+1 parts
            pivots = np.unique(
                np.linspace(lo, hi, G + 2)[1:-1].astype(np.int64))
            gate = _gate_for(cj, cand[pivots], pc)
            dp = layered_feasibility_dp(gate, n, direct_layers, True)
            ok = (dp[..., -1] > 0.5).cpu().numpy().reshape(-1)
            passes += 1
            # feasibility is monotone in gamma: ok = [F..F, T..T]
            good = np.nonzero(ok)[0]
            bad = np.nonzero(~ok)[0]
            if good.size:                       # smallest feasible pivot
                hi = int(pivots[good[0]])
            if bad.size:                        # largest infeasible pivot
                lo = max(lo, int(pivots[bad[-1]]) + 1)

    opt = float(cand[hi])
    tree = None
    if extract_tree:
        gate = _gate_for(cj, opt, pc)
        dp = layered_feasibility_dp(gate, n, direct_layers, False)
        passes += 1
        tree = jointree.extract_tree_feasibility(dp.cpu().numpy(), card, n)
    return CmaxResult(optimum=opt, tree=tree, feasibility_passes=passes,
                      dispatches=passes)


# --------------------------------------------------------- batched queries
def dpconv_max_batch(
    cards,
    n: int,
    direct_layers: int = 4,
    extract_tree: bool = True,
    dp_fn=None,
    engine: str = "auto",
    backend: str = "f64",
    gamma_batch: int = 1,
    shards: int = 1,
    seed_opt=None,
    device=None,
) -> "list[CmaxResult]":
    """Solve B same-``n`` DPconv[max] instances in lockstep; ``cards`` is
    (B, 2^n).  Each round stacks the B pivot thresholds into one (B, 2^n)
    gate and runs ONE batched feasibility pass.  Optima are bit-identical
    to B independent ``dpconv_max`` calls.

    ``dp_fn(gate, final_layer_shortcut)`` overrides the host loop's
    feasibility pass (``service.batch.kernel_dp_fn`` is the kernel tier);
    the default is the f64 layered DP.  ``engine="fused"`` (and
    ``"auto"`` without ``dp_fn``) runs ``core.engine.fused_dpconv_max``.
    ``seed_opt`` — per-row cached optima (None entries cold) for the
    fused search; the host loop ignores them.
    """
    _check_engine(engine)
    cards = host_cards(cards)
    B, size = cards.shape
    if size != 1 << n:
        raise ValueError(f"cards of width {size} do not fit n={n}")
    if engine == "fused" or (engine == "auto" and dp_fn is None):
        if dp_fn is not None:
            raise ValueError("dp_fn is a host-loop override; "
                             "use engine='host' or 'auto'")
        fs = fused_dpconv_max(cards, n, direct_layers=direct_layers,
                              extract_tree=extract_tree, backend=backend,
                              gamma_batch=gamma_batch, shards=shards,
                              seed_opt=seed_opt, device=device)
        return [CmaxResult(optimum=float(fs.optima[b]), tree=fs.trees[b],
                           feasibility_passes=fs.passes, engine="fused",
                           dispatches=fs.dispatches) for b in range(B)]
    if shards != 1:
        raise ValueError("shards > 1 is a fused-engine concept; the "
                         "host loop runs on one device")
    if gamma_batch > 1:
        raise ValueError("the host batch loop is binary-search only; "
                         "gamma_batch > 1 runs on the fused engine or "
                         "the single-query dpconv_max")
    dev = resolve_device(device)
    pc = popcounts_on(n, dev)
    cj = torch.as_tensor(cards, device=dev)

    if dp_fn is None:
        def dp_fn(gate, shortcut):
            return layered_feasibility_dp(gate, n, direct_layers, shortcut)

    def gate_of(gammas: np.ndarray) -> torch.Tensor:
        g = cj <= torch.as_tensor(gammas, dtype=torch.float64,
                                  device=dev)[:, None]
        return torch.where(pc >= 2, g.to(torch.float64), 1.0)

    cands = [candidate_table(cards[b], n) for b in range(B)]
    lo = np.zeros(B, np.int64)
    hi = np.array([len(c) - 1 for c in cands], np.int64)
    passes = 0
    while np.any(lo < hi):
        active = lo < hi
        mid = np.where(active, (lo + hi) // 2, hi)
        gammas = np.array([cands[b][mid[b]] for b in range(B)])
        dp = dp_fn(gate_of(gammas), True)
        ok = (dp[..., -1] > 0.5).cpu().numpy().reshape(-1)
        passes += 1
        hi = np.where(active & ok, mid, hi)
        lo = np.where(active & ~ok, mid + 1, lo)

    opts = np.array([cands[b][hi[b]] for b in range(B)])
    trees: list = [None] * B
    if extract_tree:
        dp = dp_fn(gate_of(opts), False)
        passes += 1
        dpn = dp.to(torch.float64).cpu().numpy().reshape(B, size)
        trees = [jointree.extract_tree_feasibility(dpn[b], cards[b], n)
                 for b in range(B)]
    return [CmaxResult(optimum=float(opts[b]), tree=trees[b],
                       feasibility_passes=passes, dispatches=passes)
            for b in range(B)]


# ------------------------------------------------------------------ oracle
def dpconv_max_ref(card: np.ndarray, n: int) -> float:
    """O(3^n) reference: DPsub-style (min,max) DP.  Test oracle."""
    size = 1 << n
    pc = popcounts(n)
    INF = np.inf
    dp = np.full(size, INF)
    dp[pc == 1] = 0.0
    for s in range(size):
        if pc[s] < 2:
            continue
        best = INF
        t = (s - 1) & s
        while t:
            v = max(dp[t], dp[s & ~t])
            if v < best:
                best = v
            t = (t - 1) & s
        dp[s] = max(best, card[s])
    return float(dp[size - 1])
