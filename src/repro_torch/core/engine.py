"""Fused engine of the port (counterpart of ``repro.core.engine``):
C_max, C_cap and connected C_out.

It pads a batch of same-``n`` queries into power-of-two buckets, keeps one
whole-solve program (``lattice.build_max_program`` / ``build_cap_program``
/ ``build_out_program``) per bucket and cost with the program's static
tables on the device, runs it, and counts what ran.

``dispatches``: the reference compiles the whole solve into one XLA
program (one ``lax.while_loop``) and counts one dispatch per batched
solve.  The port runs the same program eagerly from Python, so a solve
is many kernel launches; it still counts ONE dispatch per solve (one
call of the program), and counts separately the host synchronizations
the solve costs (``syncs``): one read of the loop condition per search
round, one for the exit test, and one per result tensor copied back.
The C_out program has no search loop: its syncs are its result copies.
``rounds`` and ``passes`` are the reference's exactly.  Capturing the loop in a
CUDA graph is later work.

Warm starts (the layer cache's seeds): ``seed_opt`` in
``fused_dpconv_max``/``fused_ccap`` encodes cached C_max optima into the
search brackets (``_seed_bracket``) and runs the ``<cost>_seeded``
program, which verifies each one with a dual probe (one round, no host
sync); ``seed_vals``/``seed_ok`` in ``fused_out`` run the ``out_seeded``
program, which replays cached sub-table values in its sweep.  Results
are bit-identical with or without seeds.

Exactness: as in the reference — feasibility values are exact {0,1}
counts (f64 to n = 26 on the ``f64`` tier, int32 to n = 15 on the
``cuda`` tier), the G = 1 probe sequence is the host loop's pivot
sequence, the (min,+) sweeps reproduce DPsub[out]'s and DPccp's f64
operations, and the extraction scan applies the host extractors'
witness rule, so optima, C_out values and trees are bit-identical to
``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import jointree, lattice
from repro_torch.core.bitset import popcounts
from repro_torch.core.dpccp import connectivity_masks
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics


# ----------------------------------------------------------------- telemetry
class EngineStats:
    """Engine counters in a ``MetricsRegistry``, thread-safe."""

    FIELDS = (
        "dispatches",          # whole-solve program calls (one per solve)
        "host_syncs",          # host reads of device values inside solves
        "solves",              # batched solves served
        "queries",             # real (un-padded) queries planned
        "rounds",              # total search rounds across solves
        "exec_cache_hits",     # program (and its device tables) reused
        "exec_cache_misses",   # shape buckets built
        "host_extractions",    # per-solve host recursions (must stay 0)
        "seeded_solves",       # solves that ran a warm-start program
        "seeded_rows",         # queries whose seed engaged in those solves
    )

    def __init__(self):
        self.registry = obs_metrics.MetricsRegistry()
        self._c = {f: self.registry.counter("engine." + f)
                   for f in self.FIELDS}

    def inc(self, field: str, k: int = 1) -> None:
        self._c[field].inc(k)

    def __getattr__(self, name):
        if name in EngineStats.FIELDS:
            return self._c[name].value
        raise AttributeError(name)

    def as_dict(self) -> dict:
        return {f: self._c[f].value for f in self.FIELDS}

    def reset(self) -> None:
        for c in self._c.values():
            c.reset()


_STATS = EngineStats()
_PROGRAMS: dict = {}


def stats() -> EngineStats:
    return _STATS


def reset_stats() -> None:
    _STATS.reset()


# ------------------------------------------------------------------ results
@dataclasses.dataclass
class FusedSolve:
    """One fused batched solve: B optima (+trees) from one program call."""
    optima: np.ndarray             # (B,) optimal C_max values
    trees: list                    # JoinTree | None per query
    rounds: int                    # search rounds (lockstep)
    passes: int                    # rounds + extraction pass, host parity
    dispatches: int = 1            # program calls (one per solve)
    syncs: int = 0                 # host syncs the solve cost
    dp: "np.ndarray | None" = None  # (B, 2^n) extraction feasibility table
    seeded: int = 0                # rows whose search bracket was seeded


@dataclasses.dataclass
class FusedOutSolve:
    """One fused batched connected-C_out solve (DPccp semantics): B optima
    and trees from one program call."""
    couts: np.ndarray              # (B,) optimal C_out, no cross products
    trees: list                    # JoinTree | None per query
    dispatches: int = 1
    syncs: int = 0
    dp: "np.ndarray | None" = None  # (B, 2^n) value table (+inf outside
    #                                 the connected sets)
    seeded: int = 0                # rows carrying cached sub-table seeds


@dataclasses.dataclass
class FusedCapSolve:
    """One fused batched C_cap solve: both passes and the extraction, one
    program call."""
    gammas: np.ndarray             # (B,) caps (= slack * optimal C_max)
    couts: np.ndarray              # (B,) optimal C_out under the cap
    trees: list                    # JoinTree | None per query
    rounds: int                    # pass-1 search rounds (lockstep)
    dispatches: int = 1
    syncs: int = 0
    seeded: int = 0                # rows whose search bracket was seeded


# ----------------------------------------------------------- program cache
def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def candidate_bucket(n: int) -> int:
    """The canonical candidate-table width for lattice size ``n``: at most
    ``2^n - n - 1`` distinct |S| >= 2 cardinalities, rounded up to a power
    of two, so the buckets are keyed by (n, B) alone."""
    return _next_pow2(max((1 << n) - n - 1, 1))


def candidate_table(card: np.ndarray, n: int) -> np.ndarray:
    """Sorted unique candidate thresholds for one query (ascending;
    gamma < c(V) is never feasible)."""
    size = 1 << n
    pc = popcounts(n)
    cand = np.unique(card[pc >= 2])
    return cand[cand >= card[size - 1]]


def _pad_candidates(cards: np.ndarray, n: int):
    """Pad B candidate tables into the (B_bucket, candidate_bucket(n))
    buffer: rows repeat their last (always-feasible) candidate; padded
    batch rows replay query 0 with a collapsed bracket."""
    B = cards.shape[0]
    cands = [candidate_table(cards[b], n) for b in range(B)]
    Bp = _next_pow2(B)
    C = candidate_bucket(n)
    cand_pad = np.ones((Bp, C), np.float64)
    hi0 = np.zeros(Bp, np.int64)
    for b, c in enumerate(cands):
        cand_pad[b, :len(c)] = c
        cand_pad[b, len(c):] = c[-1]
        hi0[b] = len(c) - 1
    return _pad_rows(cards, Bp), cand_pad, hi0, Bp, C


def get_program(n: int, B: int, C: int, tier: str, direct_layers: int,
                extract: bool, gamma_batch: int, device: torch.device,
                cost: str = "max"):
    """The whole-solve program of one bucket, keyed by ``(n, B, C, tier,
    direct_layers, extract, cost, gamma_batch, device)``; it keeps its
    static device tables across calls.  ``cost`` is ``"max"``, ``"cap"``,
    ``"cap_conn"`` (pass 2 under connected-split masks) or ``"out"``
    (keyed with ``C = 0``, tier ``"f64"`` and G = 1: it searches
    nothing), each with an optional ``"_seeded"`` suffix: the warm-start
    variant, in a slot of its own."""
    key = (n, B, C, tier, direct_layers, bool(extract), cost, gamma_batch,
           str(device))
    fn = _PROGRAMS.get(key)
    if fn is not None:
        _STATS.inc("exec_cache_hits")
        return fn
    seeded = cost.endswith("_seeded")
    base = cost[:-len("_seeded")] if seeded else cost
    if base == "max":
        fn = lattice.build_max_program(n, direct_layers, tier, extract,
                                       gamma_batch, seeded=seeded)
    elif base in ("cap", "cap_conn"):
        fn = lattice.build_cap_program(n, direct_layers, tier, extract,
                                       gamma_batch,
                                       connected=base == "cap_conn",
                                       seeded=seeded)
    elif base == "out":
        fn = lattice.build_out_program(n, extract, seeded=seeded)
    else:
        raise ValueError(f"unknown fused cost {cost!r}")
    _STATS.inc("exec_cache_misses")
    _PROGRAMS[key] = fn
    return fn


def host_cards(cards) -> np.ndarray:
    """A (B, 2^n) or (2^n,) cardinality table — numpy or a tensor — as a
    float64 numpy array (candidate tables are built on the host, as in
    the reference)."""
    if isinstance(cards, torch.Tensor):
        cards = cards.detach().to("cpu", torch.float64).numpy()
    return np.asarray(cards, np.float64)


def _pad_rows(a: np.ndarray, Bp: int) -> np.ndarray:
    """Pad a (B, ...) batch to Bp rows by repeating row 0."""
    B = a.shape[0]
    if Bp == B:
        return a
    return np.concatenate([a, np.repeat(a[:1], Bp - B, axis=0)], axis=0)


def _connectivity(qs, B: int, what: str) -> np.ndarray:
    """(B, 2^n) connected-subset masks of the query graphs; raises for a
    hyperedge graph (``connectivity_masks``) or a disconnected one."""
    if len(qs) != B:
        raise ValueError(f"{len(qs)} query graphs for {B} tables")
    conn = np.stack([connectivity_masks(q) for q in qs])
    if not conn[:, -1].all():
        raise ValueError(f"{what} requires connected query graphs (DPccp "
                         "excludes cross products); route disconnected "
                         "queries to the full-lattice pipelines")
    return conn


def reject_unported(shards: int) -> None:
    """Raise for what the port does not carry yet: a solve mesh wider
    than one device."""
    if shards != 1:
        raise NotImplementedError("shards > 1 is not ported yet")


def _seed_bracket(cand_pad: np.ndarray, hi0: np.ndarray, seed_opt,
                  B: int):
    """Encode cached optima as warm-start hypotheses in the brackets.

    ``seed_opt`` is a length-B sequence of cached C_max optima (None or
    non-finite: no seed for that row).  A seed engages only when it
    equals a candidate of the row's live range exactly (f64 equality, so
    seeds travel as Python floats); the row is then encoded ``lo0 =
    -(idx + 1)`` with the full bracket kept in ``hi0``, and the seeded
    program verifies the hypothesis on the device before collapsing.  A
    stale seed only shrinks the bracket.  Returns ``(lo0, hi0,
    rows_seeded)``."""
    lo0 = np.zeros_like(hi0)
    hits = 0
    if seed_opt is None:
        return lo0, hi0, hits
    for b in range(min(B, len(seed_opt))):
        v = seed_opt[b]
        if v is None or not np.isfinite(v):
            continue
        row = cand_pad[b]
        idx = int(np.searchsorted(row[:hi0[b] + 1], v))
        if idx <= hi0[b] and row[idx] == v:
            lo0[b] = -(idx + 1)
            hits += 1
    return lo0, hi0, hits


def _count_call(seeded: int) -> None:
    """Count one whole-solve program call (and its engaged seeds)."""
    _STATS.inc("dispatches")
    if seeded:
        _STATS.inc("seeded_solves")
        _STATS.inc("seeded_rows", seeded)


def _host(out) -> tuple:
    """Copy a program's result tensors to the host: ``(arrays, syncs)``,
    one sync per copy."""
    return [t.cpu().numpy() for t in out], len(out)


def _trees_from_arrays(nodes: np.ndarray, lidx: np.ndarray,
                       B: int) -> list:
    return [jointree.tree_from_split_arrays(nodes[b], lidx[b])
            for b in range(B)]


# -------------------------------------------------------------- entry point
def fused_dpconv_max(cards, n: int, direct_layers: int = 4,
                     extract_tree: bool = True, backend: str = "f64",
                     gamma_batch: int = 1, shards: int = 1,
                     seed_opt=None, device=None) -> FusedSolve:
    """Solve B same-``n`` DPconv[max] instances in one whole-solve program
    call on ``device`` (CUDA unless given).

    ``cards`` is (B, 2^n) (numpy or tensor).  ``backend`` is the
    transform tier (``"f64"`` or ``"cuda"``), ``gamma_batch = G > 1``
    probes G thresholds per round ((G+1)-ary search).  Optima and trees
    are bit-identical to B host-loop ``dpconv_max`` calls.

    ``seed_opt`` — per-row cached optima from the layer cache (None
    entries cold): if any matches, the ``max_seeded`` program verifies
    each with one dual probe and collapses the bracket (one round instead
    of ~log2 C when the seed holds); results are bit-identical either
    way.
    """
    reject_unported(shards)
    dev = resolve_device(device)
    cards = host_cards(cards)
    if cards.ndim == 1:
        cards = cards[None, :]
    B, size = cards.shape
    if size != 1 << n or n < 2:
        raise ValueError(f"cards of width {size} do not fit n={n} >= 2")
    if gamma_batch < 1:
        raise ValueError("gamma_batch must be >= 1")
    cards_pad, cand_pad, hi0, Bp, C = _pad_candidates(cards, n)
    lo0, hi0, seeded = _seed_bracket(cand_pad, hi0, seed_opt, B)
    fn = get_program(n, Bp, C, backend, direct_layers, extract_tree,
                     gamma_batch, dev,
                     cost="max_seeded" if seeded else "max")
    rec0 = jointree.recursive_extractions()
    out = fn(torch.as_tensor(cards_pad, device=dev),
             torch.as_tensor(cand_pad, device=dev),
             torch.as_tensor(lo0, device=dev),
             torch.as_tensor(hi0, device=dev))
    _count_call(seeded)
    *result, rounds, syncs = out
    host, copies = _host(result)
    syncs += copies
    opt = host[0]
    trees: list = [None] * B
    dpn = None
    if extract_tree:
        _, dpn, nodes, lidx = host
        dpn = dpn[:B]
        trees = _trees_from_arrays(nodes, lidx, B)
    _STATS.inc("host_extractions",
               jointree.recursive_extractions() - rec0)
    _STATS.inc("host_syncs", syncs)
    _STATS.inc("solves")
    _STATS.inc("queries", B)
    _STATS.inc("rounds", rounds)
    return FusedSolve(optima=np.asarray(opt, np.float64)[:B], trees=trees,
                      rounds=rounds,
                      passes=rounds + (1 if extract_tree else 0),
                      dispatches=1, syncs=syncs, dp=dpn, seeded=seeded)


def fused_out(qs: list, cards, n: int, extract_tree: bool = True,
              shards: int = 1, seed_vals=None, seed_ok=None,
              device=None) -> FusedOutSolve:
    """Solve B same-``n`` connected C_out instances (DPccp semantics:
    connected csg/cmp pairs only, no cross products) in one program call
    on ``device`` (CUDA unless given).

    ``qs`` are the B query graphs (each row may carry another topology:
    the connected-subset masks are a program input), ``cards`` is
    (B, 2^n).  Every graph must be connected and simple-edge, else
    ``ValueError``.  Optima, DP tables and trees are bit-identical to B
    ``dpccp_with_tree`` calls.

    ``seed_vals``/``seed_ok`` — (B, 2^n) cached sub-table values and
    their validity mask from the layer cache: if any row has one, the
    ``out_seeded`` program replays those entries in its sweep.  They go
    to the device once per call, not once per layer.  ``dp[S]`` is a
    pure function of the sub-problem induced on ``S``, so results never
    change.
    """
    reject_unported(shards)
    dev = resolve_device(device)
    cards = host_cards(cards)
    if cards.ndim == 1:
        cards = cards[None, :]
    B, size = cards.shape
    if size != 1 << n or n < 2:
        raise ValueError(f"cards of width {size} do not fit n={n} >= 2")
    conn = _connectivity(qs, B, "fused_out")
    Bp = _next_pow2(B)
    seeded = 0
    extra = ()
    if seed_ok is not None and np.any(seed_ok):
        sv = np.zeros((Bp, size), np.float64)
        so = np.zeros((Bp, size), bool)
        sv[:B] = np.asarray(seed_vals, np.float64)
        so[:B] = np.asarray(seed_ok, bool)
        seeded = int(np.count_nonzero(so[:B].any(axis=1)))
        extra = (torch.as_tensor(sv, device=dev),
                 torch.as_tensor(so, device=dev))
    fn = get_program(n, Bp, 0, "f64", 4, extract_tree, 1, dev,
                     cost="out_seeded" if seeded else "out")
    rec0 = jointree.recursive_extractions()
    out = fn(torch.as_tensor(_pad_rows(cards, Bp), device=dev),
             torch.as_tensor(_pad_rows(conn, Bp), device=dev), *extra)
    _count_call(seeded)
    host, syncs = _host(out)
    trees: list = [None] * B
    dpn = None
    if extract_tree:
        _, dpn, nodes, lidx = host
        dpn = dpn[:B]
        trees = _trees_from_arrays(nodes, lidx, B)
    _STATS.inc("host_extractions",
               jointree.recursive_extractions() - rec0)
    _STATS.inc("host_syncs", syncs)
    _STATS.inc("solves")
    _STATS.inc("queries", B)
    return FusedOutSolve(couts=np.asarray(host[0], np.float64)[:B],
                         trees=trees, dispatches=1, syncs=syncs, dp=dpn,
                         seeded=seeded)


def fused_ccap(cards, n: int, gamma_slack: float = 1.0,
               direct_layers: int = 4, extract_tree: bool = True,
               backend: str = "f64", gamma_batch: int = 1,
               qs: "list | None" = None, shards: int = 1, seed_opt=None,
               device=None) -> FusedCapSolve:
    """Solve B same-``n`` C_cap instances (Sec. 8) in one program call on
    ``device`` (CUDA unless given): the pass-1 gamma search on the
    ``backend`` tier (``"f64"`` or ``"cuda"``), the gamma-pruned (min,+)
    C_out pass and the witness-tree extraction.

    Caps, C_out values and trees are bit-identical to the host pipeline
    (``dpconv_max`` + ``baselines.dpsub(mode="out", prune_gamma=gamma)``
    + ``extract_tree_out``).  ``qs`` switches pass 2 onto the connected
    (min,+) sweep — the no-cross-products cap, bit-identical to
    ``dpconv_max`` + ``dpccp(prune_gamma=gamma)``; it requires connected
    simple-edge graphs.  A cap the connected space cannot attain yields
    ``cout = +inf``; the caller decides whether that is an error.

    ``seed_opt`` — per-row cached C_max optima warm-starting the pass-1
    bracket exactly as in ``fused_dpconv_max``, verification included:
    at the default slack pass 1 yields the cached value bitwise, so max-
    and cap-lane solves of one canonical query seed each other.
    """
    reject_unported(shards)
    dev = resolve_device(device)
    cards = host_cards(cards)
    if cards.ndim == 1:
        cards = cards[None, :]
    B, size = cards.shape
    if size != 1 << n or n < 2:
        raise ValueError(f"cards of width {size} do not fit n={n} >= 2")
    if gamma_batch < 1:
        raise ValueError("gamma_batch must be >= 1")
    cards_pad, cand_pad, hi0, Bp, C = _pad_candidates(cards, n)
    lo0, hi0, seeded = _seed_bracket(cand_pad, hi0, seed_opt, B)
    extra = ()
    cost = "cap"
    if qs is not None:
        conn = _connectivity(qs, B, "the connected C_cap pass")
        extra = (torch.as_tensor(_pad_rows(conn, Bp), device=dev),)
        cost = "cap_conn"
    if seeded:
        cost += "_seeded"
    fn = get_program(n, Bp, C, backend, direct_layers, extract_tree,
                     gamma_batch, dev, cost=cost)
    rec0 = jointree.recursive_extractions()
    out = fn(torch.as_tensor(cards_pad, device=dev),
             torch.as_tensor(cand_pad, device=dev),
             torch.as_tensor(lo0, device=dev),
             torch.as_tensor(hi0, device=dev), float(gamma_slack), *extra)
    _count_call(seeded)
    *result, rounds, syncs = out
    host, copies = _host(result)
    syncs += copies
    trees: list = [None] * B
    if extract_tree:
        trees = _trees_from_arrays(host[2], host[3], B)
    _STATS.inc("host_extractions",
               jointree.recursive_extractions() - rec0)
    _STATS.inc("host_syncs", syncs)
    _STATS.inc("solves")
    _STATS.inc("queries", B)
    _STATS.inc("rounds", rounds)
    return FusedCapSolve(gammas=np.asarray(host[0], np.float64)[:B],
                         couts=np.asarray(host[1], np.float64)[:B],
                         trees=trees, rounds=rounds, dispatches=1,
                         syncs=syncs, seeded=seeded)
