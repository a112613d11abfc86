"""Fused DPconv[max] engine of the port (counterpart of
``repro.core.engine``, max part).

It pads a batch of same-``n`` queries into power-of-two buckets, keeps one
whole-solve program (``lattice.build_max_program``) per bucket with the
program's static tables on the device, runs it, and counts what ran.

``dispatches``: the reference compiles the whole solve into one XLA
program (one ``lax.while_loop``) and counts one dispatch per batched
solve.  The port runs the same program eagerly from Python, so a solve
is many kernel launches; it still counts ONE dispatch per solve (one
call of the program), and counts separately the host synchronizations
the solve costs (``syncs``): one read of the loop condition per search
round, one for the exit test, and one per result tensor copied back.
``rounds`` and ``passes`` are the reference's exactly.  Capturing the loop in a
CUDA graph is later work.

Exactness: as in the reference — feasibility values are exact {0,1}
counts (f64 to n = 26 on the ``f64`` tier, int32 to n = 15 on the
``cuda`` tier), the G = 1 probe sequence is the host loop's pivot
sequence, and the extraction scan applies the host extractor's witness
rule, so optima and trees are bit-identical to ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import jointree, lattice
from repro_torch.core.bitset import popcounts
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
    cards_pad = cards
    if Bp != B:
        cards_pad = np.concatenate(
            [cards, np.repeat(cards[:1], Bp - B, axis=0)], axis=0)
    return cards_pad, cand_pad, hi0, Bp, C


def get_program(n: int, B: int, C: int, tier: str, direct_layers: int,
                extract: bool, gamma_batch: int, device: torch.device):
    """The whole-solve program of one bucket, keyed by ``(n, B, C, tier,
    direct_layers, extract, gamma_batch, device)``; it keeps its static
    device tables across calls."""
    key = (n, B, C, tier, direct_layers, bool(extract), gamma_batch,
           str(device))
    fn = _PROGRAMS.get(key)
    if fn is not None:
        _STATS.inc("exec_cache_hits")
        return fn
    _STATS.inc("exec_cache_misses")
    fn = _PROGRAMS[key] = lattice.build_max_program(
        n, direct_layers, tier, extract, gamma_batch)
    return fn


def host_cards(cards) -> np.ndarray:
    """A (B, 2^n) or (2^n,) cardinality table — numpy or a tensor — as a
    float64 numpy array (candidate tables are built on the host, as in
    the reference)."""
    if isinstance(cards, torch.Tensor):
        cards = cards.detach().to("cpu", torch.float64).numpy()
    return np.asarray(cards, np.float64)


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
    """
    if shards != 1:
        raise NotImplementedError("shards > 1 is not ported yet")
    if seed_opt is not None:
        raise NotImplementedError("warm-start seeds are not ported yet")
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
    fn = get_program(n, Bp, C, backend, direct_layers, extract_tree,
                     gamma_batch, dev)
    rec0 = jointree.recursive_extractions()
    out = fn(torch.as_tensor(cards_pad, device=dev),
             torch.as_tensor(cand_pad, device=dev),
             torch.zeros(Bp, dtype=torch.int64, device=dev),
             torch.as_tensor(hi0, device=dev))
    _STATS.inc("dispatches")
    *result, rounds, syncs = out
    host = [t.cpu().numpy() for t in result]
    syncs += len(host)                          # the result copies
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
                      dispatches=1, syncs=syncs, dp=dpn)
