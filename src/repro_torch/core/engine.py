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

Dispatch profile (the reference's ``DispatchRecord`` ring): each solve
has one recording site (``_run``), which appends one record per program
call.  ``compile_s`` is the build of the bucket's program and its static
device tables on a ``get_program`` miss: the build runs the new
program once on placeholder inputs (``_first_touch``), so the search
buffers, gather tables and, on the kernel tier, the kernel library's
``nvcc`` build are paid there and not in a solve; 0.0 on a hit.
``execute_s`` is the wall time of the program call up to a finished
device result (``torch.cuda.synchronize`` before the clock is read).
``flops`` and ``bytes_accessed`` are the port's own count of the work
(``program_work``), never a compiler's.  The serving runtime reads the
records of its dispatches (``dispatch_mark``/``dispatches_since``) and
each record carries the serving lane that issued it (``dispatch_lane``).

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

import collections
import dataclasses
import math
import threading
import time

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
        "prewarmed",           # programs built by prewarm()
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


@dataclasses.dataclass
class DispatchRecord:
    """Per-dispatch profile: one row per whole-solve program call,
    ring-buffered.  The serving runtime marks the ring before it hands
    work to the solver (``dispatch_mark``) and collects the records that
    landed meanwhile (``dispatches_since``)."""
    seq: int                   # monotone id (survives the ring's wrap)
    cost: str                  # "max" | "cap" | "cap_conn" | "out[_seeded]"
    n: int
    B: int                     # padded batch bucket
    C: int                     # candidate bucket (0 for the out program)
    backend: str               # the port's tier: "cuda" | "f64"
    key: tuple                 # the full program-cache bucket key
    aot_cache_hit: bool        # program reused (nothing built this call)
    compile_s: float           # program + static tables build; 0.0 on a hit
    execute_s: float           # wall time to a finished device result
    rounds: int = 0            # search rounds (filled after the solve)
    flops: float = 0.0         # the port's work count (``program_work``)
    bytes_accessed: float = 0.0
    shards: int = 1            # solve-mesh width (always 1 in the port)
    devices: tuple = ()        # (the torch device's name,)
    lane: "int | None" = None  # serving lane that issued the dispatch

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = list(self.key)
        d["devices"] = list(self.devices)
        return d


_STATS = EngineStats()
_PROGRAMS: dict = {}
_PROGRAM_META: dict = {}       # key -> {"key", "compile_s", ...}
_BUILD_LOCK = threading.Lock()
_PROFILE: collections.deque = collections.deque(maxlen=512)
_PROFILE_LOCK = threading.Lock()
_PROFILE_SEQ = 0
_COMPILE_FAULT_HOOK = None


def stats() -> EngineStats:
    return _STATS


def reset_stats() -> None:
    _STATS.reset()


def dispatch_mark() -> int:
    """Current profile sequence number; pass to ``dispatches_since``."""
    with _PROFILE_LOCK:
        return _PROFILE_SEQ


def dispatches_since(mark: int) -> "list[DispatchRecord]":
    """Profile records appended after ``mark`` (oldest first), as far
    back as the ring still holds them."""
    with _PROFILE_LOCK:
        return [r for r in _PROFILE if r.seq > mark]


def _profile_append(rec: DispatchRecord) -> None:
    global _PROFILE_SEQ
    with _PROFILE_LOCK:
        _PROFILE_SEQ += 1
        rec.seq = _PROFILE_SEQ
        _PROFILE.append(rec)
    h = _STATS.registry.histogram
    h("engine.execute_s").observe(rec.execute_s)
    if not rec.aot_cache_hit:
        h("engine.compile_s").observe(rec.compile_s)
    if rec.lane is not None:   # per-lane dimension on the dispatch count
        _STATS.registry.counter(f"engine.dispatches.lane{rec.lane}").inc()


_LANE_LOCAL = threading.local()


class dispatch_lane:
    """Context manager attributing engine dispatches to a serving lane:
    every ``DispatchRecord`` made inside carries ``lane``.  The lane
    rides a thread-local, so each executor thread has its own slot;
    nesting restores the outer value."""

    def __init__(self, lane: "int | None"):
        self.lane = lane

    def __enter__(self):
        self._prev = getattr(_LANE_LOCAL, "lane", None)
        _LANE_LOCAL.lane = self.lane
        return self

    def __exit__(self, *exc):
        _LANE_LOCAL.lane = self._prev
        return False


def current_lane() -> "int | None":
    return getattr(_LANE_LOCAL, "lane", None)


def clear_executable_cache() -> None:
    """Drop every built program (the next solve of each bucket builds it
    again, through the compile-fault hook)."""
    with _BUILD_LOCK:
        _PROGRAMS.clear()
        _PROGRAM_META.clear()


def set_compile_fault_hook(hook) -> None:
    """Chaos/test seam of the program build: ``hook(n=..., B=..., C=...,
    backend=..., cost=...)`` is called on every program-cache miss,
    before the build, and may raise to model a failed build
    (``service.faults`` wires its injector here).  ``None`` clears."""
    global _COMPILE_FAULT_HOOK
    _COMPILE_FAULT_HOOK = hook


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
    return _program(n, B, C, tier, direct_layers, extract, gamma_batch,
                    device, cost)[0]


def _program(n: int, B: int, C: int, tier: str, direct_layers: int,
             extract: bool, gamma_batch: int, device, cost: str):
    """Cache lookup, and on a miss the build: ``(fn, meta, hit)``.  A
    miss calls the compile-fault hook, builds the program and touches it
    once (``_first_touch``) under one lock, so two lanes never build one
    bucket twice and nobody runs a program before its tables exist.
    ``meta`` carries the key and the build seconds."""
    device = torch.device(device)
    key = (n, B, C, tier, direct_layers, bool(extract), cost, gamma_batch,
           str(device))
    fn = _PROGRAMS.get(key)
    if fn is None:
        with _BUILD_LOCK:
            fn = _PROGRAMS.get(key)
            if fn is None:
                return _build(key, device) + (False,)
    _STATS.inc("exec_cache_hits")
    return fn, _PROGRAM_META[key], True


def _build(key: tuple, device: torch.device):
    """Build one bucket's program (the caller holds ``_BUILD_LOCK``)."""
    n, B, C, tier, direct_layers, extract, cost, gamma_batch, _ = key
    if _COMPILE_FAULT_HOOK is not None:
        _COMPILE_FAULT_HOOK(n=n, B=B, C=C, backend=tier, cost=cost)
    _STATS.inc("exec_cache_misses")
    t0 = time.perf_counter()  # timing: measured-duration (build wall)
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
    _first_touch(fn, base, seeded, n, B, C, device)
    _sync(device)
    meta = {"key": key, "devices": (str(device),),
            # timing: measured-duration (program build + first touch)
            "compile_s": time.perf_counter() - t0}
    _PROGRAMS[key] = fn
    _PROGRAM_META[key] = meta
    return fn, meta


def _first_touch(fn, base: str, seeded: bool, n: int, B: int, C: int,
                 device) -> None:
    """Run a new program once on placeholder inputs of its bucket: all
    cardinalities 1, one candidate, a collapsed bracket (a seeded
    variant verifies a seed at candidate 0).  The search runs no round;
    the extraction, the (min,+) sweeps and the first call's buffers and
    gather tables are built, and on the kernel tier the kernels launch
    (which builds the kernel library).  Nothing is counted."""
    size = 1 << n
    cards = torch.ones((B, size), dtype=torch.float64, device=device)
    conn = torch.ones((B, size), dtype=torch.bool, device=device)
    if base == "out":
        extra = (torch.zeros_like(cards), torch.zeros_like(conn)) \
            if seeded else ()
        fn(cards, conn, *extra)
        return
    cand = torch.ones((B, C), dtype=torch.float64, device=device)
    lo0 = torch.full((B,), -1 if seeded else 0, dtype=torch.int64,
                     device=device)
    hi0 = torch.zeros(B, dtype=torch.int64, device=device)
    if base == "max":
        fn(cards, cand, lo0, hi0)
    elif base == "cap":
        fn(cards, cand, lo0, hi0, 1.0)
    else:
        fn(cards, cand, lo0, hi0, 1.0, conn)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_work(n: int, B: int, C: int, cost: str, tier: str,
                 gamma_batch: int, rounds: int, extract: bool,
                 direct_layers: int = 4) -> tuple:
    """The port's own count of one program call's work: ``(operations,
    bytes)``, from its shapes and its search rounds, with the kernel
    table's reckoning (each input of a step read once, each output
    written once).  A model, not a measurement:

    * a zeta/Moebius transform of a (rows, 2^n) table: rows·2^(n-1)·n
      adds, its table read and written once;
    * a feasibility pass: a zeta for each direct layer 2..dl, then for
      each middle layer the scan-form convolution (3 operations per slot
      and cell over n//2 slots, the ranked buffer read, the layer
      written), a Moebius and a zeta; the final layer is one more
      convolution (and a Moebius with the extraction table).  A search
      round runs one over B·G rows, the seed verification over 2B, the
      extraction over B; direct-layer gathers add 2·Σ C(n,k)·2^k;
    * a (min,+) sweep: 2 operations per split (add, min), 3 with the
      connectivity mask, over Σ_k C(n,k)·2^k splits per row; its tables
      read and the value table written once;
    * the extraction scan: 2n-1 slots, 8 operations per cell and slot;
    * the program's own inputs and outputs, once.
    """
    N = 1 << n
    seeded = cost.endswith("_seeded")
    base = cost[:-len("_seeded")] if seeded else cost
    s = 4 if tier == "cuda" and base != "out" else 8
    dl = min(direct_layers, n - 1)
    D = max(n // 2, 1)
    mid = max(n - 1 - dl, 0)
    direct = sum(math.comb(n, k) << k for k in range(2, dl + 1))

    def feas(rows: int, full: bool) -> tuple:
        t = max(dl - 1, 0) + 2 * mid + (1 if full else 0)
        ops = rows * (t * (N // 2) * n + (mid + 1) * 3 * D * N
                      + 2 * direct)
        nbytes = rows * s * N * (2 * t + (mid + 1) * (n + 2))
        return ops, nbytes

    ops = nbytes = 0
    if base in ("max", "cap", "cap_conn"):
        search = rounds - (1 if seeded and rounds else 0)
        for rows, k, full in ((B * gamma_batch, search, False),
                              (2 * B, 1 if seeded and rounds else 0,
                               False),
                              (B, 1 if extract and base == "max" else 0,
                               True)):
            o, b = feas(rows, full)
            ops += k * o
            nbytes += k * b
        nbytes += 8 * B * (N + C + 2)            # cards, cand, lo0, hi0
    if base in ("cap", "cap_conn", "out"):
        splits = sum(math.comb(n, k) << k for k in range(2, n + 1))
        conn = base != "cap"
        ops += B * splits * (3 if conn else 2)
        nbytes += B * N * (8 + (1 if conn else 0) + 8)
        if base == "out":
            nbytes += 8 * B * N                  # cards
            if seeded:
                nbytes += 9 * B * N              # seed values and mask
    if extract:
        ops += B * (2 * n - 1) * 8 * N
        nbytes += 8 * B * N + 2 * 4 * B * (2 * n - 1)   # dp; nodes, lidx
    nbytes += 8 * B * (2 if base in ("cap", "cap_conn") else 1)  # optima
    return float(ops), float(nbytes)


def prewarm(ns, max_batch: int = 16, backend: str = "f64",
            direct_layers: int = 4, costs=("max",), gamma_batch: int = 1,
            extract: bool = True, device=None) -> dict:
    """Build and first-touch the program buckets a server configured for
    ``ns`` can hit, before traffic arrives: for each ``n``, every
    power-of-two batch bucket up to ``max_batch`` at the canonical
    candidate bucket (``"out"``: ``C = 0``, the f64 tier, G = 1).  On a
    CUDA device the kernel library is built first.  Returns
    ``{"compiled": k, "seconds": s}``; buckets already built are free."""
    dev = resolve_device(device)
    t0 = time.perf_counter()  # timing: measured-duration (prewarm wall)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.library()
    before = _STATS.exec_cache_misses
    for n in ns:
        b = 1
        while b <= max_batch:
            for cost in costs:
                if cost in ("out", "out_seeded"):
                    _program(n, b, 0, "f64", 4, extract, 1, dev, cost)
                else:
                    _program(n, b, candidate_bucket(n), backend,
                             direct_layers, extract, gamma_batch, dev,
                             cost)
            b *= 2
    compiled = _STATS.exec_cache_misses - before
    _STATS.inc("prewarmed", compiled)
    return {"compiled": compiled,
            # timing: measured-duration (prewarm)
            "seconds": time.perf_counter() - t0}


def _run(fn, args, record: DispatchRecord):
    """The single recording site of a solve: one program call, counted
    as one dispatch, timed to a finished device result, with its record
    appended to the profile ring."""
    _STATS.inc("dispatches")
    dev = args[0].device
    t0 = time.perf_counter()  # timing: measured-duration (execute wall)
    out = fn(*args)
    _sync(dev)
    record.execute_s = time.perf_counter() - t0  # timing: measured-duration
    _profile_append(record)
    return out


def _record(cost: str, n: int, Bp: int, C: int, tier: str, meta: dict,
            hit: bool) -> DispatchRecord:
    return DispatchRecord(seq=0, cost=cost, n=n, B=Bp, C=C, backend=tier,
                          key=meta["key"], aot_cache_hit=hit,
                          compile_s=0.0 if hit else meta["compile_s"],
                          execute_s=0.0, devices=meta["devices"],
                          lane=current_lane())


def _finish_record(rec: DispatchRecord, rounds: int, gamma_batch: int,
                   extract: bool, direct_layers: int = 4) -> None:
    """Fill a record's rounds and work count once the solve is read."""
    rec.rounds = int(rounds)
    rec.flops, rec.bytes_accessed = program_work(
        rec.n, rec.B, rec.C, rec.cost, rec.backend, gamma_batch,
        rec.rounds, extract, direct_layers)


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


def _count_seeds(seeded: int) -> None:
    """Count a seeded program call and its engaged seeds."""
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
    cost = "max_seeded" if seeded else "max"
    fn, meta, hit = _program(n, Bp, C, backend, direct_layers, extract_tree,
                             gamma_batch, dev, cost)
    prof = _record(cost, n, Bp, C, backend, meta, hit)
    rec0 = jointree.recursive_extractions()
    out = _run(fn, (torch.as_tensor(cards_pad, device=dev),
                    torch.as_tensor(cand_pad, device=dev),
                    torch.as_tensor(lo0, device=dev),
                    torch.as_tensor(hi0, device=dev)), prof)
    _count_seeds(seeded)
    *result, rounds, syncs = out
    _finish_record(prof, rounds, gamma_batch, extract_tree, direct_layers)
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
    cost = "out_seeded" if seeded else "out"
    fn, meta, hit = _program(n, Bp, 0, "f64", 4, extract_tree, 1, dev, cost)
    prof = _record(cost, n, Bp, 0, "f64", meta, hit)
    rec0 = jointree.recursive_extractions()
    out = _run(fn, (torch.as_tensor(_pad_rows(cards, Bp), device=dev),
                    torch.as_tensor(_pad_rows(conn, Bp), device=dev))
               + extra, prof)
    _count_seeds(seeded)
    _finish_record(prof, 0, 1, extract_tree)
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
    fn, meta, hit = _program(n, Bp, C, backend, direct_layers, extract_tree,
                             gamma_batch, dev, cost)
    prof = _record(cost, n, Bp, C, backend, meta, hit)
    rec0 = jointree.recursive_extractions()
    out = _run(fn, (torch.as_tensor(cards_pad, device=dev),
                    torch.as_tensor(cand_pad, device=dev),
                    torch.as_tensor(lo0, device=dev),
                    torch.as_tensor(hi0, device=dev), float(gamma_slack))
               + extra, prof)
    _count_seeds(seeded)
    *result, rounds, syncs = out
    _finish_record(prof, rounds, gamma_batch, extract_tree, direct_layers)
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
