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
``rounds`` and ``passes`` are the reference's exactly.

CUDA graphs: a program on one CUDA device (no solve mesh) runs through
CUDA graphs (``lattice.uses_graphs``, decided from the bucket's key): a
graph for the search round, one for the seeded probe, one for the tail,
each part run eagerly at its first use and captured at its second
(``lattice._Graphs``).  The build's first touch runs the tail, so a
bucket's first solve captures it, and its first round, so its second
round is captured.  Capturing every prewarmed bucket at build would
cost set-up time for buckets a deployment may never use; a part's
capture costs about one eager run of it plus the graph's instantiation,
once.  ``graph_captures``
counts the programs captured, ``graph_calls`` the program calls that
replayed graphs, and each ``DispatchRecord`` says whether its call did
(``graphed``).  CPU programs, sharded ones and the host engine run
eagerly.

Dispatch profile (the reference's ``DispatchRecord`` ring): each solve
has one recording site (``_run``), which appends one record per program
call.  ``compile_s`` is the build of the bucket's program and its static
device tables on a ``get_program`` miss: the build runs the new
program once on placeholder inputs (``_first_touch``), so the search
buffers, gather tables and, on the kernel tier, the kernel library's
``nvcc`` build are paid there and not in a solve; 0.0 on a hit.
``execute_s`` is the wall time of the program call up to a finished
device result (``torch.cuda.synchronize`` before the clock is read).
It splits into ``sync_s``, the host's time blocked on the device (the
search loop's condition reads, ``lattice.blocked_s``, and the final
synchronize), and ``launch_s``, the rest: the host issuing the
program's launches.  In a graphed call ``launch_s`` is the input
copies, the replays (and a capture, once per part) and the result
copies, and ``sync_s`` holds the device time: each loop read waits for
the round the replay queued.  Around the call, ``prepare_s`` is the
host's time from the entry point (``fused_dpconv_max``/``fused_ccap``/
``fused_out``) to the call, less a build (candidate tables, padding,
adjacency bitmasks, the seed bracket, the uploads), ``readback_s`` the
copies of the results to the host and ``trees_s`` the join trees'
assembly; ``queries`` is the real (unpadded) row count and
``t0_ns``/``t1_ns`` bound the call on ``time.time_ns()``'s clock, the
one ``torch.profiler`` stamps, so a record lies over a profiled device
trace.  A call with a (min,+) sweep
(``cap``, ``cap_conn``, ``out``) also reports ``sweep_sets``, the sets of
layers 2..n over its rows that passed the sweep's gate (counted on the
device, ``lattice.live_sets``, and read back with the optima), and
``sweep_total``, all the sets of those layers times its rows; a connected
sweep (``cap_conn``, ``out``) reports ``sweep_pairs``, the valid splits
``(T, S\\T)`` it found (T holding S's lowest relation, both halves
connected) in the sets it evaluated, counted on the device by the
(min,+) kernel (the gather sweep from its masks): an unseeded ``out``
row's #ccp, whatever enumerates it, summed over the rows; 0 elsewhere.
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

Sharding (``shards = D > 1``): the solve runs over the D-device solve
mesh of ``solve_mesh`` (``launch.mesh``) led by ``device``; the direct
layers of the search and every (min,+) layer partition their sets over
the mesh, each shard's block landing in one layer on the lead device
(``core.lattice``).  Still one program call, with the same inputs,
outputs and results.  The mesh's width and its device names extend the
program-cache key, so programs of different meshes never alias, and
each ``DispatchRecord`` carries them
(``shards``, ``devices``: one name per mesh slot).  ``sharded_ceiling``
says how far a D-way mesh lifts the server's fused cap/out ceilings.

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
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
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
        "graph_calls",         # program calls that replayed CUDA graphs
        "graph_captures",      # programs whose CUDA graphs were captured
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
    shards: int = 1            # solve-mesh width (1 = single device)
    devices: tuple = ()        # one device name per mesh slot
    lane: "int | None" = None  # serving lane that issued the dispatch
    queries: int = 0           # real (unpadded) rows
    prepare_s: float = 0.0     # host prep before the call, less a build
    launch_s: float = 0.0      # host time in the call, not blocked
    sync_s: float = 0.0        # host time in the call blocked on the device
    readback_s: float = 0.0    # result copies to the host
    trees_s: float = 0.0       # join trees from the copied split arrays
    t0_ns: int = 0             # the call's interval, epoch nanoseconds
    t1_ns: int = 0
    graphed: bool = False      # the call replayed the program's CUDA graphs
    sweep_sets: int = 0        # sets the (min,+) sweep evaluated (gated on)
    sweep_total: int = 0       # sets of its layers 2..n times the rows
    sweep_pairs: int = 0       # valid splits of a connected sweep (#ccp)

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


_SOLVE_MESHES: dict = {}


def solve_mesh(shards: int, device=None) -> tuple:
    """The cached 1-D solve mesh of ``shards`` devices led by ``device``
    (CUDA unless given; one per width, lead device and forced device
    count)."""
    lead = mesh_mod.lead_device(device)
    key = (int(shards), str(lead), mesh_mod.forced_device_count())
    m = _SOLVE_MESHES.get(key)
    if m is None:
        m = _SOLVE_MESHES[key] = mesh_mod.make_solve_mesh(shards, lead)
    return m


def _mesh_identity(shards: int, device) -> tuple:
    """The device identity appended to every program-cache key and
    stamped on ``DispatchRecord.devices``: one device name per mesh slot,
    ``(str(device),)`` for a single-device solve.  Sharded and
    single-device programs, or one width on different devices, never
    alias."""
    if shards > 1:
        return mesh_mod.mesh_fingerprint(solve_mesh(shards, device))
    return (str(torch.device(device)),)


def sharded_ceiling(base_n: int, shards: int) -> int:
    """How far a D-way solve mesh lifts a fused-tier ``n`` ceiling.

    The ceiling is per-device memory on the dominant (min,+) layer
    tensor ``C(n,k)·2^k`` ≈ 3^n/√n; sharding divides it by D, and each
    +1 in n multiplies it by 3, so D devices buy ~log₃(D) extra
    relations; claim a conservative +1 per doubling, clamped at the
    int32 and extraction tier bound n = 15 (as the reference does).
    The lift never lowers a ceiling: a base above the clamp stays."""
    if shards <= 1:
        return base_n
    return max(base_n,
               min(base_n + max(0, int(shards).bit_length() - 1), 15))


def get_program(n: int, B: int, C: int, tier: str, direct_layers: int,
                extract: bool, gamma_batch: int, device: torch.device,
                cost: str = "max", shards: int = 1):
    """The whole-solve program of one bucket, keyed by ``(n, B, C, tier,
    direct_layers, extract, cost, gamma_batch, device, shards,
    mesh identity)``; it keeps its static device tables across calls.
    ``cost`` is ``"max"``, ``"cap"``, ``"cap_conn"`` (pass 2 under
    connected-split masks) or ``"out"`` (keyed with ``C = 0``, tier
    ``"f64"`` and G = 1: it searches nothing), each with an optional
    ``"_seeded"`` suffix: the warm-start variant, in a slot of its own.
    ``shards > 1`` builds the program over ``solve_mesh(shards,
    device)``."""
    return _program(n, B, C, tier, direct_layers, extract, gamma_batch,
                    device, cost, shards)[0]


def _program(n: int, B: int, C: int, tier: str, direct_layers: int,
             extract: bool, gamma_batch: int, device, cost: str,
             shards: int = 1):
    """Cache lookup, and on a miss the build: ``(fn, meta, hit)``.  A
    miss calls the compile-fault hook, builds the program and touches it
    once (``_first_touch``) under one lock, so two lanes never build one
    bucket twice and nobody runs a program before its tables exist.
    ``meta`` carries the key, the mesh and the build seconds."""
    device = torch.device(device)
    shards = max(1, int(shards))
    key = (n, B, C, tier, direct_layers, bool(extract), cost, gamma_batch,
           str(device), shards, _mesh_identity(shards, device))
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
    (n, B, C, tier, direct_layers, extract, cost, gamma_batch, _, shards,
     devs) = key
    if _COMPILE_FAULT_HOOK is not None:
        _COMPILE_FAULT_HOOK(n=n, B=B, C=C, backend=tier, cost=cost)
    _STATS.inc("exec_cache_misses")
    t0 = time.perf_counter()  # timing: measured-duration (build wall)
    seeded = cost.endswith("_seeded")
    base = cost[:-len("_seeded")] if seeded else cost
    mesh = solve_mesh(shards, device) if shards > 1 else None
    if base == "max":
        fn = lattice.build_max_program(n, direct_layers, tier, extract,
                                       gamma_batch, shards=shards,
                                       mesh=mesh, seeded=seeded,
                                       device=device)
    elif base in ("cap", "cap_conn"):
        fn = lattice.build_cap_program(n, direct_layers, tier, extract,
                                       gamma_batch,
                                       connected=base == "cap_conn",
                                       shards=shards, mesh=mesh,
                                       seeded=seeded, device=device)
    elif base == "out":
        fn = lattice.build_out_program(n, extract, shards=shards, mesh=mesh,
                                       seeded=seeded, device=device)
    else:
        raise ValueError(f"unknown fused cost {cost!r}")
    _first_touch(fn, base, seeded, n, B, C, device)
    for d in dict.fromkeys(mesh or (device,)):
        _sync(d)
    meta = {"key": key, "shards": shards, "devices": devs,
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
    (which builds the kernel library).  A graphed program runs eagerly
    here, on the static tensors of the bucket's shapes.  Nothing is
    counted."""
    size = 1 << n
    cards = torch.ones((B, size), dtype=torch.float64, device=device)
    adj = torch.as_tensor(_clique_adjacency(n), device=device).expand(
        B, n).contiguous()
    if base == "out":
        extra = (torch.zeros_like(cards),
                 torch.zeros((B, size), dtype=torch.bool, device=device)) \
            if seeded else ()
        fn(cards, adj, *extra)
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
        fn(cards, cand, lo0, hi0, 1.0, adj)


def _clique_adjacency(n: int) -> np.ndarray:
    """The (n,) int32 neighbour bitmasks of the clique over n relations
    (every set connected): the first touch's placeholder graph."""
    full = (1 << n) - 1
    return np.array([full ^ (1 << i) for i in range(n)], np.int32)


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
      each middle layer the tier's ranked convolution, a Moebius and a
      zeta; the final layer is one more convolution (and a Moebius with
      the extraction table).  The convolution at layer k takes
      ⌊(k-1)/2⌋ + [k even] products per cell, 2 operations each
      (multiply, add), reads rank slices 1..k-1 once and writes its
      table once.  A search round runs one pass over B·G rows, the seed
      verification over 2B, the extraction over B; direct-layer gathers
      add 2·Σ C(n,k)·2^k;
    * a (min,+) sweep: 2 operations per split (add, min), 3 with the
      connectivity mask, over Σ_k C(n,k)·2^k splits per row; its tables
      read and the value table written once;
    * the extraction scan: 2n-1 slots, 8 operations per cell and slot;
    * the program's own inputs and outputs, once.

    The count is the unsharded program's whatever the mesh: a sharded
    solve's replica and peer copies are not counted.
    """
    N = 1 << n
    seeded = cost.endswith("_seeded")
    base = cost[:-len("_seeded")] if seeded else cost
    s = 4 if tier == "cuda" and base != "out" else 8
    dl = min(direct_layers, n - 1)
    conv = range(max(dl + 1, 2), n + 1)      # middle layers, then layer n
    mid = len(conv) - 1
    products = sum((k - 1) // 2 + (k % 2 == 0) for k in conv)
    direct = sum(math.comb(n, k) << k for k in range(2, dl + 1))

    def feas(rows: int, full: bool) -> tuple:
        t = max(dl - 1, 0) + 2 * mid + (1 if full else 0)
        ops = rows * (t * (N // 2) * n + 2 * products * N + 2 * direct)
        nbytes = rows * s * N * (2 * t + sum(conv))
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
            extract: bool = True, device=None, shards: int = 1) -> dict:
    """Build and first-touch the program buckets a server configured for
    ``ns`` can hit, before traffic arrives: for each ``n``, every
    power-of-two batch bucket up to ``max_batch`` at the canonical
    candidate bucket (``"out"``: ``C = 0``, the f64 tier, G = 1), over a
    ``shards``-wide solve mesh.  On a CUDA device the kernel library is
    built first.  Returns ``{"compiled": k, "seconds": s}``; buckets
    already built are free."""
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
                    _program(n, b, 0, "f64", 4, extract, 1, dev, cost,
                             shards)
                else:
                    _program(n, b, candidate_bucket(n), backend,
                             direct_layers, extract, gamma_batch, dev,
                             cost, shards)
            b *= 2
    compiled = _STATS.exec_cache_misses - before
    _STATS.inc("prewarmed", compiled)
    return {"compiled": compiled,
            # timing: measured-duration (prewarm)
            "seconds": time.perf_counter() - t0}


def _run(fn, args, record: DispatchRecord, t_entry: float):
    """The single recording site of a solve: one program call, counted
    as one dispatch, timed to a finished device result (on the lead
    device, where every shard's block lands), with its record appended to the
    profile ring.  ``t_entry`` is the entry point's first clock read:
    the host prep up to the call (the ``args`` uploads included) is
    ``prepare_s``."""
    _STATS.inc("dispatches")
    dev = args[0].device
    blocked0 = lattice.blocked_s()
    replays0, captures0 = lattice.graph_counts()
    t0 = time.perf_counter()  # timing: measured-duration (execute wall)
    record.t0_ns = time.time_ns()  # timing: clock-source (profiler's clock)
    out = fn(*args)
    t_sync = time.perf_counter()  # timing: measured-duration (final sync)
    _sync(dev)
    t1 = time.perf_counter()  # timing: measured-duration (execute wall)
    record.t1_ns = time.time_ns()  # timing: clock-source (profiler's clock)
    record.execute_s = t1 - t0
    record.sync_s = (lattice.blocked_s() - blocked0) + (t1 - t_sync)
    record.launch_s = record.execute_s - record.sync_s
    record.prepare_s = t0 - t_entry - record.compile_s
    replays, captures = lattice.graph_counts()
    record.graphed = replays > replays0
    _STATS.inc("graph_calls", int(record.graphed))
    _STATS.inc("graph_captures", captures - captures0)
    _profile_append(record)
    return out


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


def _connectivity(qs, B: int, n: int, what: str) -> np.ndarray:
    """(B, n) int32 neighbour bitmasks of the query graphs, from which
    the connected programs build their connected-subset masks on the
    device (``lattice.connected_masks``).  Raises for a hyperedge graph
    (DPccp's masks are simple-edge only), a graph of another ``n`` or a
    disconnected one: the last is one reachability test of the whole
    query (O(n^2)), no pass over its 2^n sets."""
    if len(qs) != B:
        raise ValueError(f"{len(qs)} query graphs for {B} tables")
    for q in qs:
        if q.hyperedges:
            raise ValueError("DPccp connectivity masks are simple-edge "
                             "only; hyperedge queries take the "
                             "full-lattice paths")
        if q.n != n:
            raise ValueError(f"a graph of {q.n} relations for n={n}")
        if not q.is_connected(q.full_mask):
            raise ValueError(f"{what} requires connected query graphs "
                             "(DPccp excludes cross products); route "
                             "disconnected queries to the full-lattice "
                             "pipelines")
    return np.stack([q.adjacency() for q in qs]).astype(np.int32)


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


# -------------------------------------------------------------- entry point
def _cards_in(cards, n: int) -> np.ndarray:
    """The entry points' input: ``cards`` (a (B, 2^n) or (2^n,) table,
    numpy or a tensor) as a (B, 2^n) float64 array; raises unless its
    width is 2^n for n >= 2."""
    cards = host_cards(cards)
    if cards.ndim == 1:
        cards = cards[None, :]
    if cards.shape[1] != 1 << n or n < 2:
        raise ValueError(f"cards of width {cards.shape[1]} do not fit "
                         f"n={n} >= 2")
    return cards


def _solve(cost: str, n: int, Bp: int, C: int, tier: str,
           direct_layers: int, extract: bool, gamma_batch: int, dev,
           shards: int, args: tuple, B: int, seeded: int,
           t_entry: float) -> tuple:
    """The one call path of the entry points: the bucket's program (built
    on a miss), its ``DispatchRecord``, the call (``_run``) on ``args``
    (numpy arrays uploaded to ``dev``), the seed counts, the record's
    rounds and work count, the copies of the results to the host (one
    sync each), the sweep's counts (every cost but ``max``: the
    program's last result, its live sets and valid splits), the trees
    of the ``B`` real rows and the solve's counters.  A searching
    program (every cost but ``out``) returns its rounds and syncs after
    its results.  Returns ``(host, trees, rounds, syncs)``: the result
    arrays less the sweep counts, a tree per real row (None each without
    ``extract``), the search rounds and the host syncs of the solve."""
    fn, meta, hit = _program(n, Bp, C, tier, direct_layers, extract,
                             gamma_batch, dev, cost, shards)
    rec = DispatchRecord(seq=0, cost=cost, n=n, B=Bp, C=C, backend=tier,
                         key=meta["key"], aot_cache_hit=hit,
                         compile_s=0.0 if hit else meta["compile_s"],
                         execute_s=0.0, shards=meta["shards"],
                         devices=meta["devices"], lane=current_lane(),
                         queries=B)
    rec0 = jointree.recursive_extractions()
    args = tuple(torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
                 else a for a in args)
    out = _run(fn, args, rec, t_entry)
    if seeded:
        _STATS.inc("seeded_solves")
        _STATS.inc("seeded_rows", seeded)
    rounds = syncs = 0
    if not cost.startswith("out"):
        *out, rounds, syncs = out
    rec.rounds = int(rounds)
    if not cost.startswith("max"):
        rec.sweep_total = Bp * ((1 << n) - n - 1)
    rec.flops, rec.bytes_accessed = program_work(
        n, Bp, C, cost, tier, gamma_batch, rounds, extract, direct_layers)
    t0 = time.perf_counter()  # timing: measured-duration (readback)
    host = [t.cpu().numpy() for t in out]
    rec.readback_s = time.perf_counter() - t0  # timing: measured-duration
    syncs += len(out)
    if not cost.startswith("max"):
        rec.sweep_sets, rec.sweep_pairs = (int(v) for v in host.pop())
    trees = [None] * B
    if extract:
        t0 = time.perf_counter()  # timing: measured-duration (tree assembly)
        trees = [jointree.tree_from_split_arrays(host[-2][b], host[-1][b])
                 for b in range(B)]
        rec.trees_s = time.perf_counter() - t0  # timing: measured-duration
    _STATS.inc("host_extractions",
               jointree.recursive_extractions() - rec0)
    _STATS.inc("host_syncs", syncs)
    _STATS.inc("solves")
    _STATS.inc("queries", B)
    _STATS.inc("rounds", rounds)
    return host, trees, rounds, syncs


def fused_dpconv_max(cards, n: int, direct_layers: int = 4,
                     extract_tree: bool = True, backend: str = "f64",
                     gamma_batch: int = 1, shards: int = 1,
                     seed_opt=None, device=None) -> FusedSolve:
    """Solve B same-``n`` DPconv[max] instances in one whole-solve program
    call on ``device`` (CUDA unless given).

    ``cards`` is (B, 2^n) (numpy or tensor).  ``backend`` is the
    transform tier (``"f64"`` or ``"cuda"``), ``gamma_batch = G > 1``
    probes G thresholds per round ((G+1)-ary search).  Optima and trees
    are bit-identical to B host-loop ``dpconv_max`` calls.  ``shards = D
    > 1`` runs the program over the D-device solve mesh led by
    ``device`` (still one program call, the same results).

    ``seed_opt`` — per-row cached optima from the layer cache (None
    entries cold): if any matches, the ``max_seeded`` program verifies
    each with one dual probe and collapses the bracket (one round instead
    of ~log2 C when the seed holds); results are bit-identical either
    way.
    """
    t_entry = time.perf_counter()  # timing: measured-duration (prep)
    dev = resolve_device(device)
    cards = _cards_in(cards, n)
    B = cards.shape[0]
    if gamma_batch < 1:
        raise ValueError("gamma_batch must be >= 1")
    cards_pad, cand_pad, hi0, Bp, C = _pad_candidates(cards, n)
    lo0, hi0, seeded = _seed_bracket(cand_pad, hi0, seed_opt, B)
    host, trees, rounds, syncs = _solve(
        "max_seeded" if seeded else "max", n, Bp, C, backend,
        direct_layers, extract_tree, gamma_batch, dev, shards,
        (cards_pad, cand_pad, lo0, hi0), B, seeded, t_entry)
    return FusedSolve(optima=np.asarray(host[0], np.float64)[:B],
                      trees=trees, rounds=rounds,
                      passes=rounds + (1 if extract_tree else 0),
                      dispatches=1, syncs=syncs,
                      dp=host[1][:B] if extract_tree else None,
                      seeded=seeded)


def fused_out(qs: list, cards, n: int, extract_tree: bool = True,
              shards: int = 1, seed_vals=None, seed_ok=None,
              device=None) -> FusedOutSolve:
    """Solve B same-``n`` connected C_out instances (DPccp semantics:
    connected csg/cmp pairs only, no cross products) in one program call
    on ``device`` (CUDA unless given).

    ``qs`` are the B query graphs (each row may carry another topology:
    their adjacency bitmasks are a program input, from which the program
    builds the connected-subset masks on the device), ``cards`` is
    (B, 2^n).  Every graph must be connected and simple-edge, else
    ``ValueError``.  Optima, DP tables and trees are bit-identical to B
    ``dpccp_with_tree`` calls.  ``shards = D > 1`` runs the sweep over
    the D-device solve mesh led by ``device``.

    ``seed_vals``/``seed_ok`` — (B, 2^n) cached sub-table values and
    their validity mask from the layer cache: if any row has one, the
    ``out_seeded`` program replays those entries in its sweep.  They go
    to the device once per call, not once per layer.  ``dp[S]`` is a
    pure function of the sub-problem induced on ``S``, so results never
    change.
    """
    t_entry = time.perf_counter()  # timing: measured-duration (prep)
    dev = resolve_device(device)
    cards = _cards_in(cards, n)
    B, size = cards.shape
    adj = _connectivity(qs, B, n, "fused_out")
    Bp = _next_pow2(B)
    seeded = 0
    args = (_pad_rows(cards, Bp), _pad_rows(adj, Bp))
    if seed_ok is not None and np.any(seed_ok):
        sv = np.zeros((Bp, size), np.float64)
        so = np.zeros((Bp, size), bool)
        sv[:B] = np.asarray(seed_vals, np.float64)
        so[:B] = np.asarray(seed_ok, bool)
        seeded = int(np.count_nonzero(so[:B].any(axis=1)))
        args += (sv, so)
    host, trees, _, syncs = _solve(
        "out_seeded" if seeded else "out", n, Bp, 0, "f64", 4,
        extract_tree, 1, dev, shards, args, B, seeded, t_entry)
    return FusedOutSolve(couts=np.asarray(host[0], np.float64)[:B],
                         trees=trees, dispatches=1, syncs=syncs,
                         dp=host[1][:B] if extract_tree else None,
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
    ``shards = D > 1`` runs both passes over the D-device solve mesh led
    by ``device``.

    ``seed_opt`` — per-row cached C_max optima warm-starting the pass-1
    bracket exactly as in ``fused_dpconv_max``, verification included:
    at the default slack pass 1 yields the cached value bitwise, so max-
    and cap-lane solves of one canonical query seed each other.
    """
    t_entry = time.perf_counter()  # timing: measured-duration (prep)
    dev = resolve_device(device)
    cards = _cards_in(cards, n)
    B = cards.shape[0]
    if gamma_batch < 1:
        raise ValueError("gamma_batch must be >= 1")
    cards_pad, cand_pad, hi0, Bp, C = _pad_candidates(cards, n)
    lo0, hi0, seeded = _seed_bracket(cand_pad, hi0, seed_opt, B)
    args = (cards_pad, cand_pad, lo0, hi0, float(gamma_slack))
    cost = "cap"
    if qs is not None:
        adj = _connectivity(qs, B, n, "the connected C_cap pass")
        args += (_pad_rows(adj, Bp),)
        cost = "cap_conn"
    host, trees, rounds, syncs = _solve(
        cost + ("_seeded" if seeded else ""), n, Bp, C, backend,
        direct_layers, extract_tree, gamma_batch, dev, shards, args, B,
        seeded, t_entry)
    return FusedCapSolve(gammas=np.asarray(host[0], np.float64)[:B],
                         couts=np.asarray(host[1], np.float64)[:B],
                         trees=trees, rounds=rounds, dispatches=1,
                         syncs=syncs, seeded=seeded)
