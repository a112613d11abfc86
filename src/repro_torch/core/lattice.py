"""The lattice-program layer of the port: the paper's layered DP (Alg. 1)
instantiated per cost function, and the whole-solve programs built on
it.  Counterpart of ``repro.core.lattice``, with the same names and the
same arithmetic, so results are bitwise those of the reference.

Semirings: *feasibility* — {0,1} counting in (+,·), thresholded per
layer (``feasibility_layers``, C_max); *value* — (min,+) over f64 under
a gamma gate (``minplus_value_layers``, the C_cap pass 2); *connected
value* — the same sweep under per-subset valid-split masks, DPccp's
search space as bitset tensors (``minplus_connected_layers``, C_out).
The connected programs take each query's adjacency bitmasks and build
those masks on the device inside the call (``connected_masks``: the
``connmask`` kernel on a card), so no 2^n table of a solve is made on
the host.
The (min,+) sweeps have no transform shortcut (that hardness is the
paper's point): every layer enumerates its splits directly, in f64 on
either tier.  On one CUDA device without a solve mesh each layer is one
launch of the table-free ``minplus_layer`` kernel (``kernels.minplus``),
which skips gated-off sets before any split; on CPU tensors and over a
mesh each layer gathers its split table (``direct_layer_tables``), the
plain version.  Both give the same values, bit for bit.

Transform tiers (``transforms``), used by the feasibility recursion;
each owns its ranked convolution, which every pass takes at every middle
layer and at the final one:

========= ============================================== ================
port      what                                            in ``repro``
========= ============================================== ================
``f64``   float64 counting: zeta/Moebius through the      ``"xla"``
          CUDA kernels (``kernels.ops``; the plain
          butterflies of ``core.zeta`` on CPU
          tensors), bitwise the butterflies, and the
          plain convolution
          (``kernels.ref.ranked_conv_ref``), exact
          counts to n = 26
``cuda``  int32 counting through the CUDA kernels         ``"pallas"``
          (``kernels.ops``: zeta/Moebius and
          ``ranked_conv``; plain versions on CPU
          tensors), exact to n = 15
========= ============================================== ================

Differences from the reference, none of which changes a result:

* JAX's ``lax.fori_loop``/``while_loop`` are Python loops over device
  tensors.  The search loop reads ``any(lo < hi)`` on the host once per
  round (one sync per round); the reference runs the loop on device.
  The seconds the host spends blocked in those reads accumulate per
  thread in ``blocked_s()``, which the engine reads around a call.
* Where XLA compiles a program once, a program on one CUDA device
  (``uses_graphs``: no solve mesh) runs through CUDA graphs
  (``_Graphs``): the search round (``_search_round``), the seeded
  probe (``_verify_round``) and the tail (extraction pass and scan;
  C_cap's pass 2; C_out's whole call), each run eagerly at its first
  use and captured at its second.  A call copies its inputs into the
  program's static tensors, replays the round graph once per round
  between the host reads, replays the tail and returns copies of its
  outputs.  The captured bodies are the eager ones, so rounds, syncs
  and results are the eager call's.  CPU and sharded programs run
  eagerly.
* Buffers are updated in place (the ranked-zeta buffer ``Z`` above all:
  each zeta transform writes straight into its slot; each (min,+) layer
  writes its sets into ``dp``; each round writes the bracket ``lo``/``hi``);
  JAX rebuilds them functionally.
* The layer index is a Python int in every loop, so the feasibility
  recursion has one middle-layer form in every program, the reference's
  unrolled one.  The reference's fused programs take its scan form,
  which ``fori_loop``'s traced index needs, and sum int32 products in
  int64 there.  Both forms are exact, so the counts agree.
* Bracket indices (``lo``, ``hi``, pivots) are int64 tensors (PyTorch
  gathers take int64); the reference keeps int32.  Values are equal.

Warm starts, as in the reference: ``feasibility_layers(seed_layers=)``
replays a solved layer prefix, ``minplus_connected_layers(seed_vals=,
seed_ok=)`` replays cached sub-table values, and the ``seeded`` program
variants verify a cached C_max optimum with one dual probe before the
search (``_verify_round``, run by ``_fused_search``).

Sharding, as in the reference's ``shard_map`` programs: a program built
with ``shards = D`` and a solve mesh (``launch.mesh``, a tuple of D
devices, lead first) partitions the sets axis of every direct layer —
the feasibility recursion's direct layers and every layer of the (min,+)
sweeps — into D blocks of consecutive rows, the reference's blocks less
its pad rows.  One controller drives the mesh: inputs and outputs stay
on the lead device, which runs everything replicated (the middle layers'
transforms, gates, search, extraction).  In a sharded layer shard d
evaluates its block in row-chunks on its device, from its replica of
``dp``, and its values are written at its own sets of one layer on the
lead device.  The blocks are disjoint, so this is what the reference's
``psum`` of zero-filled partials (``pmin`` of +inf-filled ones) gives,
without D full-size partials, their merge or pad rows; per set the whole
split axis stays on one shard, so results are bitwise those of the
unsharded sweep.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time

import numpy as np
import torch

from repro_torch.core.bitset import layer_indices, popcounts, submask_table

# ------------------------------------------------------------- transforms
@dataclasses.dataclass(frozen=True)
class Transforms:
    """The transform backend of a lattice program: zeta/Moebius pair
    (``f -> table``; ``out=`` writes the table into a given contiguous
    tensor, such as a slot of the ranked buffer), the layer-k ranked
    convolution (``(Z, k) -> table``, the symmetry-halved
    ``Σ_{d=1..k-1} Z[d] Z[k-d]``) and the DP dtype they are exact in."""
    name: str
    zeta: callable
    mobius: callable
    dtype: torch.dtype
    ranked_conv: callable


def transforms(tier: str) -> Transforms:
    """The two transform tiers (see the module docstring)."""
    if tier == "f64":
        from repro_torch.kernels.ops import mobius_op, zeta_op
        from repro_torch.kernels.ref import ranked_conv_ref
        return Transforms("f64", zeta_op, mobius_op, torch.float64,
                          ranked_conv_ref)
    if tier == "cuda":
        # int32 counting tier: exact while counts < 2^31 (n <= 15),
        # enforced by the caller (BatchPolicy.kernel_max_n)
        from repro_torch.kernels.ops import (mobius_batch_op,
                                             ranked_conv_op, zeta_batch_op)
        return Transforms("cuda", zeta_batch_op, mobius_batch_op,
                          torch.int32, ranked_conv_op)
    raise ValueError(f"unknown lattice tier {tier!r}")


# ------------------------------------------------- static tables
@functools.lru_cache(maxsize=128)
def direct_layer_indices(n: int, k: int):
    """Static gather tables for direct evaluation of layer k (numpy):
    sets (m,) int64 masks with |S| = k; subs/comps (m, 2^k) submask /
    complement-in-S tables.  The rows T = 0 / T = S are neutralized by
    dp[∅] = 0."""
    sets = layer_indices(n)[k]
    subs = submask_table(sets, k).T          # (m, 2^k)
    comps = sets[:, None] & ~subs
    return (sets, subs, comps)


_DEVICE_TABLES: dict = {}


def _on_device(key, make):
    """Immutable per-device tables, built once per (table, device)."""
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = _DEVICE_TABLES[key] = make()
    return t


def popcounts_on(n: int, device) -> torch.Tensor:
    """popcounts(n) as an int32 tensor on ``device``."""
    device = torch.device(device)
    return _on_device(("pc", n, str(device)), lambda: torch.as_tensor(
        popcounts(n), dtype=torch.int32, device=device))


def direct_layer_tables(n: int, k: int, device):
    """``direct_layer_indices`` as int64 tensors on ``device``."""
    device = torch.device(device)
    return _on_device(("direct", n, k, str(device)), lambda: tuple(
        torch.as_tensor(a, dtype=torch.int64, device=device)
        for a in direct_layer_indices(n, k)))


def layer_sets_on(n: int, device) -> torch.Tensor:
    """The 2^n masks ordered by popcount (``kernels.minplus.layer_sets``)
    as an int32 tensor on ``device``: the sets of every layer of the
    kernel sweep, one table per n."""
    from repro_torch.kernels.minplus import layer_sets
    device = torch.device(device)
    return _on_device(("layer_sets", n, str(device)),
                      lambda: torch.as_tensor(layer_sets(n), device=device))


# The sharded layer sweeps gather at most this many elements per batch
# row per chunk (rows_per_chunk = SHARD_CHUNK_ELEMS >> k), bounding the
# (..., rows, 2^k) working set on each device regardless of layer width.
SHARD_CHUNK_ELEMS = 1 << 21


def shard_block(m: int, shards: int) -> int:
    """Rows of each shard's block when ``m`` layer rows split ``shards``
    ways (the last block may be shorter, or empty)."""
    return -(-m // shards)


@functools.lru_cache(maxsize=128)
def sharded_layer_indices(n: int, k: int, shards: int):
    """The reference's padded layout of ``direct_layer_indices``: the
    sets axis padded so it splits into ``shards`` equal blocks (shard d
    takes rows [d*blk, (d+1)*blk)), pad rows pointing at index 0 (the
    empty set).  The sharded sweeps take the same blocks less the pad
    rows (``_shard_chunks``).  Returns (sets, subs, comps, blk), numpy."""
    sets, subs, comps = direct_layer_indices(n, k)
    m = sets.shape[0]
    blk = shard_block(m, shards)
    pad = blk * shards - m
    if pad:
        sets = np.concatenate([sets, np.zeros(pad, sets.dtype)])
        subs = np.concatenate(
            [subs, np.zeros((pad, subs.shape[1]), subs.dtype)])
        comps = np.concatenate(
            [comps, np.zeros((pad, comps.shape[1]), comps.dtype)])
    return (sets, subs, comps, blk)


def _shard_chunks(n: int, k: int, mesh, chunk: int):
    """Every shard's row-chunks of the layer-k gather tables, shard by
    shard: yields ``(device, lead_sets, (sets, subs, comps))`` for chunks
    of at most ``chunk >> k`` rows of shard d's block, ``lead_sets`` the
    chunk's sets on the lead device and the tables on ``mesh[d]``.  A
    shard on the lead device slices the lead's tables; a shard on
    another device holds a copy of its own block only."""
    lead = mesh[0]
    tables = direct_layer_tables(n, k, lead)
    m = tables[0].shape[0]
    blk = shard_block(m, len(mesh))
    rows = max(1, chunk >> k)
    for d, dev in enumerate(mesh):
        lo_d, hi_d = d * blk, min((d + 1) * blk, m)
        if lo_d >= hi_d:
            continue
        own, off = tables, 0
        if dev != lead:
            own = _on_device(("shard", n, k, len(mesh), d, str(dev)),
                             lambda: tuple(t[lo_d:hi_d].to(dev)
                                           for t in tables))
            off = lo_d
        for lo in range(lo_d, hi_d, rows):
            hi = min(lo + rows, hi_d)
            yield dev, tables[0][lo:hi], tuple(t[lo - off:hi - off]
                                               for t in own)


def _replicas(mesh, *tensors) -> dict:
    """``tensors`` on each distinct device of ``mesh``: the given
    storage where it already lies, a (peer) copy elsewhere.  A mesh that
    repeats one device copies nothing."""
    out: dict = {}
    for dev in mesh:
        if dev not in out:
            out[dev] = tuple(t if t.device == dev else t.to(dev)
                             for t in tensors)
    return out


# ------------------------------------------------------ layer primitives
def direct_layer_full(dp, gate, n: int, k: int, pc, dtype):
    """Layer k by gather-based split enumeration (paper Sec. 6): full
    (..., 2^n) indicator of gated layer-k sets with a feasible split."""
    sets, subs, comps = direct_layer_tables(n, k, dp.device)
    prod = dp[..., subs] * dp[..., comps]          # (..., m, 2^k)
    layer_ind = (prod.sum(dim=-1) > 0.5).to(dtype)
    layer_full = torch.zeros(dp.shape, dtype=dtype, device=dp.device)
    layer_full[..., sets] = layer_ind
    layer_full = layer_full * gate
    return torch.where(pc == k, layer_full, torch.zeros((), dtype=dtype,
                                                        device=dp.device))


def direct_layer_full_sharded(dp, gate, n: int, k: int, pc, dtype, mesh,
                              chunk: int = SHARD_CHUNK_ELEMS):
    """``direct_layer_full`` over a solve mesh: each shard evaluates its
    block of layer-k sets (chunked gathers) from its replica of ``dp``,
    and its indicators are written at its own sets of one zero layer on
    the lead device (the reference's ``psum`` of disjoint blocks).
    ``dp`` is only read.  Bit-identical to the unsharded form."""
    dps = _replicas(mesh, dp)
    layer_full = torch.zeros(dp.shape, dtype=dtype, device=dp.device)
    for dev, ss, (sets, subs, comps) in _shard_chunks(n, k, mesh, chunk):
        dpd = dps[dev][0]
        prod = dpd[..., subs] * dpd[..., comps]    # (..., rows, 2^k)
        layer_full[..., ss] = (prod.sum(dim=-1) > 0.5).to(dtype).to(
            dp.device)
    layer_full = layer_full * gate
    return torch.where(pc == k, layer_full, torch.zeros((), dtype=dtype,
                                                        device=dp.device))


def moebius_at_v(acc, pc, n: int):
    """Moebius transform evaluated at the single point V: the signed
    O(2^n) sum Σ_T (-1)^{n-|T|} conv[T], reduced in f64 (exact integers,
    so the order of the sum does not matter)."""
    sign = 1.0 - 2.0 * ((n - pc) % 2).to(torch.float64)     # ±1
    return torch.sum(acc.to(torch.float64) * sign, dim=-1)


# --------------------------------------------- the feasibility recursion
def feasibility_layers(gate, n: int, direct_layers: int = 4,
                       tfm: "Transforms | None" = None,
                       final_shortcut: bool = True, Z=None,
                       seed_layers=None, mesh=None,
                       shard_chunk: int = SHARD_CHUNK_ELEMS):
    """One full layered feasibility DP under ``gate`` (paper Sec. 5 + 6).

    Returns ``(dp, Z, feas)``: the accumulated feasibility table, the
    ranked-zeta buffer, and the boolean feasibility of the full set V.
    With ``final_shortcut`` the final layer is evaluated only at V
    (Moebius-at-V) and ``dp`` carries no layer-n entries; otherwise the
    full final butterfly runs (the tree-extraction table).

    ``gate`` (..., 2^n) may carry any leading batch axes.  ``Z`` — the
    carried ``(n+1, ..., 2^n)`` ranked-zeta buffer, updated in place;
    slot Z[1] (the singleton transform) must already be set.  ``Z=None``
    allocates fresh.  Layers 2..min(direct_layers, n) are enumerated
    directly; every later layer is the tier's ranked convolution
    (``tfm.ranked_conv``) and a Moebius transform.  The fused programs
    pass ``direct_layers <= n - 1``, so their final layer is always a
    convolution.

    ``seed_layers`` — the warm start: a ``(k0, dp_seed)`` pair where
    ``dp_seed`` (broadcastable to ``gate``) is an accumulated feasibility
    table whose layer slices ``dp_seed * [pc == k]`` are valid for this
    gate for every ``k <= k0``.  Layers ``2..k0`` are replayed from the
    seed (one select and one zeta each) instead of enumerated.  A seed
    transfers exactly when the gate over sets of size ``<= k0`` matches
    the run that produced it; seeded and cold runs are then
    bit-identical.

    ``mesh`` (a solve mesh, lead device first) partitions the *direct*
    layers' gather sweep across its devices, one sum per layer
    (``direct_layer_full_sharded``).  The transform layers stay on the
    lead device: a zeta transform reads the whole lattice.
    """
    tfm = tfm or transforms("f64")
    size = 1 << n
    dev = gate.device
    pc = popcounts_on(n, dev)
    dtype = tfm.dtype
    batch = tuple(gate.shape[:-1])
    zero = torch.zeros((), dtype=dtype, device=dev)

    singles = (pc == 1).to(dtype).expand(batch + (size,)).contiguous()
    dp = singles.clone()
    if Z is None:
        Z = torch.zeros((n + 1,) + batch + (size,), dtype=dtype,
                        device=dev)
        tfm.zeta(singles, out=Z[1])

    dl = min(direct_layers, n)
    start_k = 2
    if seed_layers is not None:                # warm-start solved prefix
        k0, dp_seed = seed_layers
        k0 = min(int(k0), n - 1)
        seed_t = torch.as_tensor(dp_seed, device=dev).to(dtype) \
            .expand(dp.shape)
        for k in range(2, k0 + 1):
            layer_full = torch.where(pc == k, seed_t, zero)
            dp = dp + layer_full
            if k < n:
                tfm.zeta(layer_full, out=Z[k])
        start_k = max(2, k0 + 1)
    for k in range(start_k, dl + 1):           # direct small layers
        if mesh is not None:
            layer_full = direct_layer_full_sharded(dp, gate, n, k, pc,
                                                   dtype, mesh, shard_chunk)
        else:
            layer_full = direct_layer_full(dp, gate, n, k, pc, dtype)
        dp = dp + layer_full
        if k < n:
            tfm.zeta(layer_full, out=Z[k])
    if dl >= n:                                # all-direct (small n)
        return dp, Z, dp[..., -1] > 0.5

    for k in range(max(dl + 1, 2), n):         # middle layers
        conv = tfm.ranked_conv(Z, k)
        h = tfm.mobius(conv, out=conv)         # conv is a fresh table
        layer_full = torch.where(pc == k, (h > 0.5).to(dtype) * gate, zero)
        dp = dp + layer_full
        tfm.zeta(layer_full, out=Z[k])
    acc = tfm.ranked_conv(Z, n)

    if final_shortcut:
        count_v = moebius_at_v(acc, pc, n)
        feas = (count_v > 0.5) & (gate[..., -1] > zero)
        return dp, Z, feas
    h = tfm.mobius(acc, out=acc)
    layer_full = torch.where(pc == n, (h > 0.5).to(dtype) * gate, zero)
    dp = dp + layer_full
    return dp, Z, dp[..., -1] > 0.5


# ------------------------------------------------- the (min,+) semiring
def _minplus_init(card, n: int):
    """dp of the (min,+) sweeps before layer 2: singletons cost 0, every
    other set (the empty one included: it neutralizes the T = ∅ / T = S
    rows of each split table) is +inf."""
    pc = popcounts_on(n, card.device)
    dp = torch.where(pc == 1, 0.0, float("inf")).to(torch.float64)
    return dp.expand(card.shape).contiguous()


def _minplus_sweep(card, n: int, layer, inputs: tuple, mesh, chunk: int):
    """The layer loop of both (min,+) sweeps: ``layer(dp, sets, subs,
    comps, *inputs)`` gives layer k's values at ``sets`` from the gather
    tables of those rows, and they are written into ``dp``.  Over a mesh
    each shard evaluates its row-chunks on its device, from a replica of
    ``dp`` taken at the layer's start (the lead shard reads ``dp``
    itself), and its values are written at its own sets on the lead
    device (the reference's ``pmin`` of disjoint blocks).  Layer k reads
    only sets smaller than k, so no shard sees another's writes."""
    dp = _minplus_init(card, n)
    if mesh is None:
        for k in range(2, n + 1):
            sets, subs, comps = direct_layer_tables(n, k, card.device)
            dp[..., sets] = layer(dp, sets, subs, comps, *inputs)
        return dp
    static = _replicas(mesh, *inputs)
    for k in range(2, n + 1):
        dps = _replicas(mesh, dp)
        for dev, ss, tabs in _shard_chunks(n, k, mesh, chunk):
            dp[..., ss] = layer(dps[dev][0], *tabs, *static[dev]).to(
                dp.device)
    return dp


def _uses_kernel(card, mesh) -> bool:
    """Whether a (min,+) sweep runs the ``minplus_layer`` kernel: on one
    CUDA device, with no solve mesh."""
    return mesh is None and card.device.type == "cuda"


def _kernel_sweep(card, n: int, ok, conn=None, seed_vals=None,
                  seed_ok=None, pairs=None):
    """A (min,+) sweep as one ``minplus_layer`` launch per layer 2..n,
    in place on a fresh ``dp``: no split table is built.  ``ok`` gates
    each set, ``conn`` (connected sweeps) checks both sides of each
    split, ``seed_ok``/``seed_vals`` replace the values of seeded
    sets, and ``pairs`` gains the valid splits the kernel counts."""
    from repro_torch.kernels.minplus import layer_offsets, minplus_layer
    dp = _minplus_init(card, n)
    card, ok, conn, seed_vals, seed_ok = (
        None if t is None else t.contiguous()
        for t in (card, ok, conn, seed_vals, seed_ok))
    sets = layer_sets_on(n, card.device)
    offs = layer_offsets(n)
    for k in range(2, n + 1):
        minplus_layer(dp, card, ok, sets[offs[k]:offs[k + 1]], n, k, conn,
                      seed_vals, seed_ok, pairs)
    return dp


def live_sets(ok, n: int, seed_ok=None) -> torch.Tensor:
    """The sets of layers 2..n, summed over the rows, that a sweep
    gated by ``ok`` evaluates: gated on and not seeded.  A 0-dim int64
    tensor on ``ok``'s device, counted there (no host read)."""
    live = ok & (popcounts_on(n, ok.device) >= 2)
    if seed_ok is not None:
        live = live & ~seed_ok
    return live.sum(dtype=torch.int64)


def sweep_counts(ok, n: int, seed_ok=None, pairs=None) -> torch.Tensor:
    """A program's sweep counts as one (2,) int64 tensor on ``ok``'s
    device, read back in one copy: ``live_sets`` and the valid splits a
    connected sweep counted into ``pairs`` (0 without it)."""
    live = live_sets(ok, n, seed_ok)
    if pairs is None:
        pairs = torch.zeros((), dtype=torch.int64, device=ok.device)
    return torch.stack([live, pairs])


def connected_masks(adj, n: int):
    """The (rows, 2^n) connected-subset masks of the rows' simple-edge
    graphs, built from their (rows, n) int32 adjacency bitmasks on
    ``adj``'s device: by the ``connmask`` kernel on a card (a solve
    mesh's lead device included), by the plain version
    (``kernels.ref.connmask_ref``) on CPU tensors."""
    from repro_torch.kernels.ops import connmask_op
    return connmask_op(adj, n)


def _value_layer(dp, sets, subs, comps, card, gate_ok):
    """Layer values of the (min,+) value sweep at ``sets``."""
    combo = dp[..., subs]                              # (..., m, 2^k)
    combo += dp[..., comps]
    val = combo.amin(dim=-1)
    del combo
    val += card[..., sets]
    return val.masked_fill_(~gate_ok[..., sets], float("inf"))


def minplus_value_layers(card, gate_ok, n: int, mesh=None,
                         shard_chunk: int = SHARD_CHUNK_ELEMS):
    """DPsub[out]'s recursion as a dense layer program — the C_cap pass 2.

    ``dp[S] = c(S) + min_T (dp[T] + dp[S\\T])`` for gated sets
    (``gate_ok``: c(S) <= gamma), +inf otherwise; singletons cost 0.
    On one CUDA device (``mesh`` None) every layer is one
    ``minplus_layer`` launch (``_kernel_sweep``); elsewhere every layer
    gathers its (..., C(n,k), 2^k) split table, and its tensors are
    freed before the next layer.  Bit-identical to
    ``baselines.dpsub(mode="out", prune_gamma=gamma)``: min is
    order-independent and the add association ``(dp[T] + dp[S\\T]) +
    c(S)`` matches.

    ``card`` (..., 2^n) f64; ``gate_ok`` boolean, same shape.

    ``mesh`` partitions each layer's sets axis across the solve mesh:
    every shard computes its block of layer-k sets in row-chunks (the
    dominant ``C(n,k)·2^k`` split tensor shrinks to a chunk per device)
    and its values land at its own sets on the lead device.  Per set the
    full 2^k split axis stays on one shard (same min, same add
    association), so the sweep stays bit-identical.
    """
    if _uses_kernel(card, mesh):
        return _kernel_sweep(card, n, gate_ok)
    return _minplus_sweep(card, n, _value_layer, (card, gate_ok), mesh,
                          shard_chunk)


def _connected_layer(dp, sets, subs, comps, card, conn, seed_vals=None,
                     seed_ok=None, pairs=None):
    """Layer values of the connected (min,+) sweep at ``sets``; ``pairs``
    (on the lead device) gains the valid splits of the sets the layer
    evaluates, each unordered split once (the table holds both
    orientations)."""
    inf = float("inf")
    split_ok = conn[..., subs]                         # (..., m, 2^k)
    split_ok &= conn[..., comps]
    if pairs is not None:
        live = conn[..., sets]
        if seed_ok is not None:
            live = live & ~seed_ok[..., sets]
        valid = torch.where(live, split_ok.sum(dim=-1), 0).sum()
        pairs += (valid // 2).to(pairs.device)
    combo = dp[..., subs]
    combo += dp[..., comps]
    val = combo.masked_fill_(~split_ok, inf).amin(dim=-1)
    del combo, split_ok
    val += card[..., sets]
    val.masked_fill_(~conn[..., sets], inf)
    if seed_ok is not None:
        val = torch.where(seed_ok[..., sets], seed_vals[..., sets], val)
    return val


def minplus_connected_layers(card, conn, n: int, seed_vals=None,
                             seed_ok=None, mesh=None,
                             shard_chunk: int = SHARD_CHUNK_ELEMS,
                             pairs=None):
    """DPccp's recursion as a dense layer program — the connectivity-
    masked C_out sweep.

    ``dp[S] = c(S) + min_{(T, S\\T) valid} (dp[T] + dp[S\\T])`` where a
    split is valid iff both halves induce connected subgraphs (for a
    connected S a crossing join edge is then implied), so the valid
    splits are exactly DPccp's csg/cmp pairs.  Disconnected sets stay
    +inf; singletons cost 0.  The valid-split masks of a layer are
    gathers of ``conn`` by the same tables (``conn[subs] & conn[comps]``);
    on one CUDA device the ``minplus_layer`` kernel checks ``conn`` at
    both sides of each split it enumerates instead.
    Bit-identical to ``dpccp.dpccp(q, card, mode="out")``: the same
    multiset of pairs, an order-independent min, and the enumerator's
    add association.

    ``card`` (..., 2^n) f64; ``conn`` boolean, same shape (each batch row
    may carry a different query graph).

    ``seed_vals``/``seed_ok`` (same shape as ``card``; f64 / bool, on its
    device) are value seeds: where ``seed_ok[S]`` the layer write takes
    ``seed_vals[S]`` instead of the computed value.  ``dp[S]`` is a pure
    function of the sub-problem induced on ``S``, so a seed taken from a
    solve whose induced sub-problem is a byte-exact relabeling transfers
    bitwise, and seeded sweeps stay bit-identical to cold ones.

    ``mesh`` partitions the sets axis exactly as in
    ``minplus_value_layers``; the valid-split masks are then only ever
    built for a shard's own block.

    ``pairs`` (a 0-dim int64 tensor on ``card``'s device) gains the
    valid splits ``(T, S\\T)``, T holding S's lowest relation, of the
    sets the sweep evaluates (gated on, not seeded): for an unseeded
    C_out sweep, the query's #ccp.  The kernel counts them as it
    enumerates, the gather sweep from its split masks; no host read.
    """
    if _uses_kernel(card, mesh):
        return _kernel_sweep(card, n, conn, conn, seed_vals, seed_ok,
                             pairs)
    seeds = () if seed_ok is None else (seed_vals, seed_ok)
    layer = _connected_layer if pairs is None else functools.partial(
        _connected_layer, pairs=pairs)
    return _minplus_sweep(card, n, layer, (card, conn) + seeds, mesh,
                          shard_chunk)


# ------------------------------------------------------ probe strategies
def probe_pivots(lo, hi, G: int):
    """(G, B) interior pivots splitting [lo, hi] into G+1 parts:
    p_g = lo + (hi-lo)(g+1)/(G+1).  G = 1 is the binary-search pivot
    (lo+hi)//2."""
    g = torch.arange(1, G + 1, dtype=lo.dtype, device=lo.device)
    return lo[None, :] + ((hi - lo)[None, :] * g[:, None]) // (G + 1)


def bracket_update(lo, hi, piv, ok, active):
    """Monotone (G+1)-ary bracket update: ``ok`` along the probe axis is
    [F..F, T..T]; the bracket collapses onto [largest infeasible + 1,
    smallest feasible]."""
    G = piv.shape[0]
    ntrue = ok.to(torch.int64).sum(dim=0)                  # (B,)
    any_ok = ntrue > 0
    any_bad = ntrue < G
    first_ok = torch.clamp(G - ntrue, 0, G - 1)
    last_bad = torch.clamp(G - ntrue - 1, 0, G - 1)
    piv_ok = torch.gather(piv, 0, first_ok[None, :])[0]
    piv_bad = torch.gather(piv, 0, last_bad[None, :])[0]
    hi = torch.where(active & any_ok, piv_ok, hi)
    lo = torch.where(active & any_bad, piv_bad + 1, lo)
    return lo, hi


# ------------------------------------------- on-device tree extraction
def extract_scan(dp, n: int, card=None):
    """Alg. 2 as a masked scan over tree slots, on the device.

    Slot r holds a set mask; an internal slot finds its witness split by
    one dense pass over all candidate submasks and writes its two
    children at the write head.  ``card=None`` reads ``dp`` (B, 2^n) as
    a feasibility table (error 0 iff both split sides are feasible);
    with ``card`` it reads ``dp`` as a C_out value table (error
    ``|dp[T] + dp[S\\T] - (dp[S] - c(S))|``, the target taken once per
    slot).  Witness rule, as in the host extractors: the *largest* T of
    minimal error.  Returns ``(nodes, lidx)``, (B, 2n-1) int32: slot
    masks and left-child slot indices (0 for leaves), for
    ``jointree.tree_from_split_arrays``.
    """
    B, size = dp.shape
    dev = dp.device
    M = 2 * n - 1
    pc = popcounts_on(n, dev).to(torch.int64)
    T = torch.arange(size, dtype=torch.int64, device=dev)[None, :]
    ar = torch.arange(B, device=dev)
    feas = dp > 0.5 if card is None else None
    inf = _on_device(("inf", str(dev)), lambda: torch.tensor(
        float("inf"), dtype=torch.float64, device=dev))
    nodes = torch.zeros((B, M), dtype=torch.int64, device=dev)
    nodes[:, 0] = size - 1
    lidx = torch.zeros((B, M), dtype=torch.int64, device=dev)
    w = torch.ones(B, dtype=torch.int64, device=dev)
    for r in range(M):
        S = nodes[:, r]                                    # (B,)
        internal = pc[S] >= 2
        Sc = S[:, None]
        valid = ((T & ~Sc) == 0) & (T != 0) & (T != Sc)
        if card is None:
            dpC = torch.gather(feas, 1, Sc & ~T)
            err = 1.0 - (feas & dpC).to(torch.float64)
        else:
            target = torch.gather(dp, 1, Sc) - torch.gather(card, 1, Sc)
            err = (dp + torch.gather(dp, 1, Sc & ~T) - target).abs()
        err = torch.where(valid, err, inf)
        # largest T among the minima: argmin over the reversed axis
        twit = size - 1 - torch.argmin(err.flip(1), dim=1)
        wc = torch.clamp(w, max=M - 2)     # leaf slots don't advance w
        left = torch.where(internal, twit, nodes[ar, wc])
        right = torch.where(internal, S & ~twit, nodes[ar, wc + 1])
        nodes[ar, wc] = left
        nodes[ar, wc + 1] = right
        lidx[:, r] = torch.where(internal, wc, 0)
        w = w + 2 * internal.to(torch.int64)
    return nodes.to(torch.int32), lidx.to(torch.int32)


# --------------------------------------------- whole-solve program
def _solve_axis(shards: int, mesh) -> "tuple | None":
    """The solve mesh a sharded program partitions over, as a tuple of
    devices, or None for the single-device build.  ``shards`` and
    ``mesh`` travel together: the engine resolves ``shards ->
    launch.mesh.make_solve_mesh(shards)`` and the builders check that
    they agree."""
    if shards <= 1 and mesh is None:
        return None
    if mesh is None:
        raise ValueError(f"shards={shards} needs a solve mesh")
    mesh = tuple(torch.device(d) for d in mesh)
    if len(mesh) != shards:
        raise ValueError(f"a mesh of {len(mesh)} devices does not match "
                         f"shards={shards}")
    return mesh


def _search_state(B: int, n: int, tfm: Transforms, G: int, device):
    """Initial ranked-zeta buffer of the lockstep search: zeros with the
    singleton transform in slot 1; a leading probe axis for G > 1."""
    size = 1 << n
    pc = popcounts_on(n, device)
    batch = (B,) if G == 1 else (G, B)
    singles = (pc == 1).to(tfm.dtype).expand(batch + (size,)).contiguous()
    Z0 = torch.zeros((n + 1,) + batch + (size,), dtype=tfm.dtype,
                     device=device)
    tfm.zeta(singles, out=Z0[1])
    return Z0


def _gate_builder(cards, pc, dtype):
    def gate_of(gamma):
        """gate(S) = [c(S) <= gamma] for |S| >= 2; singletons/empty pass.
        ``gamma`` (B,) or (G, B) — broadcasts to (..., B, 2^n)."""
        g = (cards <= gamma[..., None]).to(dtype)
        return torch.where(pc >= 2, g, torch.ones((), dtype=dtype,
                                                  device=cards.device))
    return gate_of


_BLOCKED = threading.local()


def blocked_s() -> float:
    """Seconds this thread has spent blocked on the search loop's host
    reads of the device, summed over every call so far."""
    return getattr(_BLOCKED, "s", 0.0)


def _host_any(active) -> bool:
    """``bool(active.any())``, the loop condition's host read, with the
    seconds it blocks added to ``blocked_s()``."""
    a = active.any()
    t0 = time.perf_counter()  # timing: measured-duration (host read)
    v = bool(a)
    # timing: measured-duration
    _BLOCKED.s = blocked_s() + (time.perf_counter() - t0)
    return v


@dataclasses.dataclass
class _Solve:
    """The tensors of one program call: its inputs, the search bracket
    ``lo``/``hi`` and the ranked-zeta buffers ``Z`` (the loop's) and
    ``Zv`` (the seeded probe's), which the search updates in place, and
    ``extra``, the tail's further inputs (C_cap's slack and adjacency
    bitmasks).  An eager call makes one per call; a
    graphed program keeps one for good, its static tensors, and copies
    each call's inputs into it (``_load``)."""
    cards: torch.Tensor
    cand: "torch.Tensor | None" = None
    lo: "torch.Tensor | None" = None
    hi: "torch.Tensor | None" = None
    Z: "torch.Tensor | None" = None
    Zv: "torch.Tensor | None" = None
    extra: tuple = ()
    gate_of: "callable | None" = None


def _verify_round(s: _Solve, n: int, dl: int, tfm: Transforms, mesh):
    """The seeded programs' dual probe, in place on ``s.lo``/``s.hi``: a
    row whose ``lo = -(idx + 1)`` carries a cached-optimum hypothesis at
    candidate ``idx``, checked at ``idx`` and ``idx - 1`` in one
    feasibility pass on ``s.Zv`` (the loop's buffer ``s.Z`` is never
    touched by it); every ``lo`` ends non-negative."""
    lo, hi = s.lo, s.hi
    has = lo < 0
    idx = torch.where(has, -lo - 1, 0)
    floor = torch.clamp(lo, min=0)
    piv = torch.stack([torch.clamp(idx - 1, min=0), idx])      # (2, B)
    piv = torch.where(has[None, :], piv, hi[None, :])
    gamma = torch.gather(s.cand, 1, piv.T).T
    _, _, ok = feasibility_layers(s.gate_of(gamma), n, dl, tfm, True,
                                  Z=s.Zv, mesh=mesh)
    new_lo, new_hi = bracket_update(floor, hi, piv, ok, has)
    lo.copy_(new_lo)
    hi.copy_(new_hi)


def _search_round(s: _Solve, n: int, dl: int, tfm: Transforms, G: int,
                  mesh):
    """One round of the lockstep (G+1)-ary search, in place on
    ``s.lo``/``s.hi`` and ``s.Z``: the G pivots of each active row, their
    gates, the layered DP on the carried buffer and the bracket update.
    The one body of a round, run eagerly or captured."""
    lo, hi = s.lo, s.hi
    active = lo < hi
    if G == 1:
        mid = torch.where(active, (lo + hi) // 2, hi)
        gamma = torch.gather(s.cand, 1, mid[:, None])[:, 0]
        _, _, ok = feasibility_layers(s.gate_of(gamma), n, dl, tfm, True,
                                      Z=s.Z, mesh=mesh)
        new_lo = torch.where(active & ~ok, mid + 1, lo)
        new_hi = torch.where(active & ok, mid, hi)
    else:
        piv = probe_pivots(lo, hi, G)                      # (G, B)
        piv = torch.where(active[None, :], piv, hi[None, :])
        gamma = torch.gather(s.cand, 1, piv.T).T
        _, _, ok = feasibility_layers(s.gate_of(gamma), n, dl, tfm, True,
                                      Z=s.Z, mesh=mesh)
        new_lo, new_hi = bracket_update(lo, hi, piv, ok, active)
    lo.copy_(new_lo)
    hi.copy_(new_hi)


def _fused_search(s: _Solve, verify, step, seeded: bool) -> tuple:
    """The whole-solve lockstep (G+1)-ary search over ``s``: ``verify()``
    runs the seeded probe (``_verify_round``) and ``step()`` one round
    (``_search_round``), eagerly or as graph replays; the host reads the
    loop condition ``any(lo < hi)`` once per round.  Returns ``(rounds,
    syncs)``, ``s.hi`` then indexing a feasible candidate of each row;
    ``syncs`` counts the host reads of the loop condition.

    ``s.lo`` starts at the warm-start floor (cold solves pass zeros).
    With ``seeded`` a row whose ``lo = -(idx + 1)`` carries a cached-
    optimum hypothesis at candidate ``idx``, never trusted: the probe
    before the loop checks it.  A verified seed collapses the bracket and
    the loop runs no round; a stale one only shrinks the bracket
    monotonically and the search proceeds to the true optimum.  The
    probe costs one round and no host sync.  The extraction pass
    rebuilds every Z slot >= 2 at the optimum's gate, so results are
    bit-identical to the cold search.  The caller keeps the invariant:
    cand[hi0] is feasible and no candidate below ``max(lo0, 0)`` is.

    Under a solve mesh the direct layers of every round shard their
    gather sweep; the bracket state stays on the lead device."""
    rounds = syncs = 0
    if seeded:
        verify()
        rounds = 1                       # the verification sweep is paid
    while True:
        syncs += 1
        if not _host_any(s.lo < s.hi):
            break
        step()
        rounds += 1
    return rounds, syncs


class _Searcher:
    """The lockstep search of a whole-solve program.  It keeps the
    initial ranked-zeta buffers of its first call (static tables of
    their shapes: the loop's and, when ``seeded``, the G = 2
    verification probe's); every call starts from copies of them."""

    def __init__(self, n: int, direct_layers: int, tfm: Transforms,
                 G: int, seeded: bool, mesh):
        self.n, self.dl, self.tfm, self.G = n, min(direct_layers, n - 1), \
            tfm, G
        self.seeded, self.mesh = seeded, mesh
        self.Z0 = self.Zv0 = None

    def solve(self, cards, cand, lo0, hi0, extra=(),
              static: bool = False) -> _Solve:
        """One call's ``_Solve``: copies of the bracket and the initial
        buffers; with ``static`` copies of every input too (a graphed
        program's static tensors)."""
        dev = cards.device
        if self.Z0 is None:
            B = cards.shape[0]
            self.Z0 = _search_state(B, self.n, self.tfm, self.G, dev)
            if self.seeded:
                self.Zv0 = _search_state(B, self.n, self.tfm, 2, dev)
        if static:
            cards, cand = cards.clone(), cand.clone()
            extra = _static(extra, dev)
        s = _Solve(cards, cand, lo0.clone(), hi0.clone(), self.Z0.clone(),
                   self.Zv0.clone() if self.seeded else None, extra)
        s.gate_of = _gate_builder(cards, popcounts_on(self.n, dev),
                                  self.tfm.dtype)
        return s

    def load(self, s: _Solve, cards, cand, lo0, hi0, extra) -> None:
        """Copy one call's inputs and the initial buffers into the
        static ``s``."""
        _load((s.cards, s.cand, s.lo, s.hi) + s.extra,
              (cards, cand, lo0, hi0) + tuple(extra))
        s.Z.copy_(self.Z0)
        if self.seeded:
            s.Zv.copy_(self.Zv0)

    def verify(self, s: _Solve) -> None:
        _verify_round(s, self.n, self.dl, self.tfm, self.mesh)

    def round(self, s: _Solve) -> None:
        _search_round(s, self.n, self.dl, self.tfm, self.G, self.mesh)

    def run(self, s: _Solve) -> tuple:
        """The eager search of ``s``: ``(rounds, syncs)``."""
        return _fused_search(s, lambda: self.verify(s),
                             lambda: self.round(s), self.seeded)


# ------------------------------------------------------------ CUDA graphs
def uses_graphs(device, mesh) -> bool:
    """Whether a program's calls replay CUDA graphs: exactly when it
    runs on one CUDA device, with no solve mesh.  CPU programs and
    sharded ones run eagerly."""
    return (mesh is None and device is not None
            and torch.device(device).type == "cuda")


def _static(args, device) -> tuple:
    """Static tensors for a graphed program's inputs: a copy of each
    tensor, a 0-dim float64 tensor for each number."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else
                 torch.tensor(float(a), dtype=torch.float64, device=device)
                 for a in args)


def _load(static, args) -> None:
    """Copy one call's inputs into a graphed program's static tensors (a
    number into its 0-dim tensor).  The shapes are the bucket's, fixed
    at the first call."""
    for dst, src in zip(static, args, strict=True):
        if isinstance(src, torch.Tensor):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"a graphed program takes {tuple(dst.shape)} "
                    f"{dst.dtype}, not {tuple(src.shape)} {src.dtype}")
            dst.copy_(src)
        else:
            dst.fill_(float(src))


_GRAPHED = threading.local()


def graph_counts() -> tuple:
    """``(replays, captures)`` this thread's program calls have made,
    summed over every call so far: graph replays, and programs whose
    first graph a call captured.  The engine reads them around a call."""
    return (getattr(_GRAPHED, "replays", 0),
            getattr(_GRAPHED, "captures", 0))


class _Graphs:
    """The CUDA graphs of one single-device program: one per part of its
    call (the search round, the seeded probe, the tail), in one private
    memory pool that they share; the call's static tensors (``solve``),
    into which every call copies its inputs; and a lock held across a
    call, so that two lanes never use one program's static tensors at
    once.

    A part runs eagerly at its first use (the build's first touch runs
    the tail and the seeded probe; the first round of the first solve
    runs the round), which makes the tables it builds lazily (a capture
    cannot copy from the host) and loads its kernels; its second use
    captures it on a side stream, and that use and every later one
    replay it.  A graph's outputs live in the pool and are overwritten
    by the next replay of any of the program's graphs: the program
    returns copies.  The hand-written kernels launch on the current
    stream, the capture stream while capturing, and are counted per
    replay (``kernels.build.recording``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.solve = None
        self._pool = None
        self._parts: dict = {}
        self._seen: set = set()

    def run(self, name: str, body):
        """Run the part ``name`` of a call: eagerly at its first use,
        captured at its second, replayed from then on.  Returns what
        ``body`` returns, or the graph's pool-owned outputs."""
        if name not in self._parts:
            if name not in self._seen:
                self._seen.add(name)
                return body()
            if not self._parts:
                _GRAPHED.captures = graph_counts()[1] + 1
            self._parts[name] = self._capture(body)
        _GRAPHED.replays = graph_counts()[0] + 1
        return self._replay(name)

    def _capture(self, body) -> tuple:
        from repro_torch.kernels import build
        with torch.cuda.device(self.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side), build.recording() as launches:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    graph.capture_end()
            cur.wait_stream(side)
        return graph, out, launches

    def _replay(self, name: str):
        from repro_torch.kernels import build
        graph, out, launches = self._parts[name]
        graph.replay()
        build.add_launches(launches)
        return out


def _copies(out) -> tuple:
    return tuple(t.clone() for t in out)


def _searching_program(search: _Searcher, tail, device, mesh):
    """A searching program's call, ``(cards, cand, lo0, hi0, *extra) ->
    tail outputs + (rounds, syncs)``: eager, or through CUDA graphs of
    the round, the seeded probe and ``tail`` where ``uses_graphs``."""
    if not uses_graphs(device, mesh):
        def fn(cards, cand, lo0, hi0, *extra):
            s = search.solve(cards, cand, lo0, hi0, extra)
            rounds, syncs = search.run(s)
            return tail(s) + (rounds, syncs)
        fn.graphed = False
        return fn

    g = _Graphs(device)

    def fn(cards, cand, lo0, hi0, *extra):
        with g.lock:
            if g.solve is None:
                g.solve = search.solve(cards, cand, lo0, hi0, extra,
                                       static=True)
            s = g.solve
            search.load(s, cards, cand, lo0, hi0, extra)
            rounds, syncs = _fused_search(
                s, lambda: g.run("verify", lambda: search.verify(s)),
                lambda: g.run("round", lambda: search.round(s)),
                search.seeded)
            return _copies(g.run("tail", lambda: tail(s))) + (rounds,
                                                              syncs)
    fn.graphed = True
    return fn


def build_max_program(n: int, direct_layers: int, tier: str,
                      extract: bool, gamma_batch: int = 1,
                      shards: int = 1, mesh=None, seeded: bool = False,
                      device=None):
    """The whole-solve DPconv[max] program:
    ``(cards, cand, lo0, hi0) -> (opt[, dp, nodes, lidx], rounds, syncs)``.

    cards (B, 2^n) f64, cand (B, C) f64, lo0/hi0 (B,) int64 on one
    device.  Search, gate construction, layered DP, the extraction table
    and the Alg. 2 split scan all run on that device; the host reads the
    loop condition once per round.  ``seeded=True`` is the warm-start
    variant: rows with ``lo0 = -(idx + 1)`` carry a cached optimum that
    the search verifies with one dual probe (``_fused_search``).

    ``shards > 1`` partitions the direct-layer sweeps over ``mesh`` (a
    ``launch.mesh.make_solve_mesh`` tuple of ``shards`` devices); inputs
    and outputs stay on the lead device, with the same shapes and
    bit-identical results.  A program built for a CUDA ``device`` with
    no mesh runs through CUDA graphs (``uses_graphs``, ``_Graphs``),
    for the shapes of its first call's inputs.
    """
    tfm = transforms(tier)
    dl = min(direct_layers, n - 1)
    G = gamma_batch
    mesh = _solve_axis(shards, mesh)

    def tail(s):
        opt = torch.gather(s.cand, 1, s.hi[:, None])[:, 0]
        if not extract:
            return (opt,)
        # extraction pass: full final layer at the optimum's gate.  For
        # G > 1 the probe axis is dropped — slice 0 keeps the singleton
        # transform in slot 1, and every slot >= 2 is rewritten before
        # the recursion reads it.
        Zx = s.Z if G == 1 else s.Z[:, 0].contiguous()
        dp, _, _ = feasibility_layers(s.gate_of(opt), n, dl, tfm, False,
                                      Z=Zx, mesh=mesh)
        dpf = dp.to(torch.float64)
        nodes, lidx = extract_scan(dpf, n)
        return opt, dpf, nodes, lidx

    search = _Searcher(n, direct_layers, tfm, G, seeded, mesh)
    return _searching_program(search, tail, device, mesh)


def build_out_program(n: int, extract: bool, shards: int = 1, mesh=None,
                      seeded: bool = False, device=None):
    """The whole-solve connected C_out program (DPccp semantics):
    ``(cards, adj) -> (cout[, dp, nodes, lidx], counts)`` — or, with
    ``seeded=True``, ``(cards, adj, seed_vals, seed_ok) -> ...``: the
    sweep replays cached sub-table values where ``seed_ok`` (see
    ``minplus_connected_layers``).

    cards (B, 2^n) f64 and adj (B, n) int32 — each query's neighbour
    bitmasks (``QueryGraph.adjacency``) — on one device.  The call
    builds the connected-subset masks from ``adj`` on that device
    (``connected_masks``: the ``connmask`` kernel on one card, inside
    the graph), then runs the (min,+) sweep under the valid splits they
    define; the value-mode extraction scan reads the same table, so
    disconnected witnesses carry +inf error.  No search loop: the
    program reads nothing back until its results.  Bit-identical
    optima, DP tables and trees to ``dpccp_with_tree``.  ``counts``
    ((2,) int64, ``sweep_counts``) holds the sets the sweep evaluated
    (``live_sets``) and the valid splits it found, the #ccp of an
    unseeded row summed over the rows.  ``shards > 1`` partitions every
    layer of the sweep over ``mesh``.  On a CUDA ``device`` with no mesh
    the whole call is one CUDA graph, from its second call on.
    """
    mesh = _solve_axis(shards, mesh)

    def tail(cards, adj, seed_vals=None, seed_ok=None):
        conn = connected_masks(adj, n)
        pairs = torch.zeros((), dtype=torch.int64, device=cards.device)
        dpv = minplus_connected_layers(cards, conn, n, seed_vals=seed_vals,
                                       seed_ok=seed_ok, mesh=mesh,
                                       pairs=pairs)
        cout = dpv[..., -1]
        counts = sweep_counts(conn, n, seed_ok, pairs)
        if not extract:
            return cout, counts
        nodes, lidx = extract_scan(dpv, n, card=cards)
        return cout, dpv, nodes, lidx, counts

    graphs = _Graphs(device) if uses_graphs(device, mesh) else None

    def fn(cards, adj, seed_vals=None, seed_ok=None):
        if seeded != (seed_ok is not None):
            raise ValueError("the seeded out program takes seed_vals and "
                             "seed_ok, the cold one neither")
        args = (cards, adj) + ((seed_vals, seed_ok) if seeded else ())
        if graphs is None:
            return tail(*args)
        with graphs.lock:
            if graphs.solve is None:
                graphs.solve = _static(args, cards.device)
            _load(graphs.solve, args)
            return _copies(graphs.run("tail", lambda: tail(*graphs.solve)))

    fn.graphed = graphs is not None
    return fn


def build_cap_program(n: int, direct_layers: int, tier: str,
                      extract: bool, gamma_batch: int = 1,
                      connected: bool = False, shards: int = 1, mesh=None,
                      seeded: bool = False, device=None):
    """The whole-solve C_cap program (paper Sec. 8, both passes):
    ``(cards, cand, lo0, hi0, slack[, adj]) ->
    (gamma, cout[, nodes, lidx], counts, rounds, syncs)``.

    Pass 1 is the lockstep feasibility search of DPconv[max] on
    ``tier`` (gamma* = optimal C_max); pass 2 runs the (min,+) value
    sweep under the gate ``c(S) <= slack · gamma*`` (singletons and ∅
    pass; ``counts`` = ``sweep_counts``: the sets it lets through and,
    connected, the valid splits it found); pass 3 extracts the C_out
    witness tree.  ``slack`` is the Sec. 11 resource-aware knob.
    ``connected=True`` is the no-cross-products cap: the call builds the
    connected-subset masks ``conn`` from ``adj`` ((B, n) int32 neighbour
    bitmasks, ``connected_masks``) and pass 2 runs the connected sweep
    under ``gate & conn``, bit-identical to ``dpconv_max`` +
    ``dpccp(prune_gamma=gamma)``.  The cap stays the full-lattice C_max
    optimum, which a cross-product-free plan may not attain: ``cout`` is
    then +inf, as in the host pipeline.  ``seeded=True`` verifies cached
    pass-1 optima as ``build_max_program`` does.  ``shards > 1``
    partitions pass 1's direct layers and every layer of pass 2 over
    ``mesh``.  On a CUDA
    ``device`` with no mesh pass 1's rounds and passes 2–3 run through
    CUDA graphs, as in ``build_max_program`` (``slack`` then rides a
    0-dim tensor: the same float64 product).
    """
    tfm = transforms(tier)
    mesh = _solve_axis(shards, mesh)

    def tail(s):
        slack = s.extra[0]
        pc = popcounts_on(n, s.cards.device)
        gamma = torch.gather(s.cand, 1, s.hi[:, None])[:, 0]
        gamma = gamma * slack
        gate_ok = (s.cards <= gamma[:, None]) | (pc < 2)
        pairs = None
        if connected:
            gate_ok = gate_ok & connected_masks(s.extra[1], n)
            pairs = torch.zeros((), dtype=torch.int64,
                                device=s.cards.device)
            dpv = minplus_connected_layers(s.cards, gate_ok, n, mesh=mesh,
                                           pairs=pairs)
        else:
            dpv = minplus_value_layers(s.cards, gate_ok, n, mesh=mesh)
        cout = dpv[..., -1]
        counts = sweep_counts(gate_ok, n, pairs=pairs)
        if not extract:
            return gamma, cout, counts
        nodes, lidx = extract_scan(dpv, n, card=s.cards)
        return gamma, cout, nodes, lidx, counts

    search = _Searcher(n, direct_layers, tfm, gamma_batch, seeded, mesh)
    prog = _searching_program(search, tail, device, mesh)

    def fn(cards, cand, lo0, hi0, slack, adj=None):
        return prog(cards, cand, lo0, hi0, slack,
                    *((adj,) if connected else ()))

    fn.graphed = prog.graphed
    return fn


def program_card(n: int, cost: str, backend: str = "f64",
                 gamma_batch: int = 1, extract: bool = True,
                 shards: int = 1) -> dict:
    """Static description of one whole-solve lattice program: which
    semiring passes run, how many DP layers, the subset-lattice width and
    the search arity and the solve-mesh width.  ``cost`` may carry the
    ``_seeded`` suffix of the warm-start variants; ``backend`` is the
    search's transform tier."""
    semirings = {
        "max": ["feasibility(count)"],
        "max_seeded": ["feasibility(count), verified warm start"],
        "cap": ["feasibility(count)", "(min,+)"],
        "cap_seeded": ["feasibility(count), verified warm start",
                       "(min,+)"],
        "cap_conn": ["feasibility(count)", "(min,+) connected"],
        "cap_conn_seeded": ["feasibility(count), verified warm start",
                            "(min,+) connected"],
        "out": ["(min,+) connected"],
        "out_seeded": ["(min,+) connected, seeded"],
    }
    if cost not in semirings:
        raise ValueError(f"unknown fused cost {cost!r}")
    searched = cost not in ("out", "out_seeded")
    dtype = transforms(backend).dtype if searched else torch.float64
    return {
        "cost": cost,
        "backend": backend if searched else "f64",
        "semirings": semirings[cost],
        "layers": n - 1,                # DP layers per value sweep
        "subset_lattice": 1 << n,       # cells per query per layer
        "search": (f"lockstep {gamma_batch + 1}-ary" if searched
                   else "none"),
        "extract": bool(extract),
        "shards": int(shards),
        "dtype": str(dtype).replace("torch.", ""),
    }
