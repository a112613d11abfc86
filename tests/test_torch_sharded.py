"""The port's sharded lattice solve (``shards = D``) against ``repro``.

Every contract of ``tests/test_sharded_parity.py`` on the port: the same
numpy inputs go through the port's fused engine over a D-way solve mesh
and through ``repro``'s unsharded fused engine and host pipeline, which
exist whatever jax's device count; optima must be ``float.hex``-equal
and trees ``repr``-equal.  Where jax has D devices (this file imported
before jax, which then forces 8 host devices as the reference's sharded
tests do), ``repro``'s own sharded solve is compared too; elsewhere
those cases skip.

The port's mesh repeats the CPU device through ``force_device_count``
(reset after every test).  Layer-level cases hold the sharded direct
layer and both sharded (min,+) sweeps against the unsharded port layers,
with D that leave pad rows in the reference's layout (a shorter or empty
last block in the port's), a small row chunk, and the replicated input
left untouched.  ``cuda``-marked cases run the mesh on the card.
"""
import os
import sys

if "jax" not in sys.modules and \
        "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count"
                                 "=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import lattice as ref_lattice  # noqa: E402
from repro.core.ccap import ccap as ref_ccap  # noqa: E402
from repro.core.dpconv import optimize as ref_optimize  # noqa: E402
from repro.core.dpconv_max import dpconv_max as ref_dpconv_max  # noqa: E402
from repro.core.querygraph import (chain, clique, cycle,  # noqa: E402
                                   make_cardinalities, star)
from repro_torch.core import engine, lattice, querygraph  # noqa: E402
from repro_torch.core.bitset import popcounts  # noqa: E402
from repro_torch.core.ccap import ccap  # noqa: E402
from repro_torch.core.dpccp import connectivity_masks  # noqa: E402
from repro_torch.core.dpconv import optimize, optimize_batch  # noqa: E402
from repro_torch.core.dpconv_max import (dpconv_max,  # noqa: E402
                                         dpconv_max_batch, dpconv_max_ref)
from repro_torch.launch import mesh  # noqa: E402

CPU = "cpu"
NDEV = len(jax.devices())


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _forced_mesh():
    """Every test sees an 8-slot CPU mesh; the visible devices after."""
    mesh.force_device_count(8)
    yield
    mesh.force_device_count(None)


@pytest.fixture
def ref_sharded(D):
    """``D`` when ``repro`` can build a D-device solve mesh, else skip."""
    if NDEV < D:
        pytest.skip(f"repro's jax has {NDEV} devices, the comparison needs "
                    f"{D} (run this file alone)")
    return D


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pq(q):
    return querygraph.QueryGraph(q.n, tuple(q.edges), tuple(q.hyperedges))


def _cases(n, seeds=(0, 1)):
    makers = [clique, chain, star, cycle]
    return [(makers[i % len(makers)](n),
             make_cardinalities(makers[i % len(makers)](n), seed=s))
            for i, s in enumerate(seeds)]


def _same(got, *wants):
    """(value, tree) pairs: float.hex values and repr trees equal."""
    g = (float(got[0]).hex(), repr(got[1]))
    for w in wants:
        assert g == (float(w[0]).hex(), repr(w[1]))


# --------------------------------------------------------------- the mesh
def test_solve_mesh_devices_and_forced_count():
    assert mesh.SOLVE_AXIS == "solve"
    assert mesh.make_solve_mesh(None, CPU) == (torch.device(CPU),) * 8
    assert mesh.make_solve_mesh(3, CPU) == (torch.device(CPU),) * 3
    with pytest.raises(ValueError):
        mesh.make_solve_mesh(9, CPU)
    assert mesh.mesh_fingerprint(mesh.make_solve_mesh(2, CPU)) == \
        ("cpu", "cpu")
    mesh.force_device_count(None)
    assert mesh.forced_device_count() is None
    assert mesh.make_solve_mesh(None, CPU) == (torch.device(CPU),)
    with pytest.raises(ValueError):                  # one CPU device
        mesh.make_solve_mesh(2, CPU)
    with pytest.raises(ValueError):
        mesh.force_device_count(0)
    # the engine's cached mesh follows the forced count
    mesh.force_device_count(4)
    assert engine.solve_mesh(4, CPU) == (torch.device(CPU),) * 4
    assert engine.solve_mesh(4, CPU) is engine.solve_mesh(4, CPU)


@pytest.mark.parametrize("n,k,D", [(8, 2, 3), (8, 4, 5), (8, 8, 8),
                                   (10, 5, 4), (7, 3, 1)])
def test_sharded_layer_indices_match_reference(n, k, D):
    got = lattice.sharded_layer_indices(n, k, D)
    want = ref_lattice.sharded_layer_indices(n, k, D)
    assert got[3] == want[3] and got[0].shape[0] == D * got[3]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    pad = got[0][lattice.direct_layer_indices(n, k)[0].shape[0]:]
    assert not pad.any()                             # pad rows: set 0


@pytest.mark.parametrize("n,k,D,chunk", [(8, 2, 3, 1 << 21),
                                         (8, 4, 5, 1 << 6),
                                         (8, 8, 8, 1 << 21),
                                         (10, 5, 4, 1 << 7)])
def test_shard_chunks_are_the_reference_blocks_less_pad(n, k, D, chunk):
    """Shard d's chunks cover rows [d*blk, (d+1)*blk) of the reference's
    padded layout that hold real sets, each row once, in order, with at
    most ``chunk >> k`` rows a chunk; a repeated-device mesh slices the
    lead's tables and caches nothing of its own."""
    sets, subs, comps, blk = ref_lattice.sharded_layer_indices(n, k, D)
    m = lattice.direct_layer_indices(n, k)[0].shape[0]
    mesh_d = mesh.make_solve_mesh(D, CPU)
    before = set(lattice._DEVICE_TABLES)
    seen = []
    for dev, ss, (s_d, sub_d, comp_d) in lattice._shard_chunks(n, k, mesh_d,
                                                              chunk):
        assert dev == torch.device(CPU) and torch.equal(ss, s_d)
        assert 0 < s_d.shape[0] <= max(1, chunk >> k)
        lo = len(seen)
        seen.extend(s_d.tolist())
        assert np.array_equal(sub_d.numpy(), subs[lo:lo + s_d.shape[0]])
        assert np.array_equal(comp_d.numpy(), comps[lo:lo + s_d.shape[0]])
    assert seen == sets[:m].tolist()
    assert not any(key[0] == "shard"
                   for key in set(lattice._DEVICE_TABLES) - before)


# ---------------------------------------------------------- layer level
def _layer_inputs(n, batch, seed):
    """A gate with random 0/1 entries over |S| >= 2 and a (min,+) input:
    positive cardinalities, a random gate mask and connected-subset
    masks of a random connected graph per batch row."""
    rng = np.random.default_rng(seed)
    size = 1 << n
    pc = popcounts(n)
    gate = rng.integers(0, 2, batch + (size,)).astype(np.float64)
    gate[..., pc < 2] = 1.0
    card = rng.uniform(1.0, 1e6, batch + (size,))
    ok = rng.random(batch + (size,)) < 0.8
    ok[..., pc < 2] = True
    conn = np.empty(batch + (size,), bool)
    for idx in np.ndindex(*batch):
        q = querygraph.random_sparse(n, 3, seed=seed + sum(idx))
        conn[idx] = connectivity_masks(q)
    return gate, card, ok, conn


@pytest.mark.parametrize("D", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int32],
                         ids=["f64", "int32"])
def test_direct_layer_sharded_matches_unsharded(D, dtype):
    n = 8
    gate_np, _, _, _ = _layer_inputs(n, (2, 3), seed=D)
    gate = torch.as_tensor(gate_np).to(dtype)
    pc = lattice.popcounts_on(n, CPU)
    m = mesh.make_solve_mesh(D, CPU)
    dp = (pc == 1).to(dtype).expand(gate.shape).contiguous()
    for k in range(2, n + 1):
        want = lattice.direct_layer_full(dp, gate, n, k, pc, dtype)
        before = dp.clone()
        got = lattice.direct_layer_full_sharded(dp, gate, n, k, pc, dtype, m)
        small = lattice.direct_layer_full_sharded(dp, gate, n, k, pc, dtype,
                                                  m, chunk=1 << 4)
        assert torch.equal(dp, before)               # dp never written
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(small, want)
        dp = dp + want
    # and the unsharded port layer is the reference's
    want = ref_lattice.direct_layer_full(
        np.asarray(dp.to(torch.float64)), gate_np, n, 4,
        np.asarray(popcounts(n), np.int32), np.float64)
    got = lattice.direct_layer_full_sharded(
        dp.to(torch.float64), gate.to(torch.float64), n, 4, pc,
        torch.float64, m)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("D", [1, 2, 3, 5, 8])
def test_minplus_sweeps_sharded_match_unsharded(D):
    n = 8
    _, card_np, ok_np, conn_np = _layer_inputs(n, (3,), seed=10 + D)
    card, ok, conn = (torch.as_tensor(a) for a in (card_np, ok_np, conn_np))
    m = mesh.make_solve_mesh(D, CPU)
    inputs = [t.clone() for t in (card, ok, conn)]
    want_v = lattice.minplus_value_layers(card, ok, n)
    want_c = lattice.minplus_connected_layers(card, conn, n)
    for chunk in (lattice.SHARD_CHUNK_ELEMS, 1 << 4):
        got_v = lattice.minplus_value_layers(card, ok, n, mesh=m,
                                             shard_chunk=chunk)
        got_c = lattice.minplus_connected_layers(card, conn, n, mesh=m,
                                                 shard_chunk=chunk)
        assert np.array_equal(got_v.numpy(), want_v.numpy())
        assert np.array_equal(got_c.numpy(), want_c.numpy())
    for a, b in zip(inputs, (card, ok, conn)):       # inputs untouched
        assert torch.equal(a, b)
    # the value sweep is the reference's (min,+) sweep, bitwise
    ref_v = ref_lattice.minplus_value_layers(card_np, ok_np, n)
    assert np.array_equal(want_v.numpy(), np.asarray(ref_v))
    # value seeds ride the sharded connected sweep as the unsharded one
    rng = np.random.default_rng(D)
    so = torch.as_tensor(rng.random(card.shape) < 0.3)
    sv = want_c.clone()
    want_s = lattice.minplus_connected_layers(card, conn, n, sv, so)
    got_s = lattice.minplus_connected_layers(card, conn, n, sv, so, mesh=m)
    assert np.array_equal(got_s.numpy(), want_s.numpy())
    assert np.array_equal(want_s.numpy(), want_c.numpy())


def test_sharded_program_checks_its_mesh():
    with pytest.raises(ValueError):
        lattice.build_max_program(6, 4, "f64", True, shards=2)
    with pytest.raises(ValueError):
        lattice.build_out_program(6, True, shards=2,
                                  mesh=mesh.make_solve_mesh(3, CPU))
    card = lattice.program_card(6, "cap", shards=4)
    assert card["shards"] == 4


# --------------------------------------------------------------- C_max
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_sharded_max_bitwise_parity(D):
    n = 7
    for q, card in _cases(n, seeds=(0, 3)):
        mark = engine.dispatch_mark()
        sh = dpconv_max(_pq(q), card, engine="fused", shards=D, device=CPU)
        recs = [r for r in engine.dispatches_since(mark) if r.cost == "max"]
        fused = ref_dpconv_max(q, card, engine="fused")
        host = ref_dpconv_max(q, card, engine="host")
        assert sh.engine == "fused" and sh.dispatches == 1
        _same((sh.optimum, sh.tree), (fused.optimum, fused.tree),
              (host.optimum, host.tree))
        assert sh.optimum == dpconv_max_ref(card, n)
        assert sh.tree.cost_max(card) == sh.optimum
        assert recs and recs[0].shards == D
        assert len(recs[0].devices) == D
        # the kernel tier (plain versions on the CPU) over the same mesh
        kt = dpconv_max(_pq(q), card, engine="fused", backend="cuda",
                        shards=D, device=CPU)
        _same((kt.optimum, kt.tree), (fused.optimum, fused.tree))


@pytest.mark.parametrize("D,G", [(3, 1), (4, 3)])
def test_sharded_max_batch_with_pad_rows(D, G):
    """B = 3 pads to 4 rows; D = 3 leaves a shorter last block (pad rows
    in the reference's gather tables);
    G = 3 probes three gates per round through the sharded layers."""
    n = 8
    qs = [m(n) for m in (clique, chain, cycle)]
    cards = np.stack([make_cardinalities(q, seed=20 + i)
                      for i, q in enumerate(qs)])
    want = ref_engine.fused_dpconv_max(cards, n, gamma_batch=G)
    got = engine.fused_dpconv_max(cards, n, gamma_batch=G, shards=D,
                                  device=CPU)
    assert [o.hex() for o in got.optima] == [o.hex() for o in want.optima]
    assert [repr(t) for t in got.trees] == [repr(t) for t in want.trees]
    assert (got.rounds, got.passes) == (want.rounds, want.passes)
    assert np.array_equal(got.dp, want.dp)
    rs = dpconv_max_batch(cards, n, shards=D, gamma_batch=G, device=CPU)
    assert [r.optimum for r in rs] == list(got.optima)


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_max_matches_reference_sharded(D, ref_sharded):
    n = 7
    for q, card in _cases(n, seeds=(0, 3)):
        want = ref_dpconv_max(q, card, engine="fused", shards=D)
        got = dpconv_max(_pq(q), card, engine="fused", shards=D, device=CPU)
        _same((got.optimum, got.tree), (want.optimum, want.tree))


# --------------------------------------------------------------- C_out
@pytest.mark.parametrize("D", [2, 8])
def test_sharded_out_bitwise_parity(D):
    n = 7
    for q, card in _cases(n, seeds=(5, 6)):
        sh = optimize(_pq(q), card, cost="out", method="dpccp",
                      engine="fused", shards=D, device=CPU)
        fused = ref_optimize(q, card, cost="out", method="dpccp",
                             engine="fused")
        host = ref_optimize(q, card, cost="out", method="dpccp",
                            engine="host")
        assert sh.meta["engine"] == "fused"
        _same((sh.cost, sh.tree), (fused.cost, fused.tree),
              (host.cost, host.tree))
        assert np.array_equal(sh.meta["dp_table"], fused.meta["dp_table"])
    # a batch of three graphs, seeded, over the same mesh
    qs = [chain(n), cycle(n), star(n)]
    cards = [make_cardinalities(q, seed=30 + i) for i, q in enumerate(qs)]
    want = ref_optimize(qs[0], cards[0], cost="out", method="dpccp",
                        engine="fused")
    so = np.zeros((3, 1 << n), bool)
    so[0] = np.isfinite(want.meta["dp_table"]) & (popcounts(n) <= 4)
    sv = np.zeros((3, 1 << n))
    sv[0] = want.meta["dp_table"]
    got = optimize_batch([_pq(q) for q in qs], cards, cost="out",
                         method="dpccp", engine="fused", shards=D,
                         seed_vals=sv, seed_ok=so, device=CPU)
    for q, c, r in zip(qs, cards, got):
        w = ref_optimize(q, c, cost="out", method="dpccp", engine="host")
        assert r.meta["batched"]
        _same((r.cost, r.tree), (w.cost, w.tree))


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_out_matches_reference_sharded(D, ref_sharded):
    n = 7
    for q, card in _cases(n, seeds=(5, 6)):
        want = ref_optimize(q, card, cost="out", method="dpccp",
                            engine="fused", shards=D)
        got = optimize(_pq(q), card, cost="out", method="dpccp",
                       engine="fused", shards=D, device=CPU)
        _same((got.cost, got.tree), (want.cost, want.tree))


# --------------------------------------------------------------- C_cap
@pytest.mark.parametrize("D", [2, 8])
def test_sharded_cap_bitwise_parity(D):
    n = 7
    for q, card in _cases(n, seeds=(2, 9)):
        sh = ccap(_pq(q), card, engine="fused", shards=D, device=CPU)
        fused = ref_ccap(q, card, engine="fused")
        host = ref_ccap(q, card, engine="host")
        assert sh.engine == "fused" and sh.dispatches == 1
        assert sh.gamma.hex() == fused.gamma.hex() == host.gamma.hex()
        _same((sh.cout, sh.tree), (fused.cout, fused.tree),
              (host.cout, host.tree))


@pytest.mark.parametrize("D", [4])
def test_sharded_cap_connected_bitwise_parity(D):
    n = 7
    for q, card in [(cycle(n), make_cardinalities(cycle(n), seed=4)),
                    (chain(n), make_cardinalities(chain(n), seed=8))]:
        sh = ccap(_pq(q), card, engine="fused", connected=True, shards=D,
                  device=CPU)
        fused = ref_ccap(q, card, engine="fused", connected=True)
        host = ref_ccap(q, card, engine="host", connected=True)
        assert sh.engine == "fused"
        assert sh.gamma.hex() == fused.gamma.hex() == host.gamma.hex()
        _same((sh.cout, sh.tree), (fused.cout, fused.tree),
              (host.cout, host.tree))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_cap_matches_reference_sharded(D, ref_sharded):
    n = 7
    for q, card in _cases(n, seeds=(2, 9)):
        want = ref_ccap(q, card, engine="fused", shards=D)
        got = ccap(_pq(q), card, engine="fused", shards=D, device=CPU)
        assert got.gamma.hex() == want.gamma.hex()
        _same((got.cout, got.tree), (want.cout, want.tree))


# ------------------------------------- above the single-device ceiling
@pytest.mark.parametrize("D", [4])
def test_sharded_cap_n15_matches_host(D):
    """n = 15 C_cap on a 4-way mesh, above the single-device fused
    ceiling (13): gamma, C_out and tree equal to ``repro``'s host
    pipeline and its unsharded fused program."""
    n = 15
    q = chain(n)
    card = make_cardinalities(q, seed=0)
    sh = ccap(_pq(q), card, engine="fused", shards=D, device=CPU)
    host = ref_ccap(q, card, engine="host")
    fused = ref_ccap(q, card, engine="fused")
    assert sh.gamma.hex() == host.gamma.hex() == fused.gamma.hex()
    _same((sh.cout, sh.tree), (host.cout, host.tree),
          (fused.cout, fused.tree))
    assert sh.tree.cost_out(card) == sh.cout


# ----------------------------------------------- cache keys + ceilings
def test_sharded_ceiling_math():
    for base, D, want in [(13, 1, 13), (13, 2, 14), (13, 4, 15),
                          (13, 8, 15), (11, 4, 13)]:
        assert engine.sharded_ceiling(base, D) == want == \
            ref_engine.sharded_ceiling(base, D)


@pytest.mark.parametrize("D", [2])
def test_shard_width_is_a_cache_dimension(D):
    """Distinct mesh widths never alias one program; the same width twice
    is one program (a cache hit)."""
    n = 6
    C = engine.candidate_bucket(n)
    engine.clear_executable_cache()
    e1 = engine.get_program(n, 1, C, "f64", 4, True, 1, CPU)
    e2 = engine.get_program(n, 1, C, "f64", 4, True, 1, CPU, shards=D)
    e4 = engine.get_program(n, 1, C, "f64", 4, True, 1, CPU, shards=2 * D)
    assert e1 is not e2 and e2 is not e4
    assert engine.get_program(n, 1, C, "f64", 4, True, 1, CPU,
                              shards=D) is e2
    assert engine.prewarm([n], max_batch=2, costs=("max", "out"),
                          device=CPU, shards=D)["compiled"] == 3


def test_dispatch_records_carry_lane_and_mesh_identity():
    n = 6
    q, card = clique(n), make_cardinalities(clique(n), seed=1)
    for D, devices in [(1, ("cpu",)), (4, ("cpu",) * 4)]:
        mark = engine.dispatch_mark()
        with engine.dispatch_lane(3):
            dpconv_max(_pq(q), card, engine="fused", shards=D, device=CPU)
        recs = engine.dispatches_since(mark)
        assert recs and recs[-1].lane == 3
        assert recs[-1].shards == D and recs[-1].devices == devices
        assert recs[-1].key[-2:] == (D, devices)
        assert recs[-1].as_dict()["devices"] == list(devices)
        assert engine.current_lane() is None         # context restored


def test_host_loops_refuse_shards_as_the_reference_does():
    q, card = chain(6), make_cardinalities(chain(6), seed=2)
    for kw in ({"engine": "host"}, {"engine": "host", "gamma_batch": 3},
               {"early_exit": True}):
        with pytest.raises(ValueError):
            ref_dpconv_max(q, card, shards=2, **kw)
        with pytest.raises(ValueError):
            dpconv_max(_pq(q), card, shards=2, device=CPU, **kw)
    with pytest.raises(ValueError):
        dpconv_max_batch(card[None], 6, engine="host", shards=2,
                         device=CPU)
    # the host enumerator and the host cap pipeline drop the width
    got = optimize(_pq(q), card, cost="out", method="dpccp", shards=2,
                   device=CPU)
    want = ref_optimize(q, card, cost="out", method="dpccp", shards=2)
    assert got.meta["engine"] == want.meta["engine"] == "host"
    _same((got.cost, got.tree), (want.cost, want.tree))
    # more shards than the mesh may use
    with pytest.raises(ValueError):
        dpconv_max(_pq(q), card, engine="fused", shards=9, device=CPU)


# ------------------------------------------------------------ on a card
@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_on_a_repeated_card(cuda_device, D):
    """A D-slot mesh repeating the card answers as the unsharded solve on
    the card (kernel tier for max), bitwise."""
    n = 9
    q = _pq(cycle(n))
    card = make_cardinalities(cycle(n), seed=7)
    mesh.force_device_count(4)
    for kw in ({"engine": "fused", "backend": "cuda"},):
        a = dpconv_max(q, card, device=cuda_device, **kw)
        b = dpconv_max(q, card, device=cuda_device, shards=D, **kw)
        _same((b.optimum, b.tree), (a.optimum, a.tree))
    for conn in (False, True):
        a = ccap(q, card, engine="fused", connected=conn,
                 device=cuda_device)
        b = ccap(q, card, engine="fused", connected=conn, shards=D,
                 device=cuda_device)
        assert a.gamma.hex() == b.gamma.hex()
        _same((b.cout, b.tree), (a.cout, a.tree))
    a = optimize(q, card, cost="out", method="dpccp", engine="fused",
                 device=cuda_device)
    b = optimize(q, card, cost="out", method="dpccp", engine="fused",
                 shards=D, device=cuda_device)
    _same((b.cost, b.tree), (a.cost, a.tree))


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh.force_device_count(None)
    return min(torch.cuda.device_count(), 4)


@pytest.mark.cuda
def test_sharded_on_distinct_cards(two_cards):
    """A mesh of distinct cards (peer copies per layer) answers as the
    unsharded solve on the lead card, bitwise."""
    D = two_cards
    dev = torch.device("cuda", 0)
    n = 9
    q = _pq(cycle(n))
    card = make_cardinalities(cycle(n), seed=7)
    assert len(set(engine.solve_mesh(D, dev))) == D
    a = ccap(q, card, engine="fused", device=dev)
    b = ccap(q, card, engine="fused", shards=D, device=dev)
    assert a.gamma.hex() == b.gamma.hex()
    _same((b.cout, b.tree), (a.cout, a.tree))
    a = dpconv_max(q, card, engine="fused", backend="cuda", device=dev)
    b = dpconv_max(q, card, engine="fused", backend="cuda", shards=D,
                   device=dev)
    _same((b.optimum, b.tree), (a.optimum, a.tree))
