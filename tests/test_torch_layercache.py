"""The port's warm starts and layer cache against ``repro``.

Seeds are perf hints: a seeded solve must return the bitwise-identical
optimum (``float.hex``), tree (``repr``) and, for C_out, DP table of the
cold solve, on every fused lane, and equal ``repro``'s seeded solve on the
same inputs.  A verified seed costs exactly one search round; a stale one
is ignored; a chunk that mixes seeded and cold rows equals cold.  The
port's ``LayerCache`` (a numpy copy) is held to the reference's stats,
payloads, admission gate and on-disk round trip.  The reference runs on
the CPU as its own tests run it; the port on ``device="cpu"``.
"""
import functools

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import lattice as ref_lattice
from repro.core.dpconv import optimize as ref_optimize
from repro.core.querygraph import (chain, clique, cycle, make_cardinalities,
                                   paper_clique_instance, permute_card,
                                   relabel, star)
from repro.service.batch import BatchedSolver as RefSolver
from repro.service.canon import canonicalize as ref_canonicalize
from repro.service.layercache import LayerCache as RefLayerCache
from repro.service.server import PlanRequest as RefRequest
from repro.service.server import PlanServer as RefServer
from repro_torch.core import bitset, engine, lattice, querygraph
from repro_torch.core.dpconv import optimize
from repro_torch.kernels import ops
from repro_torch.service.batch import BatchedSolver
from repro_torch.service import canon
from repro_torch.service.canon import canonicalize
from repro_torch.service.layercache import LayerCache, _perm_masks
from repro_torch.service.server import PlanRequest, PlanServer

CPU = "cpu"
TOPOS = {"chain": chain, "star": star, "clique": clique}
N = 7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pq(q):
    """The port's query graph for a reference one."""
    return querygraph.QueryGraph(q.n, tuple(q.edges), tuple(q.hyperedges))


def _solve(opt, q, card, cost, **kw):
    """The server's exact fused routes, with optional seeds."""
    if cost == "out":
        return opt(q, card, cost="out", method="dpccp", engine="fused", **kw)
    return opt(q, card, cost=cost, engine="fused", **kw)


def _port_opt(*args, **kw):
    return optimize(*args, device=CPU, **kw)


def _seed_kw(seed):
    if seed is None:
        return {}
    if "opt" in seed:
        return {"seed_opt": float(seed["opt"])}
    return {"seed_vals": seed["vals"], "seed_ok": seed["ok"]}


def _key(res):
    return float(res.cost).hex(), repr(res.tree)


@functools.lru_cache(maxsize=None)
def _instance(topo: str, cost: str):
    """One query, both packages' canonical forms, and each package's
    cold solve and layer cache after observing it (built once)."""
    q = TOPOS[topo](N)
    card = make_cardinalities(q, seed=17)
    rf, pf = ref_canonicalize(q, card), canonicalize(_pq(q), card)
    rc = _solve(ref_optimize, rf.q, rf.card, cost)
    pc = _solve(_port_opt, pf.q, pf.card, cost)
    return q, card, rf, pf, rc, pc


def _relabeled(q, card, perm_seed):
    perm = np.random.default_rng(perm_seed).permutation(q.n)
    return relabel(q, perm), permute_card(card, q.n, perm)


# -------------------------------------------------- seeded == cold == repro
@pytest.mark.parametrize("perm_seed", [1, 2])
@pytest.mark.parametrize("cost", ["max", "cap", "out"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_seeded_solve_matches_cold_and_reference(topo, cost, perm_seed):
    q, card, rf, pf, rc, pc = _instance(topo, cost)
    assert _key(pc) == _key(rc)
    rl, pl = RefLayerCache(), LayerCache()
    rl.observe(rf, cost, rc.cost, rc.meta, dp=rc.meta.get("dp_table"))
    pl.observe(pf, cost, pc.cost, pc.meta, dp=pc.meta.get("dp_table"))
    q2, card2 = _relabeled(q, card, perm_seed)
    rf2, pf2 = ref_canonicalize(q2, card2), canonicalize(_pq(q2), card2)
    assert pf2.key == rf2.key == rf.key
    rs, ps = rl.seed_for(rf2, cost), pl.seed_for(pf2, cost)
    assert ps is not None and rs is not None
    if cost == "out":
        assert ps["vals"].tobytes() == rs["vals"].tobytes()
        assert ps["ok"].tobytes() == rs["ok"].tobytes()
    else:
        assert ps == rs and isinstance(ps["opt"], float)
    engine.reset_stats()
    warm = _solve(_port_opt, pf2.q, pf2.card, cost, **_seed_kw(ps))
    assert engine.stats().seeded_solves == 1
    ref_warm = _solve(ref_optimize, rf2.q, rf2.card, cost, **_seed_kw(rs))
    assert _key(warm) == _key(pc) == _key(ref_warm)
    if cost == "out":
        assert warm.meta["dp_table"].tobytes() == \
            pc.meta["dp_table"].tobytes()
    assert pl.stats.as_dict() == rl.stats.as_dict()


STALE = ["smallest", "largest", "foreign", "inf"]


@pytest.mark.parametrize("stale", STALE)
@pytest.mark.parametrize("cost", ["max", "cap"])
def test_stale_search_seed_is_ignored(cost, stale):
    """A wrong cached optimum (an infeasible candidate, a feasible but
    not minimal one, a value that is no candidate, or +inf) changes
    nothing: the dual probe rejects it."""
    q = clique(6)
    card = make_cardinalities(q, seed=11)
    form = canonicalize(_pq(q), card)
    cand = engine.candidate_table(form.card, form.q.n)
    cold = _solve(_port_opt, form.q, form.card, cost)
    seed = {"smallest": float(cand[0]), "largest": float(cand[-1]),
            "foreign": float(cold.cost) * 3.0, "inf": np.inf}[stale]
    warm = _solve(_port_opt, form.q, form.card, cost, seed_opt=seed)
    ref_warm = _solve(ref_optimize, form.q, form.card, cost,
                      seed_opt=seed)
    assert _key(warm) == _key(cold) == _key(ref_warm)


@pytest.mark.parametrize("cost", ["max", "cap"])
def test_verified_seed_costs_one_round(cost):
    """A correct seed costs exactly one round (the verification probe),
    as in the reference, and no host sync beyond the loop's exit test
    and the result copies."""
    q = clique(8)
    card = make_cardinalities(q, seed=5)
    form = canonicalize(_pq(q), card)
    engine.reset_stats()
    ref_engine.reset_stats()
    cold = _solve(_port_opt, form.q, form.card, cost)
    cold_rounds = engine.stats().rounds
    _solve(ref_optimize, form.q, form.card, cost)
    assert ref_engine.stats().rounds == cold_rounds
    opt = float(cold.meta.get("gamma", cold.cost))
    engine.reset_stats()
    ref_engine.reset_stats()
    warm = _solve(_port_opt, form.q, form.card, cost, seed_opt=opt)
    ref_warm = _solve(ref_optimize, form.q, form.card, cost, seed_opt=opt)
    assert engine.stats().rounds == ref_engine.stats().rounds == 1
    assert cold_rounds > 1
    # the loop's exit test and the result copies (four, and the cap
    # sweep's live-set count): the probe adds none
    assert engine.stats().host_syncs == 1 + (5 if cost == "cap" else 4)
    assert _key(warm) == _key(cold) == _key(ref_warm)
    fs = engine.fused_dpconv_max(form.card, 8, seed_opt=[opt], device=CPU)
    assert (fs.rounds, fs.seeded, fs.syncs) == (1, 1, 1 + 4)


# ------------------------------------------------- the lattice's seed slots
TIERS = {"f64": ("xla", np.float64), "cuda": ("pallas", np.int32)}


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_feasibility_layers_seed_replay(tier, scan):
    """Layers 2..k0 replayed from a solved table (``seed_layers``) give
    the cold recursion's tables bitwise, and the reference's seeded run
    in each of its two middle-layer forms (``scan``)."""
    n = 7
    ref_name, dtype = TIERS[tier]
    pc = np.array([bin(s).count("1") for s in range(1 << n)])
    card = make_cardinalities(clique(n), seed=23)
    gate = np.where(pc >= 2, card <= np.quantile(card[pc >= 2], 0.7),
                    True).astype(dtype)[None, :]
    tfm = lattice.transforms(tier)
    cold = lattice.feasibility_layers(torch.from_numpy(gate), n, 4, tfm,
                                      False)
    seed = (4, cold[0].numpy())
    warm = lattice.feasibility_layers(torch.from_numpy(gate), n, 4, tfm,
                                      False, seed_layers=seed)
    ref = ref_lattice.feasibility_layers(
        jnp.asarray(gate), n, 4, ref_lattice.transforms(ref_name), False,
        scan_middle=scan, seed_layers=seed)
    for c, w, r in zip(cold, warm, ref):
        assert np.array_equal(w.numpy(), c.numpy())
        assert np.array_equal(w.numpy(), np.asarray(r))


@pytest.mark.parametrize("cost", ["max", "max_seeded", "cap_seeded",
                                  "cap_conn_seeded", "out", "out_seeded"])
def test_program_card_matches_reference(cost):
    for tier, ref_name in (("f64", "xla"), ("cuda", "pallas")):
        got = lattice.program_card(9, cost, backend=tier, gamma_batch=3)
        want = ref_lattice.program_card(9, cost, backend=ref_name,
                                        gamma_batch=3)
        tiers = {"xla": "f64", "pallas": "cuda"}
        assert got == {**want, "backend": tiers[want["backend"]]}
    with pytest.raises(ValueError):
        lattice.program_card(9, "smj")


# --------------------------------------------------- mixed batch chunks
def _chunk_items(n, B, seed):
    qs = [(clique, chain, star, cycle)[i % 4](n) for i in range(B)]
    # small base tables: no row saturates c(V), so every row searches
    return [(q, make_cardinalities(q, seed=seed + i, base_range=(1e1, 1e3)))
            for i, q in enumerate(qs)]


@pytest.mark.parametrize("cost", ["max", "cap", "out"])
def test_mixed_seeded_and_cold_chunk_equals_cold(cost):
    """One chunk of 4 where rows carry a correct seed, a stale seed, no
    seed and a correct seed: the seeded program runs, its results equal
    the cold chunk's and the reference's seeded chunk."""
    items = _chunk_items(6, 4, seed=31)
    port = [(_pq(q), c, cost) for q, c in items]
    solver = BatchedSolver(device=CPU)
    cold = solver.solve(port)
    if cost == "out":
        seeds = []
        for b, r in enumerate(cold):
            if b == 2:
                seeds.append(None)
                continue
            ok = np.zeros(1 << 6, bool)
            ok[[3, 5, 7, 12]] = True
            seeds.append({"vals": r.meta["dp_table"].copy(), "ok": ok})
    else:
        opt = [float(r.meta.get("gamma", r.cost)) for r in cold]
        stale = float(engine.candidate_table(items[1][1], 6)[-1])
        assert stale != opt[1]
        seeds = [{"opt": opt[0]}, {"opt": stale}, None, {"opt": opt[3]}]
    engine.reset_stats()
    warm = solver.solve([it + ("", s) for it, s in zip(port, seeds)])
    assert engine.stats().seeded_solves == 1
    assert engine.stats().seeded_rows == 3
    ref = RefSolver().solve([(q, c, cost, "", s)
                             for (q, c), s in zip(items, seeds)])
    for c, w, r in zip(cold, warm, ref):
        assert _key(w) == _key(c) == _key(r)
        if cost == "out":
            assert w.meta["dp_table"].tobytes() == \
                c.meta["dp_table"].tobytes()


# ------------------------------------------------------- the fragment store
def test_value_fragment_transfers_to_relabeled_subgraph():
    """A solved chain(7) C_out table seeds a later chain(6) query that
    is its leave-one-out induced sub-problem under a relabeling."""
    big = chain(7)
    card_big = make_cardinalities(big, seed=3)
    form_big = canonicalize(_pq(big), card_big)
    rform_big = ref_canonicalize(big, card_big)
    cold_big = _solve(_port_opt, form_big.q, form_big.card, "out")
    lc, rlc = LayerCache(), RefLayerCache()
    lc.observe(form_big, "out", cold_big.cost, cold_big.meta,
               dp=cold_big.meta["dp_table"])
    rlc.observe(rform_big, "out", cold_big.cost, cold_big.meta,
                dp=cold_big.meta["dp_table"])
    assert lc.stats.value_inserts == 8
    small = chain(6)
    perm = np.random.default_rng(7).permutation(6)
    q2 = relabel(small, perm)
    card2 = permute_card(card_big[: 1 << 6].copy(), 6, perm)
    form2 = canonicalize(_pq(q2), card2)
    seed = lc.seed_for(form2, "out")
    rseed = rlc.seed_for(ref_canonicalize(q2, card2), "out")
    assert seed is not None and lc.stats.value_hits >= 1
    assert seed["vals"].tobytes() == rseed["vals"].tobytes()
    assert seed["ok"].tobytes() == rseed["ok"].tobytes()
    pc = np.array([bin(i).count("1") for i in range(1 << 6)])
    assert not seed["ok"][pc < 2].any() and seed["ok"][-1]
    cold2 = _solve(_port_opt, form2.q, form2.card, "out")
    dp2 = cold2.meta["dp_table"]
    assert np.array_equal(seed["vals"][seed["ok"]], dp2[seed["ok"]])
    warm2 = _solve(_port_opt, form2.q, form2.card, "out", **_seed_kw(seed))
    assert _key(warm2) == _key(cold2)
    assert warm2.meta["dp_table"].tobytes() == dp2.tobytes()
    assert lc.stats.as_dict() == rlc.stats.as_dict()


@pytest.mark.parametrize("r", range(11))
def test_perm_masks_match_a_per_subset_loop(r):
    """A fragment's relabeling map is each compact subset's image under
    a random ``perm``, subset by subset; the popcounts the probe masks
    with are each subset's bit count."""
    perm = np.random.default_rng(200 + r).permutation(r)
    got = _perm_masks(tuple(perm.tolist()))
    assert got.dtype == np.int64
    assert got.tolist() == [querygraph.permute_mask(t, perm)
                            for t in range(1 << r)]
    assert bitset.popcounts(r).tolist() == \
        [bin(t).count("1") for t in range(1 << r)]


@pytest.mark.parametrize("card_kind", ["random", "equal"])
@pytest.mark.parametrize("topo", ["chain", "star", "cycle"])
def test_fragment_harvest_and_probe_permute_once_a_leaf(topo, card_kind):
    """A harvest and a probe of n = 9 take n + 1 subset signatures each,
    every leaf permuting its table once (one leaf a signature on random
    cardinalities), with the reference's payload and stats."""
    mk = {"chain": chain, "star": star, "cycle": cycle}[topo]
    q = mk(9)
    card = make_cardinalities(q, seed=5) if card_kind == "random" \
        else np.full(1 << 9, 11.0)
    form, rform = canonicalize(_pq(q), card), ref_canonicalize(q, card)
    dp = np.arange(1 << 9, dtype=np.float64) * 0.5
    lc, rlc = LayerCache(admission_min_probes=0), \
        RefLayerCache(admission_min_probes=0)
    before = canon.stats()
    lc.observe(form, "out", 1.0, {}, dp=dp)
    seed = lc.seed_for(form, "out")
    now = canon.stats()
    d = {k: now[k] - before[k] for k in now}
    rlc.observe(rform, "out", 1.0, {}, dp=dp)
    rseed = rlc.seed_for(rform, "out")
    assert seed["vals"].tobytes() == rseed["vals"].tobytes()
    assert seed["ok"].tobytes() == rseed["ok"].tobytes()
    assert lc.stats.as_dict() == rlc.stats.as_dict()
    assert d["forms"] == 0 and d["subset_forms"] >= 10
    assert d["table_perms"] == d["leaves"]
    if card_kind == "random":
        assert d["leaves"] == d["subset_forms"]


@pytest.mark.parametrize("store", ["search", "value"])
def test_lru_eviction(store):
    lc, rlc = LayerCache(search_capacity=2, value_capacity=4), \
        RefLayerCache(search_capacity=2, value_capacity=4)
    for s in range(3):
        q = chain(5)
        card = make_cardinalities(q, seed=100 + s)
        form = canonicalize(_pq(q), card)
        rform = ref_canonicalize(q, card)
        cost = "max" if store == "search" else "out"
        r = _solve(_port_opt, form.q, form.card, cost)
        for cache, f in ((lc, form), (rlc, rform)):
            cache.observe(f, cost, r.cost, r.meta,
                          dp=r.meta.get("dp_table"))
    assert lc.stats.evictions > 0
    assert lc.stats.as_dict() == rlc.stats.as_dict()
    assert len(lc) == len(rlc)


def test_admission_gate():
    """Below the probe floor a signature inserts; past it, a signature
    whose hit rate is under the floor stops inserting; the gate is off
    with ``admission_min_probes <= 0``."""
    q = clique(5)
    caches = [LayerCache(admission_min_probes=4),
              RefLayerCache(admission_min_probes=4)]
    forms = []
    for s in range(6):
        card = make_cardinalities(q, seed=200 + s)
        forms.append((canonicalize(_pq(q), card),
                      ref_canonicalize(q, card)))
    for pf, rf in forms:
        for cache, f in zip(caches, (pf, rf)):
            assert cache.seed_for(f, "max") is None
            cache.observe(f, "max", 1.0 + len(cache), {})
    lc, rlc = caches
    # probes 1..3 come before the floor; from the 4th on, 0 hits refuse
    assert lc.stats.admission_skips == rlc.stats.admission_skips == 3
    assert lc.stats.search_inserts == rlc.stats.search_inserts == 3
    assert lc.stats.as_dict() == rlc.stats.as_dict()
    off = LayerCache(admission_min_probes=0)
    for pf, _ in forms:
        off.seed_for(pf, "max")
        off.observe(pf, "max", 2.0, {})
    assert off.stats.admission_skips == 0 and off.stats.search_inserts == 6


def test_single_signature_batch_closes_the_gate():
    """One ``_process`` call with 16 cold cliques of one signature probes
    every seed before the chunk is solved, so the default gate (16
    probes, hit rate under 5%) refuses all 16 inserts — in the reference
    as in the port."""
    items = [clique(6) for _ in range(16)]
    cards = [make_cardinalities(q, seed=500 + i) for i, q in
             enumerate(items)]
    srv = PlanServer(enable_cache=False, device=CPU)
    ref = RefServer(enable_cache=False)
    got = srv._process([PlanRequest(q=_pq(q), card=c)
                        for q, c in zip(items, cards)])
    want = ref._process([RefRequest(q=q, card=c)
                         for q, c in zip(items, cards)])
    assert [_key(g) for g in got] == [_key(w) for w in want]
    st = srv.layers.stats
    assert st.admission_skips == 16 and st.search_inserts == 0
    assert st.as_dict() == ref.layers.stats.as_dict()


def test_save_load_round_trip(tmp_path):
    lc = LayerCache()
    q = chain(6)
    for s in range(2):
        card = make_cardinalities(q, seed=300 + s)
        form = canonicalize(_pq(q), card)
        for cost in ("max", "out"):
            r = _solve(_port_opt, form.q, form.card, cost)
            lc.observe(form, cost, r.cost, r.meta,
                       dp=r.meta.get("dp_table"))
    path = str(tmp_path / "frags.npz")
    assert lc.save(path) == len(lc) > 0
    back = LayerCache()
    assert back.load(path) == len(lc)
    assert list(back._search.items()) == list(lc._search.items())
    assert [(k, v.tobytes()) for k, v in back._values.items()] == \
        [(k, v.tobytes()) for k, v in lc._values.items()]
    rback = RefLayerCache()                 # the same on-disk format
    assert rback.load(path) == len(lc)
    assert list(rback._search.items()) == list(lc._search.items())
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert LayerCache().load(str(tmp_path / "bad.npz")) == 0
    assert LayerCache().load(str(tmp_path / "missing.npz")) == 0


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_seeded_kernel_tier_chunk_on_card_equals_cold(cuda_device):
    """A max chunk at n = 13 on the int32 kernel tier: the seeded
    program (one verification round, ``zeta_cluster`` launches) returns
    the cold chunk's optima, trees and DP tables."""
    cards = np.stack([paper_clique_instance(13, s)[1] for s in range(4)])
    cold = engine.fused_dpconv_max(cards, 13, backend="cuda",
                                   device=cuda_device)
    ops.reset_launch_counts()
    warm = engine.fused_dpconv_max(cards, 13, backend="cuda",
                                   seed_opt=[float(o) for o in cold.optima],
                                   device=cuda_device)
    assert ops.launch_counts()["zeta_cluster"] > 0
    assert (warm.rounds, warm.seeded) == (1, 4) and cold.rounds > 1
    assert [o.hex() for o in warm.optima] == [o.hex() for o in cold.optima]
    assert [str(t) for t in warm.trees] == [str(t) for t in cold.trees]
    assert warm.dp.tobytes() == cold.dp.tobytes()
    cpu = engine.fused_dpconv_max(cards, 13, backend="cuda",
                                  seed_opt=[float(o) for o in cold.optima],
                                  device=CPU)
    assert [o.hex() for o in cpu.optima] == [o.hex() for o in warm.optima]
