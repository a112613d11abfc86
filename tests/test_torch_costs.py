"""The port's C_cap and C_out lanes, and every (cost, method) pair of its
``optimize`` façade, against ``repro``, bitwise.

The same inputs (numpy, fixed seeds) go through both packages on the
CPU: the numpy copies (``baselines``, ``dpccp``, ``best_effort``), the
(min,+) layer sweeps and the value-mode extraction scan, the fused C_cap
and C_out programs (the kernel tier's plain versions against the
reference's Pallas tier in interpret mode), the FFT-embedded exact C_out
and its (1+eps) approximation, the subset convolution and Kronecker
transforms, the façade and the four-cost batch lane.  Tables compare by
``tobytes()``, optima by ``float.hex``, trees by ``str``.  The ``cuda``
cases hold the fused programs and the FFT paths on the card against the
CPU.
"""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as ref_approx
from repro.core import baselines as ref_baselines
from repro.core import best_effort as ref_best_effort
from repro.core import dpccp as ref_dpccp
from repro.core import dpconv as ref_dpconv
from repro.core import dpconv_out as ref_dpconv_out
from repro.core import engine as ref_engine
from repro.core import fsc as ref_fsc
from repro.core import lattice as ref_lattice
from repro.core import zeta as ref_zeta
from repro.core.bitset import popcounts
from repro.core.querygraph import (QueryGraph, chain, clique, cycle,
                                   make_cardinalities, star)
from repro.service import batch as ref_batch
from repro_torch import convert
from repro_torch.core import (approx, baselines, best_effort, dpccp,
                              dpconv_out, engine, fsc, lattice, zeta)
from repro_torch.core.ccap import ccap, ccap_batch
from repro_torch.core.dpconv import optimize, optimize_batch
from repro_torch.kernels import ops
from repro_torch.service.batch import BatchedSolver, BatchPolicy

CPU = "cpu"
TOPOS = {"clique": clique, "chain": chain, "star": star, "cycle": cycle}
MAKERS = list(TOPOS.values())
TIERS = {"f64": "xla", "cuda": "pallas"}


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


def _port(q):
    """The port's query graph for a reference one."""
    return convert.from_reference(q.n, q.edges, q.hyperedges,
                                  np.ones(1 << q.n), device=CPU)[0]


def _batch(n: int, B: int, seed: int):
    """B mixed-topology queries of size n and their (B, 2^n) tables."""
    qs = [MAKERS[(seed + i) % len(MAKERS)](n) for i in range(B)]
    cards = np.stack([make_cardinalities(q, seed=seed + i)
                      for i, q in enumerate(qs)])
    return qs, cards


def _int_cards(n: int, seed: int, w: int = 8) -> np.ndarray:
    """Small-W integral tables, the regime of the FFT embedding."""
    card = np.random.default_rng(seed).integers(1, w + 1, 1 << n)
    card = card.astype(np.float64)
    card[0] = 1.0
    return card


def _hex(xs) -> list:
    return [float(x).hex() for x in xs]


def _strs(ts) -> list:
    return [str(t) for t in ts]


# ------------------------------------------------------- numpy copies
COPY_CASES = [(t, n) for t in TOPOS for n in (4, 6, 8)]


@pytest.mark.parametrize("topo,n", COPY_CASES,
                         ids=[f"{t}-{n}" for t, n in COPY_CASES])
def test_baselines_copy_matches_reference(topo, n):
    q = TOPOS[topo](n)
    card = make_cardinalities(q, seed=n)
    conn = q.connected_mask()
    gamma = float(np.quantile(card, 0.7))
    for kw in ({"mode": "out"}, {"mode": "max"}, {"mode": "smj"},
               {"mode": "out", "prune_gamma": gamma},
               {"mode": "out", "connected": conn}):
        assert baselines.dpsub(card, n, **kw).tobytes() == \
            ref_baselines.dpsub(card, n, **kw).tobytes()
    assert baselines.dpsub_out(card, n).tobytes() == \
        ref_baselines.dpsub_out(card, n).tobytes()
    assert baselines.dpsub_max(card, n).tobytes() == \
        ref_baselines.dpsub_max(card, n).tobytes()
    for mode in ("out", "max"):
        assert baselines.dpsize(card, n, mode).tobytes() == \
            ref_baselines.dpsize(card, n, mode).tobytes()
        dp, t = baselines.dpsub_with_tree(card, n, mode=mode)
        rdp, rt = ref_baselines.dpsub_with_tree(card, n, mode=mode)
        assert dp.tobytes() == rdp.tobytes() and str(t) == str(rt)


@pytest.mark.parametrize("topo,n", COPY_CASES,
                         ids=[f"{t}-{n}" for t, n in COPY_CASES])
def test_dpccp_copy_matches_reference(topo, n):
    rq = TOPOS[topo](n)
    q = _port(rq)
    card = make_cardinalities(rq, seed=n + 1)
    assert dpccp.enumerate_csg_cmp_pairs(q) == \
        ref_dpccp.enumerate_csg_cmp_pairs(rq)
    conn = dpccp.connectivity_masks(q)
    assert conn.tobytes() == ref_dpccp.connectivity_masks(rq).tobytes()
    assert dpccp.ccp_pair_count(conn, n) == \
        ref_dpccp.ccp_pair_count(conn, n)
    gamma = float(np.quantile(card, 0.8))
    for kw in ({"mode": "out"}, {"mode": "max"},
               {"mode": "out", "prune_gamma": gamma}):
        dp, cnt = dpccp.dpccp(q, card, **kw)
        rdp, rcnt = ref_dpccp.dpccp(rq, card, **kw)
        assert dp.tobytes() == rdp.tobytes() and cnt == rcnt
    for mode in ("out", "max"):
        dp, t = dpccp.dpccp_with_tree(q, card, mode=mode)
        rdp, rt = ref_dpccp.dpccp_with_tree(rq, card, mode=mode)
        assert dp.tobytes() == rdp.tobytes() and str(t) == str(rt)
    with pytest.raises(ValueError):
        dpccp.connectivity_masks(_port(QueryGraph(3, ((0, 1),),
                                                  ((0b010, 0b100),))))


@pytest.mark.parametrize("topo,n", COPY_CASES,
                         ids=[f"{t}-{n}" for t, n in COPY_CASES])
def test_best_effort_copy_matches_reference(topo, n):
    rq = TOPOS[topo](n)
    q = _port(rq)
    card, base, sel = make_cardinalities(
        rq, seed=n + 2, base_range=(1e2, 1e4), selectivity_range=(1e-2, 1.0),
        cap=1e30, return_model=True)
    for cross in (True, False):
        assert str(best_effort.goo(q, card, allow_cross=cross)) == \
            str(ref_best_effort.goo(rq, card, allow_cross=cross))
    for conn_only in (True, False):
        assert best_effort.dpsub_leftdeep(q, card, conn_only).tobytes() \
            == ref_best_effort.dpsub_leftdeep(rq, card, conn_only).tobytes()
    if topo in ("chain", "star"):                 # IKKBZ takes trees only
        seq, t = best_effort.ikkbz(q, base, sel, card)
        rseq, rt = ref_best_effort.ikkbz(rq, base, sel, card)
        assert seq == rseq and str(t) == str(rt)
    else:
        with pytest.raises(ValueError):
            best_effort.ikkbz(q, base, sel, card)


# ------------------------------------------------ (min,+) layer sweeps
@pytest.mark.parametrize("n", [5, 6, 7, 8, 9])
def test_minplus_layers_bitwise(n):
    qs, cards = _batch(n, 3, seed=30 + n)
    pc = popcounts(n)
    gammas = [np.quantile(c[pc >= 2], 0.5 + 0.2 * i)
              for i, c in enumerate(cards)]
    gate = (cards <= np.array(gammas)[:, None]) | (pc < 2)
    conn = np.stack([q.connected_mask() for q in qs])
    want = ref_lattice.minplus_value_layers(jnp.asarray(cards),
                                            jnp.asarray(gate), n)
    got = lattice.minplus_value_layers(torch.from_numpy(cards),
                                       torch.from_numpy(gate), n)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    for mask in (conn, conn & gate):
        want = ref_lattice.minplus_connected_layers(
            jnp.asarray(cards), jnp.asarray(mask), n)
        got = lattice.minplus_connected_layers(
            torch.from_numpy(cards), torch.from_numpy(mask), n)
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    # each row is its host oracle: pruned DPsub and DPccp
    val = lattice.minplus_value_layers(torch.from_numpy(cards),
                                       torch.from_numpy(gate), n).numpy()
    con = lattice.minplus_connected_layers(torch.from_numpy(cards),
                                           torch.from_numpy(conn), n).numpy()
    for b, q in enumerate(qs):
        assert val[b].tobytes() == ref_baselines.dpsub(
            cards[b], n, mode="out", prune_gamma=gammas[b]).tobytes()
        assert con[b].tobytes() == ref_dpccp.dpccp(q, cards[b])[0].tobytes()


@pytest.mark.parametrize("n", [5, 7, 9])
def test_extract_scan_value_mode_bitwise(n):
    qs, cards = _batch(n, 3, seed=50 + n)
    conn = np.stack([q.connected_mask() for q in qs])
    dp = lattice.minplus_connected_layers(torch.from_numpy(cards),
                                          torch.from_numpy(conn), n)
    got = lattice.extract_scan(dp, n, card=torch.from_numpy(cards))
    want = ref_lattice.extract_scan(jnp.asarray(dp.numpy()), n,
                                    card=jnp.asarray(cards))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the witness rule of the host extractor
    from repro_torch.core import jointree
    for b in range(3):
        t = jointree.tree_from_split_arrays(got[0][b].numpy(),
                                            got[1][b].numpy())
        assert str(t) == str(jointree.extract_tree_out(
            dp.numpy()[b], cards[b], n))


# ------------------------------------------------------- fused programs
CAP_CASES = [(c, s, G, t) for c in (False, True) for s in (1.0, 1.5)
             for G in (1, 3) for t in ("f64", "cuda")]


@pytest.mark.parametrize(
    "connected,slack,G,tier", CAP_CASES,
    ids=[f"{'conn' if c else 'full'}-s{s}-G{G}-{t}"
         for c, s, G, t in CAP_CASES])
def test_fused_ccap_matches_reference(connected, slack, G, tier):
    n = 6
    qs, cards = _batch(n, 3, seed=7)
    want = ref_engine.fused_ccap(cards, n, gamma_slack=slack,
                                 backend=TIERS[tier], gamma_batch=G,
                                 qs=qs if connected else None)
    ops.reset_launch_counts()
    engine.reset_stats()
    got = engine.fused_ccap(torch.from_numpy(cards), n, gamma_slack=slack,
                            backend=tier, gamma_batch=G,
                            qs=[_port(q) for q in qs] if connected else None,
                            device=CPU)
    assert sum(ops.launch_counts().values()) == 0   # plain versions on CPU
    assert _hex(got.gammas) == _hex(want.gammas)
    assert _hex(got.couts) == _hex(want.couts)
    finite = np.isfinite(want.couts)
    assert _strs(np.array(got.trees)[finite]) == \
        _strs(np.array(want.trees)[finite])
    assert got.rounds == int(want.rounds) and got.dispatches == 1
    st = engine.stats()
    assert (st.dispatches, st.solves, st.queries, st.rounds) == \
        (1, 1, 3, got.rounds)
    # one loop-condition read per round, the exit test, 5 result copies
    # (the reference's 4 and the sweep's live-set count)
    assert st.host_syncs == got.syncs == got.rounds + 1 + 5


@pytest.mark.parametrize("n,B", [(5, 3), (7, 4), (8, 5)])
def test_fused_out_matches_reference(n, B):
    qs, cards = _batch(n, B, seed=n)
    want = ref_engine.fused_out(qs, cards, n)
    engine.reset_stats()
    got = engine.fused_out([_port(q) for q in qs], cards, n, device=CPU)
    assert _hex(got.couts) == _hex(want.couts)
    assert got.dp.tobytes() == np.asarray(want.dp).tobytes()
    assert _strs(got.trees) == _strs(want.trees)
    st = engine.stats()
    assert (st.dispatches, st.solves, st.queries, st.rounds) == (1, 1, B, 0)
    # the result copies only: the reference's 4 and the live-set count
    assert st.host_syncs == got.syncs == 5
    short = engine.fused_out([_port(q) for q in qs], cards, n,
                             extract_tree=False, device=CPU)
    assert _hex(short.couts) == _hex(want.couts) and short.syncs == 2


def test_fused_programs_reject_what_dpccp_excludes():
    cards = make_cardinalities(chain(5), seed=1)[None, :]
    split = _port(QueryGraph(5, ((0, 1), (2, 3), (3, 4))))
    hyper = _port(QueryGraph(5, ((0, 1), (1, 2), (2, 3), (3, 4)),
                             ((0b00001, 0b10000),)))
    for q in (split, hyper):
        with pytest.raises(ValueError):
            engine.fused_out([q], cards, 5, device=CPU)
        with pytest.raises(ValueError):
            engine.fused_ccap(cards, 5, qs=[q], device=CPU)
    # padding: B = 3 runs as 4 rows that repeat row 0, conn included
    qs, cards3 = _batch(5, 3, seed=2)
    fo = engine.fused_out([_port(q) for q in qs], cards3, 5, device=CPU)
    assert fo.dp.shape == (3, 32) and len(fo.trees) == 3


# ----------------------------------------------- FFT-embedded C_out
@pytest.mark.parametrize("n", [3, 4, 5, 6, 7])
def test_dpconv_out_matches_reference(n):
    card = _int_cards(n, seed=n)
    opt, dp, tree = dpconv_out.dpconv_out(card, n, extract_tree=True,
                                          device=CPU)
    ropt, rdp, rtree = ref_dpconv_out.dpconv_out(card, n, extract_tree=True)
    assert opt == ropt and dp.dtype == np.int64
    assert dp.tobytes() == np.asarray(rdp).tobytes()
    assert str(tree) == str(rtree)
    assert opt == ref_baselines.dpsub_out(card, n)[-1]
    with pytest.raises(ValueError):
        dpconv_out.dpconv_out(card + 0.5, n, device=CPU)


APPROX_CASES = [(e, c) for e in (0.05, 0.25, 1.0) for c in ("out", "smj")]


@pytest.mark.parametrize("eps,cost", APPROX_CASES,
                         ids=[f"{c}-{e}" for e, c in APPROX_CASES])
def test_approx_out_matches_reference(eps, cost):
    n = 5
    card = make_cardinalities(clique(n), seed=3, cap=1e5)
    val, dp = approx.approx_out(card, n, eps=eps, cost=cost, device=CPU)
    rval, rdp = ref_approx.approx_out(card, n, eps=eps, cost=cost)
    assert val.hex() == rval.hex() and dp.tobytes() == rdp.tobytes()
    true_opt = baselines.dpsub(card, n, mode=cost)[-1]
    assert true_opt * (1 - 1e-9) <= val <= (1 + eps) * true_opt


@pytest.mark.parametrize("n", [3, 6, 9])
def test_fsc_and_transforms_match_reference(n):
    rng = np.random.default_rng(n)
    f = rng.integers(0, 2, 1 << n).astype(np.float64)
    g = rng.integers(0, 2, 1 << n).astype(np.float64)
    pc = popcounts(n)
    got = fsc.subset_convolve(torch.from_numpy(f), torch.from_numpy(g),
                              torch.from_numpy(pc))
    want = ref_fsc.subset_convolve(jnp.asarray(f), jnp.asarray(g),
                                   jnp.asarray(pc))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert np.array_equal(got.numpy(), fsc.subset_convolve_ref(f, g))
    assert np.array_equal(fsc.rank_split(torch.from_numpy(f),
                                         torch.from_numpy(pc)).numpy(),
                          np.asarray(ref_fsc.rank_split(jnp.asarray(f),
                                                        jnp.asarray(pc))))
    x = rng.integers(-9, 10, (2, 1 << n)).astype(np.float64)
    for split in (None, 1):
        z = zeta.zeta_matmul(torch.from_numpy(x), split=split).numpy()
        assert z.tobytes() == np.asarray(
            ref_zeta.zeta_matmul(jnp.asarray(x), split=split)).tobytes()
        m = zeta.mobius_matmul(torch.from_numpy(z), split=split).numpy()
        assert np.array_equal(m, x)
    assert zeta.zeta_np(x).tobytes() == ref_zeta.zeta_np(x).tobytes()
    assert zeta.mobius_np(x).tobytes() == ref_zeta.mobius_np(x).tobytes()
    assert np.array_equal(zeta.zeta(torch.from_numpy(x)).numpy(),
                          zeta.zeta_np(x))
    c = torch.from_numpy(x[0] + 1j * x[1])           # complex128 butterfly
    assert np.array_equal(zeta.zeta(c).numpy(),
                          zeta.zeta_np(x[0] + 1j * x[1]))
    assert torch.equal(zeta.mobius(zeta.zeta(c)), c)


# --------------------------------------------------- the façade
PAIRS = [
    ("max", "dpconv", {"engine": "fused"}),
    ("max", "dpconv", {"engine": "host"}),
    ("max", "dpsub", {}),
    ("out", "dpconv", {}),
    ("out", "approx", {"eps": 0.25}),
    ("out", "dpsub", {}),
    ("out", "dpccp", {}),
    ("out", "dpccp", {"engine": "fused"}),
    ("out", "dpccp", {"prune_gamma": 5e3}),
    ("cap", "dpconv", {}),
    ("cap", "dpconv", {"engine": "host"}),
    ("cap", "dpconv", {"engine": "fused", "gamma_batch": 3}),
    ("cap", "dpconv", {"gamma_slack": 1.5}),
    ("cap", "dpconv", {"connected": True, "gamma_slack": 2.0}),
    ("cap", "dpconv", {"connected": True, "gamma_slack": 2.0,
                       "engine": "host"}),
    ("cap", "dpconv", {"engine_pass1": "dpsub", "engine": "host"}),
    ("cap", "dpconv", {"engine_pass2": "dpccp", "engine": "host",
                       "gamma_slack": 2.0}),
    ("smj", "approx", {"eps": 0.25}),
    ("smj", "dpsub", {}),
]
PAIR_IDS = [f"{c}-{m}-" + "-".join(f"{k}={v}" for k, v in kw.items())
            for c, m, kw in PAIRS]


def _result_key(r):
    meta = {k: r.meta[k] for k in ("engine", "gamma", "passes", "ccp",
                                   "batched") if k in r.meta}
    dp = r.meta.get("dp_table", r.meta.get("dp"))
    return (float(r.cost).hex(), str(r.tree), meta,
            None if dp is None else np.asarray(dp, np.float64).tobytes())


@pytest.mark.parametrize("cost,method,kw", PAIRS, ids=PAIR_IDS)
def test_optimize_pairs_match_reference(cost, method, kw):
    n = 6
    qs = [chain(n), star(n)]
    cards = [_int_cards(n, seed=s, w=40) * 50 for s in (1, 2)]
    for q, c in zip(qs, cards):
        want = ref_dpconv.optimize(q, c, cost=cost, method=method, **kw)
        got = optimize(_port(q), c, cost=cost, method=method, device=CPU,
                       **kw)
        assert _result_key(got) == _result_key(want)
    want = ref_dpconv.optimize_batch(qs, cards, cost=cost, method=method,
                                     **kw)
    got = optimize_batch([_port(q) for q in qs], cards, cost=cost,
                         method=method, device=CPU, **kw)
    assert [_result_key(r) for r in got] == [_result_key(r) for r in want]


def test_ccap_entry_points_match_reference():
    from repro.core import ccap as ref_ccap
    n = 6
    qs, cards = _batch(n, 4, seed=11)
    pq = [_port(q) for q in qs]
    for eng in ("fused", "host"):
        want = ref_ccap.ccap_batch(qs, cards, n, engine=eng,
                                   gamma_slack=1.5, connected=True)
        got = ccap_batch(pq, cards, n, engine=eng, gamma_slack=1.5,
                         connected=True, device=CPU)
        assert [(g.gamma.hex(), g.cout.hex(), str(g.tree), g.engine)
                for g in got] == \
            [(w.gamma.hex(), w.cout.hex(), str(w.tree), w.engine)
             for w in want]
    with pytest.raises(ValueError):
        ccap(pq[0], cards[0], engine="fused", engine_pass2="dpccp",
             device=CPU)
    with pytest.raises(AssertionError):
        ccap(pq[0], cards[0], gamma_slack=1e-9, device=CPU)


# ------------------------------------------------ the four-cost lane
@pytest.mark.parametrize("engine_name", ["fused", "host"])
def test_batched_solver_four_costs_match_reference(engine_name):
    items = []
    plan = [(6, "max"), (6, "cap"), (6, "cap_conn"), (6, "out"), (5, "out"),
            (6, "cap"), (6, "out"), (6, "out"), (7, "cap_conn"),
            (7, "cap_conn"), (6, "cap"), (5, "max")]
    for i, (n, cost) in enumerate(plan):
        q = MAKERS[i % 4](n)
        items.append((q, make_cardinalities(q, seed=i), cost))
    # a hyperedge member: its out chunk falls back to host enumeration
    hyper = QueryGraph(6, chain(6).edges, ((0b000001, 0b100000),))
    items.append((hyper, make_cardinalities(hyper, seed=99), "out"))
    ref_solver = ref_batch.BatchedSolver(ref_batch.BatchPolicy(
        max_batch=4, engine=engine_name))
    want = ref_solver.solve(items)
    solver = BatchedSolver(BatchPolicy(max_batch=4, engine=engine_name),
                           device=CPU)
    got = solver.solve([(_port(q), c, cost) for q, c, cost in items])
    for g, w in zip(got, want):
        assert float(g.cost).hex() == w.cost.hex()
        assert str(g.tree) == str(w.tree)
        for k in ("engine", "chunk", "batched", "passes", "gamma"):
            assert g.meta.get(k) == w.meta.get(k), k
        if "dp_table" in w.meta:
            assert g.meta["dp_table"].tobytes() == \
                w.meta["dp_table"].tobytes()
    assert all(r.meta["backend"] == "f64" for r in got)   # auto on a CPU
    # the same chunks, in the same order, on the same engines
    assert [t[:2] + t[3:5] for t in solver.last_timings] == \
        [t[:2] + t[3:5] for t in ref_solver.last_timings]
    assert (solver.batches_run, solver.queries_batched) == \
        (ref_solver.batches_run, ref_solver.queries_batched)


# ------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("connected", [False, True], ids=["cap", "cap_conn"])
def test_fused_ccap_on_card_matches_cpu(cuda_device, connected):
    n = 12
    qs, cards = _batch(n, 4, seed=5)
    pq = [_port(q) for q in qs] if connected else None
    cpu = engine.fused_ccap(cards, n, gamma_slack=2.0, qs=pq, device=CPU)
    for tier in ("f64", "cuda"):
        ops.reset_launch_counts()
        got = engine.fused_ccap(cards, n, gamma_slack=2.0, backend=tier,
                                qs=pq, device=cuda_device)
        assert _hex(got.gammas) == _hex(cpu.gammas)
        assert _hex(got.couts) == _hex(cpu.couts)
        assert _strs(got.trees) == _strs(cpu.trees)
        assert got.rounds == cpu.rounds
        counts = ops.launch_counts()
        assert counts["zeta_cluster"] > 0      # both tiers' transforms
        assert (counts["ranked_conv"] > 0) == (tier == "cuda")
        assert counts["zeta_high"] == 0


@pytest.mark.cuda
def test_fused_out_on_card_matches_cpu(cuda_device):
    n = 12
    qs, cards = _batch(n, 4, seed=6)
    pq = [_port(q) for q in qs]
    cpu = engine.fused_out(pq, cards, n, device=CPU)
    got = engine.fused_out(pq, cards, n, device=cuda_device)
    assert _hex(got.couts) == _hex(cpu.couts)
    assert got.dp.tobytes() == cpu.dp.tobytes()
    assert _strs(got.trees) == _strs(cpu.trees)


@pytest.mark.cuda
def test_fft_paths_on_card_match_cpu(cuda_device):
    n = 7
    card = _int_cards(n, seed=4)
    cpu = dpconv_out.dpconv_out(card, n, extract_tree=True, device=CPU)
    got = dpconv_out.dpconv_out(card, n, extract_tree=True,
                                device=cuda_device)
    assert got[0] == cpu[0] and got[1].tobytes() == cpu[1].tobytes()
    assert str(got[2]) == str(cpu[2])
    card = make_cardinalities(clique(6), seed=2, cap=1e5)
    for cost in ("out", "smj"):
        v, dp = approx.approx_out(card, 6, eps=0.25, cost=cost,
                                  device=cuda_device)
        cv, cdp = approx.approx_out(card, 6, eps=0.25, cost=cost, device=CPU)
        assert v.hex() == cv.hex() and dp.tobytes() == cdp.tobytes()
