"""Connected C_out past n = 13: the connected-subset masks built from
adjacency bitmasks (``kernels.connmask``, ``csrc/connmask.cu``, and the
plain ``kernels.ref.connmask_ref``), the connected programs that build
them inside the call, the sweep's valid-split count
(``DispatchRecord.sweep_pairs``) and the fused out lane raised to 19.

On the CPU, held to the reference (``repro.core.querygraph`` and
``repro.core.dpccp``) on the same graphs and cardinalities: the plain
mask version bitwise against its ``QueryGraph.connected_mask`` on chain,
star, cycle, grid, clique and seeded sparse graphs at n = 1..14,
batched; ``fused_out`` at n = 14 bitwise against its
``dpccp_with_tree``; ``sweep_pairs`` against its ``ccp_pair_count``.
Besides: hyperedge and disconnected graphs refused; the router's out
ceiling on a card, a CPU and a mesh server, and the prewarm of the out
buckets to 19.  On the card (``cuda``-marked, skipped without one; the
reference is imported only by the CPU cases, so these import no JAX):
``connmask_kernel`` against the plain version at n up to 19 with B = 1
and 16; the graphed ``fused_out`` against the eager one at n = 17;
``fused_out`` at n = 14..19 against the benchmark's plain reference
(``planbench/references/joinorder_ccp.py``).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import engine, lattice
from repro_torch.core import querygraph as port_qg
from repro_torch.core.querygraph import (QueryGraph, chain,
                                         make_cardinalities, random_sparse,
                                         star)
from repro_torch.kernels import build
from repro_torch.kernels.ref import connmask_ref
from repro_torch.service import router as router_mod
from repro_torch.service.batch import BatchPolicy
from repro_torch.service.server import PlanServer

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
GRIDS = {1: (1, 1), 2: (1, 2), 3: (1, 3), 4: (2, 2), 5: (1, 5),
         6: (2, 3), 7: (1, 7), 8: (2, 4), 9: (3, 3), 10: (2, 5),
         11: (1, 11), 12: (3, 4), 13: (1, 13), 14: (2, 7)}
TOPOS = ("chain", "clique", "cycle", "grid", "sparse", "star")
SPARSE = ("chain", "star", "cycle", "sparse")
# #ccp in closed form (Moerkotte & Neumann, VLDB 2006)
CCP = {"chain": lambda n: (n ** 3 - n) // 6,
       "star": lambda n: (n - 1) * 2 ** (n - 2),
       "cycle": lambda n: (n ** 3 - 2 * n * n + n) // 2,
       "clique": lambda n: (3 ** n - 2 ** (n + 1) + 1) // 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _reference():
    """The reference's query graphs and DPccp (imported here, so the
    card's cases never import JAX)."""
    from repro.core import dpccp as ref_dpccp
    from repro.core import querygraph as ref_qg
    return ref_qg, ref_dpccp


def _graph(qg, topo: str, n: int):
    """``topo``'s graph on ``n`` relations, made by the query-graph
    module ``qg`` (the reference's or the port's)."""
    if topo == "grid":
        return qg.grid(*GRIDS[n])
    if topo == "sparse":
        return qg.random_sparse(n, extra_edges=n // 2, seed=7 * n)
    return getattr(qg, topo)(n)


def _port(rq):
    """The port's query graph for a reference one."""
    return convert.from_reference(rq.n, rq.edges, rq.hyperedges,
                                  np.ones(1 << rq.n), device=CPU)[0]


def _adj(qs, device=CPU) -> torch.Tensor:
    return torch.as_tensor(np.stack([q.adjacency() for q in qs]),
                           dtype=torch.int32, device=device)


def _cases(qg, names, n, seed):
    """Graphs of ``names`` at ``n`` and their stacked cardinalities in
    the paper's regime, made by ``qg``."""
    qs = [_graph(qg, name, n) for name in names
          if name != "cycle" or n >= 3]
    cards = np.stack([qg.make_cardinalities(q, seed=seed + i,
                                            base_range=(1e2, 1e6),
                                            selectivity_range=(1e-4, 1.0),
                                            cap=1e8)
                      for i, q in enumerate(qs)])
    return qs, cards


# ---------------------------------------------------------- the masks
@pytest.mark.parametrize("n", range(1, 15))
@pytest.mark.parametrize("topo", TOPOS)
def test_plain_masks_match_connected_mask(topo, n):
    if topo == "cycle" and n < 3:
        pytest.skip("a cycle needs three relations")
    ref_qg, _ = _reference()
    rq = _graph(ref_qg, topo, n)
    got = connmask_ref(_adj([_port(rq)]), n)
    assert got.dtype == torch.bool and got.shape == (1, 1 << n)
    assert got[0].numpy().tobytes() == rq.connected_mask().tobytes()


def test_plain_masks_batch_rows_of_other_graphs():
    n = 11
    ref_qg, _ = _reference()
    rqs = [_graph(ref_qg, name, n) for name in TOPOS]
    got = connmask_ref(_adj([_port(rq) for rq in rqs]), n).numpy()
    for row, rq in zip(got, rqs):
        assert row.tobytes() == rq.connected_mask().tobytes()


def test_connectivity_refuses_hyperedges_and_disconnected_graphs():
    n = 6
    hyper = QueryGraph(n, chain(n).edges, ((0b11, 0b100000),))
    split = QueryGraph(n, ((0, 1), (2, 3), (4, 5)))
    cards = make_cardinalities(chain(n), seed=1)[None, :]
    with pytest.raises(ValueError, match="simple-edge"):
        engine.fused_out([hyper], cards, n, device=CPU)
    with pytest.raises(ValueError, match="connected"):
        engine.fused_out([split], cards, n, device=CPU)
    with pytest.raises(ValueError, match="connected"):
        engine.fused_ccap(cards, n, qs=[split], device=CPU)
    with pytest.raises(ValueError):
        engine.fused_out([chain(n - 1)], cards, n, device=CPU)
    adj = engine._connectivity([chain(n), star(n)], 2, n, "test")
    assert adj.dtype == np.int32 and adj.shape == (2, n)
    assert adj.tolist() == [list(chain(n).adjacency()),
                            list(star(n).adjacency())]


# ------------------------------------------------- fused out at n = 14
@pytest.mark.parametrize("topo", SPARSE)
def test_fused_out_at_14_matches_dpccp(topo):
    n = 14
    ref_qg, ref_dpccp = _reference()
    rqs, cards = _cases(ref_qg, (topo,), n, seed=140)
    got = engine.fused_out([_port(rqs[0])], cards, n, device=CPU)
    dp, tree = ref_dpccp.dpccp_with_tree(rqs[0], cards[0], mode="out")
    assert got.couts[0].hex() == float(dp[-1]).hex()
    assert got.dp[0].tobytes() == np.asarray(dp).tobytes()
    assert str(got.trees[0]) == str(tree)


# -------------------------------------------------------- sweep_pairs
@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("topo", SPARSE + ("clique", "grid"))
def test_sweep_pairs_is_the_ccp_count(topo, n):
    """An out call's ``sweep_pairs`` is the #ccp of its rows (padded rows
    count as the row they repeat); C_max and the value cap report 0."""
    ref_qg, ref_dpccp = _reference()
    rqs = [_graph(ref_qg, topo, n), ref_qg.chain(n), ref_qg.star(n)]
    cards = np.stack([ref_qg.make_cardinalities(x, seed=n + i)
                      for i, x in enumerate(rqs)])            # padded to 4
    mark = engine.dispatch_mark()
    engine.fused_out([_port(x) for x in rqs], cards, n, device=CPU)
    engine.fused_ccap(cards, n, device=CPU)
    engine.fused_dpconv_max(cards, n, device=CPU)
    out, cap, mx = engine.dispatches_since(mark)
    ccp = [ref_dpccp.ccp_pair_count(ref_dpccp.connectivity_masks(x), n)
           for x in rqs]
    assert out.B == 4 and out.sweep_pairs == sum(ccp) + ccp[0]
    assert (cap.sweep_pairs, mx.sweep_pairs) == (0, 0)


@pytest.mark.parametrize("topo", sorted(CCP))
def test_ccp_closed_forms(topo):
    """The closed forms the card's tests hold ``sweep_pairs`` to, where
    the enumerating count would take minutes, against the reference's
    count at n = 3..9."""
    ref_qg, ref_dpccp = _reference()
    for n in range(3, 10):
        assert CCP[topo](n) == ref_dpccp.ccp_pair_count(
            ref_dpccp.connectivity_masks(_graph(ref_qg, topo, n)), n)


def test_sweep_pairs_of_a_connected_cap_count_its_gated_sets():
    """Under ``gate & conn`` the count is the splits of the gated
    connected sets whose halves are both gated and connected: at a slack
    that gates nothing off, the reference's #ccp."""
    n = 7
    ref_qg, ref_dpccp = _reference()
    rqs = [ref_qg.cycle(n), ref_qg.random_sparse(n, extra_edges=2, seed=3)]
    cards = np.stack([ref_qg.make_cardinalities(x, seed=i) for i, x in
                      enumerate(rqs)])
    qs = [_port(x) for x in rqs]
    mark = engine.dispatch_mark()
    engine.fused_ccap(cards, n, qs=qs, gamma_slack=1e200, device=CPU)
    engine.fused_ccap(cards, n, qs=qs, device=CPU)
    wide, tight = engine.dispatches_since(mark)
    ccp = sum(ref_dpccp.ccp_pair_count(ref_dpccp.connectivity_masks(x), n)
              for x in rqs)
    assert wide.sweep_pairs == ccp
    assert 0 <= tight.sweep_pairs <= ccp


def test_gather_sweep_counts_the_kernel_model():
    """The gather sweep's count from the reference's masks is the valid
    splits holding each evaluated set's lowest relation, seeded sets
    skipped: a direct count over the lattice."""
    n = 7
    ref_qg, _ = _reference()
    rqs = [ref_qg.random_sparse(n, extra_edges=3, seed=s) for s in range(3)]
    card = torch.as_tensor(np.stack([ref_qg.make_cardinalities(q, seed=1)
                                     for q in rqs]))
    conn = torch.as_tensor(np.stack([q.connected_mask() for q in rqs]))
    rng = np.random.default_rng(5)
    seed_ok = torch.as_tensor(rng.random(conn.shape) < 0.3) & conn
    cold = lattice.minplus_connected_layers(card, conn, n)
    pairs = torch.zeros((), dtype=torch.int64)
    lattice.minplus_connected_layers(card, conn, n, seed_vals=cold,
                                     seed_ok=seed_ok, pairs=pairs)
    c, so = conn.numpy(), seed_ok.numpy()
    want = 0
    for r in range(len(rqs)):
        for S in range(1 << n):
            if bin(S).count("1") < 2 or not c[r, S] or so[r, S]:
                continue
            low = S & -S
            T = (S - 1) & S
            while T:
                if T & low and T != S and c[r, T] and c[r, S ^ T]:
                    want += 1
                T = (T - 1) & S
    assert int(pairs) == want


# --------------------------------------------------- routing, ceiling
@pytest.mark.parametrize("n", range(12, 21))
@pytest.mark.parametrize("topo", SPARSE)
def test_out_routes_to_the_fused_lane_up_to_19(topo, n):
    """The router's own ceiling, the one a server on one card keeps,
    under the engine hint a server sets (its batch policy's engine)."""
    r = router_mod.Router()
    r.engine_hint["dpccp"] = BatchPolicy().engine
    route = r.route(_graph(port_qg, topo, n) if topo != "sparse"
                    else random_sparse(n, extra_edges=2, seed=n), "out")
    fused = n <= 19
    assert r.config.fused_out_max_n == 19
    assert route.method == "dpccp"
    assert route.lane == ("batch" if fused else "single")
    assert r.engine_tag("dpccp", n, route.lane, "out") == \
        ("fused:out" if fused else "host:out")


def test_cpu_and_mesh_servers_keep_the_gather_sweep_out_ceiling():
    """Off one card the sweep gathers split tables: a CPU server keeps
    the out ceiling at 13 and answers n = 14 with the host enumerator; a
    ``solve_shards = D`` server lifts 13 by ``sharded_ceiling``."""
    from repro_torch.launch import mesh
    srv = PlanServer(device=CPU)
    assert srv.router.config.fused_out_max_n == \
        router_mod.GATHER_SWEEP_MAX_N == 13
    route = srv.router.route(chain(14), "out")
    assert (route.method, route.lane) == ("dpccp", "single")
    assert srv.router.engine_tag("dpccp", 14, route.lane, "out") == \
        "host:out"
    try:
        mesh.force_device_count(4)
        for D in (2, 4):
            cfg = PlanServer(batch_policy=BatchPolicy(solve_shards=D),
                             device=CPU).router.config
            assert cfg.fused_out_max_n == engine.sharded_ceiling(13, D) \
                == {2: 14, 4: 15}[D]
    finally:
        mesh.force_device_count(None)


def test_prewarm_builds_out_buckets_up_to_19(monkeypatch):
    calls = []

    def fake(ns, **kw):
        calls.append((tuple(ns), kw["max_batch"], kw["costs"],
                      kw["backend"]))
        return {"compiled": 1, "seconds": 0.0}

    monkeypatch.setattr(engine, "prewarm", fake)
    srv = PlanServer(device=CPU, max_batch=1,
                     batch_policy=BatchPolicy(max_batch=1))
    # the ceiling a server on one card keeps (a CPU server's is 13)
    srv.router.config.fused_out_max_n = \
        router_mod.RouterConfig().fused_out_max_n
    srv.prewarm(range(12, 22), costs=("out",))
    assert [c[0] for c in calls] == [(n,) for n in range(12, 20)]
    assert all(c[1:] == (1, ("out",), "f64") for c in calls)


def test_cpu_out_calls_launch_no_kernel():
    build.reset_launch_counts()
    qs, cards = _cases(port_qg, ("star",), 6, seed=1)
    engine.fused_out(qs, cards, 6, device=CPU)
    engine.fused_ccap(cards, 6, qs=qs, device=CPU)
    assert build.launch_counts()["connmask"] == 0


# ----------------------------------------------------------- the card
def _joinorder_ccp():
    path = ROOT / "planbench" / "references" / "joinorder_ccp.py"
    spec = importlib.util.spec_from_file_location("joinorder_ccp_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 16, 19])
def test_kernel_matches_plain_masks_on_card(cuda_device, n, B):
    from repro_torch.kernels.connmask import connmask_cuda
    names = [m for m in ("chain", "star", "cycle", "clique")
             if m != "cycle" or n >= 3]
    qs = [(random_sparse(n, extra_edges=b % n, seed=b) if b % 5 == 4
           else _graph(port_qg, names[b % len(names)], n))
          for b in range(B)]
    adj = _adj(qs, cuda_device)
    before = build.launch_counts()["connmask"]
    got = connmask_cuda(adj, n)
    torch.cuda.synchronize()
    assert build.launch_counts()["connmask"] - before == 1
    assert torch.equal(got, connmask_ref(adj, n))
    assert got.cpu().numpy().tobytes() == np.stack(
        [q.connected_mask() for q in qs]).tobytes()


@pytest.mark.cuda
def test_graphed_fused_out_matches_eager_at_17(cuda_device, monkeypatch):
    n = 17
    qs, cards = _cases(port_qg, ("star",), n, seed=17)
    engine.clear_executable_cache()
    graphed = [engine.fused_out(qs, cards, n, device=cuda_device)
               for _ in range(3)]            # eager, captured, replayed
    mark = engine.dispatch_mark()
    engine.fused_out(qs, cards, n, device=cuda_device)
    (rec,) = engine.dispatches_since(mark)
    assert rec.graphed
    engine.clear_executable_cache()
    monkeypatch.setattr(lattice, "uses_graphs", lambda device, mesh: False)
    eager = engine.fused_out(qs, cards, n, device=cuda_device)
    mark = engine.dispatch_mark()
    engine.fused_out(qs, cards, n, device=cuda_device)
    (erec,) = engine.dispatches_since(mark)
    engine.clear_executable_cache()
    for g in graphed:
        assert g.couts.tobytes() == eager.couts.tobytes()
        assert g.dp.tobytes() == eager.dp.tobytes()
        assert str(g.trees) == str(eager.trees)
    assert rec.sweep_pairs == erec.sweep_pairs == CCP["star"](n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(14, 20))
def test_fused_out_on_card_matches_plain_reference(cuda_device, n):
    """Seeded chain, star, cycle and sparse queries at n = 14..19: the
    card's optima and DP tables against the benchmark's plain reference,
    bitwise, so its trees are those ``dpccp_with_tree`` extracts from
    that table (the host enumerator's DP takes seconds a query here);
    ``sweep_pairs`` the closed forms' #ccp."""
    from repro_torch.core import jointree
    ref = _joinorder_ccp()
    qs, cards = _cases(port_qg, SPARSE, n, seed=1000 + n)
    mark = engine.dispatch_mark()
    got = engine.fused_out(qs, cards, n, device=cuda_device)
    (rec,) = engine.dispatches_since(mark)
    sols = ref.solve([(n, list(q.edges), cards[b])
                      for b, q in enumerate(qs)], "out",
                     {"out_connected_max_density": 0.5},
                     device=cuda_device)
    for b, sol in enumerate(sols):
        assert got.couts[b].hex() == float(sol["opt"]).hex()
        assert got.dp[b].tobytes() == np.asarray(sol["dp"]).tobytes()
        tree = jointree.extract_tree_out(sol["dp"], cards[b], n)
        assert str(got.trees[b]) == str(tree)
        assert ref.tree_cost(ref.extract_tree(sol, n), sol, n) == sol["opt"]
    mark = engine.dispatch_mark()
    engine.fused_out(qs[:3], cards[:3], n, device=cuda_device)
    (rec3,) = engine.dispatches_since(mark)             # B = 4: one pad
    assert rec3.sweep_pairs == sum(CCP[t](n) for t in SPARSE[:3]) + \
        CCP["chain"](n)
    assert rec.sweep_pairs > rec3.sweep_pairs - CCP["chain"](n)
