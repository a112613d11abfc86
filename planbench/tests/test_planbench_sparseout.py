"""The large sparse C_out cell (``plansvc.sparse-out-large``): its mix
routes every request to the fused connected-C_out lane over many seeds
and deals every seed the same work, each (topology, n) once a block; its
loop ends a run with exit code 4 where the program would answer the mix
off the card; a small run on the CPU is correct; its reference
(``joinorder_ccp``) agrees with ``joinorder`` and with the program; and
the two roofline readers on made-up runs, and their None where the
program has no such kernel or no ``sweep_pairs``."""
import collections
import time
import types

import numpy as np
import pytest

from _planbench_util import run_small

from pbench import graphs, judge, work
from pbench.registry import Bench

CELL = "plansvc.sparse-out-large"
MIX = "sparse-out-large"
SMALL = {"classes": [{"cost": "out", "weight": 1.0, "n": [8, 9]}],
         "block": 8}
TOPOLOGIES = ("chain", "star", "cycle", "sparse")
SEM = {"out_connected_max_density": 0.5}


def _stream(seed, count=None, **over):
    bench = Bench()
    mix = dict(bench.mix(MIX), **over)
    gen = bench.generator(mix["generator"])
    t = gen.make(mix, seed, 2.0)
    count = count or int(mix.get("block", len(gen._deck(mix))))
    return [next(t.more) for _ in range(count)]


def test_no_request_routes_off_the_fused_out_lane():
    """40 seeds through the plan service's own router (the ceilings a
    server on one card keeps): every request goes to DPccp on the batch
    lane, which the fused connected-C_out program answers."""
    from repro_torch.core.querygraph import QueryGraph
    from repro_torch.service.canon import topology_signature
    from repro_torch.service.router import Router
    router = Router()
    router.engine_hint["dpccp"] = "fused"
    for seed in range(40):
        for r in _stream(7919 * seed + 2 ** 31 + 5):
            q = QueryGraph(r.n, r.edges)
            route = router.route(q, r.cost, None,
                                 signature=topology_signature(q))
            assert (route.method, route.lane) == ("dpccp", "batch"), \
                (seed, r.n, route)
            assert router.engine_tag(route.method, r.n, route.lane,
                                     r.cost) == "fused:out"


def test_every_block_deals_each_topology_and_n_once():
    """A block holds the 24 (topology, n) entries of the mix once each,
    in an order of the seed's; every seed the same work."""
    want = collections.Counter((t, n) for t in TOPOLOGIES
                               for n in range(14, 20))
    seen = set()
    for seed in (1, 2, 2 ** 33 + 1):
        s = _stream(seed)
        assert len(s) == 24
        got = collections.Counter((_topology(r), r.n) for r in s)
        assert got == want
        seen.add(tuple((_topology(r), r.n) for r in s))
    assert len(seen) == 3                 # the order is the seed's


def _topology(r) -> str:
    for t in ("chain", "star", "cycle"):
        if tuple(r.edges) == graphs.make_edges(t, r.n, None):
            return t
    assert len(r.edges) >= r.n - 1
    return "sparse"


def test_parent_program_ends_before_set_up():
    """A program whose router sends sparse C_out at n = 19 to the host
    enumerator (here a CPU server, which keeps the out ceiling at 13)
    does not run this configuration: exit code 4 before the prewarm."""
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exc:
        run_small(CELL, overrides={})
    assert exc.value.code == 4
    assert time.perf_counter() - t0 < 30.0


@pytest.mark.parametrize("ceiling,off", [(19, 0), (18, 4), (13, 4)])
def test_closed_routed_names_the_probes_the_host_would_answer(ceiling,
                                                              off):
    import torch
    from pbench import program
    bench = Bench()
    srv = program.make_server(bench.config("bigjoin-sparse-out"),
                              torch.device("cpu"))
    srv.router.config.fused_out_max_n = ceiling
    mix = bench.mix(MIX)
    assert mix["loop"] == "closed_routed"
    got = bench.driver("closed_routed").host_classes(srv, mix)
    assert got == [("out", t, 19) for t in TOPOLOGIES][:off]


def test_small_run_is_correct():
    rc, res, err = run_small(CELL, overrides=SMALL)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"plans_per_s.large", "setup_s"}


def test_traced_small_run_leaves_out_the_kernel_rooflines():
    """On the CPU the masks and the sweep take their plain versions: the
    two new rooflines and the (min,+) kernel's share of device time read
    None and are left out; every other per-layer metric that lists the
    cell reads."""
    rc, res, err = run_small(CELL, overrides=SMALL, trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    m = res["metrics"]
    kernel = {"minplus_roofline.ccp", "connmask_roofline.ccp",
              "minplus_share_pct.cap"}
    listed = {x["name"] for x in Bench().spec["per_layer"]
              if CELL in x.get("workloads", ())}
    assert kernel <= listed
    assert set(m) == listed - kernel


# ------------------------------------------------------ the reference
def _ref(name):
    return Bench().reference(name)


@pytest.mark.parametrize("n", [8, 10, 12])
def test_ccp_reference_agrees_with_joinorder_and_the_program(n):
    """Bit for bit, on seeded chain/star/cycle/sparse queries and one
    dense one: the same optimum and DP table as ``joinorder``, the same
    allowed sets, and the optimum and plan the fused C_out program
    serves."""
    from repro_torch.core import engine
    from repro_torch.core.querygraph import QueryGraph
    rng = np.random.default_rng(n)
    queries = []
    for topo in TOPOLOGIES + ("clique",):
        edges = graphs.make_edges(topo, n, rng)
        queries.append((n, edges, graphs.cardinalities(n, edges, rng)))
    ccp, plain = _ref("joinorder_ccp"), _ref("joinorder")
    got = ccp.solve(queries, "out", SEM)
    want = plain.solve(queries, "out", SEM)
    for g, w in zip(got, want):
        assert g["dp"].tobytes() == w["dp"].tobytes()
        assert g["allowed"].tobytes() == w["allowed"].tobytes()
        assert g["opt"] == w["opt"]
    qs = [QueryGraph(n, tuple(e)) for _, e, _ in queries[:4]]
    fo = engine.fused_out(qs, np.stack([c for _, _, c in queries[:4]]), n,
                          device="cpu")
    for b, sol in enumerate(got[:4]):
        assert fo.couts[b] == sol["opt"]
        assert fo.dp[b].tobytes() == sol["dp"].tobytes()
        assert ccp.tree_cost(_tree(fo.trees[b]), sol, n) == sol["opt"]
        cg, tg = ccp.judge(fo.couts[b], _tree(fo.trees[b]), sol, n)
        assert (cg, tg) == (0.0, 0.0)


def _tree(t):
    if t.left is None:
        return (int(t.mask),)
    return (int(t.mask), _tree(t.left), _tree(t.right))


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_ccp_connected_sets_match_joinorder(topo):
    """The torch fixpoint gives the numpy one's sets, row by row."""
    rng = np.random.default_rng(3)
    ccp, plain = _ref("joinorder_ccp"), _ref("joinorder")
    for n in (3, 7, 11):
        edges = [graphs.make_edges(topo, n, rng) for _ in range(3)]
        got = ccp.connected_sets(n, edges).numpy()
        for row, e in zip(got, edges):
            assert row.tobytes() == plain.connected_sets(n, e).tobytes()


def test_control_through_the_ccp_reference_is_not_correct():
    """The float32 control, through ``joinorder_ccp``, reads a nonzero
    cost gap at the configuration's limits of 0."""
    import torch
    from pbench import control
    res = control.control(Bench(), CELL, 2 ** 31 + 7, 8, torch.device("cpu"),
                          mix_overrides={"classes": [
                              {"cost": "out", "weight": 1.0,
                               "n": [10, 11]}]})
    assert res["correct"] is False
    assert res["checks"]["cost_gap"]["value"] > 0.0


# ------------------------------------------------------- made-up runs
def _reader(name):
    return Bench().reader(name)


def _rec(cost, n, B, pairs=None):
    r = types.SimpleNamespace(cost=cost, n=n, B=B)
    if pairs is not None:
        r.sweep_pairs = pairs
    return r


def _run(recs, ops=()):
    kernel_s = sum(b - a for a, b, _, k in ops if k)
    dt = types.SimpleNamespace(ops=list(ops), kernel_s=kernel_s)
    return types.SimpleNamespace(devtrace=dt,
                                 dispatches=types.SimpleNamespace(
                                     records=list(recs)))


MINPLUS = "(anonymous namespace)::minplus_layer_kernel<true, false>(double*"
CONNMASK = "(anonymous namespace)::connmask_kernel(unsigned char*"


def test_ccp_work_counts_pairs_and_the_tables():
    mod = _reader("minplus_roofline.ccp")
    assert mod.ccp_work(6, 2, 100, False) == (200.0, 2 * 64 * 25)
    assert mod.ccp_work(6, 1, 7, True) == (14.0, 64 * 34)
    # a star's pairs at n = 19 are too few to bound the sweep by
    # operations: its bytes bound it
    pairs = 18 * 2 ** 17
    ops, nbytes = mod.ccp_work(19, 1, pairs, False)
    assert mod.least_s(19, 1, pairs, False) == \
        nbytes / work.HBM_BYTES_PER_S > ops / work.F64_OPS_PER_S
    assert _reader("connmask_roofline.ccp").mask_bytes(19, 1) == \
        2 ** 19 + 4 * 19


def test_ccp_rooflines_on_a_made_up_run():
    mm, cm = _reader("minplus_roofline.ccp"), _reader("connmask_roofline.ccp")
    recs = [_rec("out", 16, 1, 5000), _rec("max", 16, 1),
            _rec("out_seeded", 12, 4, 900), _rec("cap_conn", 12, 2, 10)]
    ops = [(0.0, 0.002, MINPLUS, True), (0.002, 0.0025, CONNMASK, True),
           (0.0025, 0.010, "zeta", True),
           (0.010, 0.011, "Memcpy HtoD", False)]
    run = _run(recs, ops)
    least = mm.least_s(16, 1, 5000, False) + mm.least_s(12, 4, 900, True)
    assert mm.read(run) == pytest.approx(100.0 * least / 0.002)
    masks = (cm.mask_bytes(16, 1) + cm.mask_bytes(12, 4)
             + cm.mask_bytes(12, 2)) / work.HBM_BYTES_PER_S
    assert cm.read(run) == pytest.approx(100.0 * masks / 0.0005)


def test_ccp_rooflines_read_none_on_a_program_without_them():
    """The parent's case: no mask kernel in the trace, records without
    ``sweep_pairs``, no out record or no records: both read None."""
    gather = [(0.0, 0.002, "at::native::gather", True)]
    both = [(0.0, 0.002, MINPLUS, True), (0.002, 0.003, CONNMASK, True)]
    cases = {"minplus_roofline.ccp": (
        _run([_rec("out", 16, 1)], both), _run([], both),
        _run([_rec("cap", 16, 1, 0)], both),
        _run([_rec("out", 16, 1, 10)], gather)),
        "connmask_roofline.ccp": (
        _run([_rec("out", 16, 1)], gather), _run([], both),
        _run([_rec("max", 16, 1)], both))}
    for name, runs in cases.items():
        for run in runs + (types.SimpleNamespace(devtrace=None,
                                                 dispatches=None),):
            assert _reader(name).read(run) is None, name


def test_judge_solves_the_cell_with_the_ccp_reference():
    bench = Bench()
    assert bench.config("bigjoin-sparse-out")["reference"] == \
        "joinorder_ccp"
    reqs = _stream(11, count=2, classes=SMALL["classes"])
    refs = {r.ref: (r.n, r.edges, r.card) for r in reqs}
    sols = judge.solve_refs(_ref("joinorder_ccp"), refs,
                            [(r.ref, r.cost) for r in reqs], SEM, "cpu")
    assert len(sols) == 2
    assert all(np.isfinite(s["opt"]) for s in sols.values())
