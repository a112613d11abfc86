"""The port's plan server path against ``repro``'s, request by request.

Canonical keys (SHA-256 of the canonical bytes), subset and topology
signatures, routes and the synthetic request stream must equal the
reference's exactly.  A ``plan_one`` stream through the port's
``PlanServer`` on ``device="cpu"`` must give the reference server's
``float.hex`` costs, ``repr`` trees, routes, cache hits, statuses and
plan- and layer-cache counters.  Budgeted requests are held to the same
degradation rule (GOO with its certificate), not the same timings.
"""
import asyncio
import functools

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core.querygraph import (chain, clique, cycle, grid,
                                   make_cardinalities, permute_card,
                                   random_sparse, relabel, star)
from repro import service as ref_service
from repro.core import engine as ref_engine
from repro.core import querygraph as ref_querygraph
from repro.service import PlanServer as RefServer
from repro.service import Router as RefRouter
from repro.service import WorkloadSpec as RefSpec
from repro.service import make_workload as ref_make_workload
from repro.service.canon import canonicalize as ref_canonicalize
from repro.service.canon import subset_signature as ref_subset_signature
from repro.service.canon import topology_signature as ref_topology
from repro_torch import service as port_service
from repro_torch.core import engine, querygraph
from repro_torch.kernels import ops
from repro_torch.service import (LatencyHistogram, PlanServer, Router,
                                 WorkloadSpec, make_workload, workload)
from repro_torch.service.batch import BatchPolicy
from repro_torch.service.canon import (canonicalize, subset_signature,
                                       topology_signature)
from repro_torch.service.server import PlanRequest

CPU = "cpu"
PROVIDERS = {"cache", "layercache", "router", "serve", "solver", "engine"}


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


def _route(r):
    return (r.cost, r.method, r.lane, r.params, r.reason)


def _resp_key(r):
    return (float(r.cost).hex(), repr(r.tree), _route(r.route), r.cache_hit,
            r.status)


# ------------------------------------------------------- canonical forms
GRAPHS = {
    "chain7": lambda: chain(7),
    "star6": lambda: star(6),
    "cycle6": lambda: cycle(6),
    "clique5": lambda: clique(5),
    "grid2x3": lambda: grid(2, 3),
    "sparse7": lambda: random_sparse(7, extra_edges=3, seed=4),
}


@pytest.mark.parametrize("perm_seed", [0, 9])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_canonical_keys_match_reference(graph, perm_seed):
    """Keys, permutations, signatures and subset signatures equal the
    reference's byte for byte; a relabeling keeps the key."""
    q = GRAPHS[graph]()
    card = make_cardinalities(q, seed=40 + perm_seed)
    perm = np.random.default_rng(perm_seed).permutation(q.n)
    q2, card2 = relabel(q, perm), permute_card(card, q.n, perm)
    forms = []
    for qq, cc in ((q, card), (q2, card2)):
        want = ref_canonicalize(qq, cc)
        got = canonicalize(_pq(qq), cc)
        assert (got.key, got.perm, got.signature) == \
            (want.key, want.perm, want.signature)
        assert got.card.tobytes() == want.card.tobytes()
        assert got.q.edges == want.q.edges
        assert topology_signature(_pq(qq)) == ref_topology(qq)
        for mask in (qq.full_mask, qq.full_mask ^ 1, 0b1011):
            s, r = subset_signature(_pq(qq), cc, mask), \
                ref_subset_signature(qq, cc, mask)
            assert (s.key, s.rels, s.perm) == (r.key, r.rels, r.perm)
        forms.append(got)
    assert forms[0].key == forms[1].key


# ----------------------------------------------------------------- router
ROUTE_CASES = [(cost, maker, n, connected)
               for cost in ("max", "out", "cap", "smj")
               for maker in ("chain", "clique", "cycle")
               for n in (4, 7, 14)
               for connected in ((False, True) if cost == "cap"
                                 else (False,))]


@pytest.mark.parametrize("cost", ["max", "out", "cap", "smj"])
def test_router_matches_reference(cost):
    """Method, lane, params and reason equal the reference's for every
    topology, size and connectivity flag, without a budget."""
    router, ref = Router(), RefRouter()
    for c, maker, n, connected in ROUTE_CASES:
        if c != cost:
            continue
        q = {"chain": chain, "clique": clique, "cycle": cycle}[maker](n)
        sig = ref_topology(q)
        got = router.route(_pq(q), cost, None, signature=sig,
                           connected=connected)
        want = ref.route(q, cost, None, signature=sig, connected=connected)
        assert _route(got) == _route(want)
        assert got.lane_cost == want.lane_cost
    assert router.config.small_n == 5
    assert router.config.fused_cap_max_n == router.config.fused_out_max_n \
        == 13


# --------------------------------------------------------------- workload
SPECS = {
    "default": dict(n_requests=40, seed=5),
    "small": dict(n_requests=30, seed=2, n_range=(5, 8), pool_size=4,
                  budget_frac=0.3, slo_mix=(("gold", 1.0), ("bronze", 2.0))),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_make_workload_matches_reference(spec):
    got = make_workload(WorkloadSpec(**SPECS[spec]))
    want = ref_make_workload(RefSpec(**SPECS[spec]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.q.n, g.q.edges, g.q.hyperedges) == \
            (w.q.n, w.q.edges, w.q.hyperedges)
        assert g.card.tobytes() == w.card.tobytes()
        assert (g.cost, g.latency_budget, g.arrival, g.req_id, g.slo) == \
            (w.cost, w.latency_budget, w.arrival, w.req_id, w.slo)


# ------------------------------------------------------------ plan_one
STREAM = dict(n_requests=24, n_range=(5, 8), pool_size=6,
              cost_mix=(("max", 0.3), ("out", 0.35), ("cap", 0.25),
                        ("smj", 0.1)))


@functools.lru_cache(maxsize=None)
def _reference_stream(seed: int, cache: bool):
    """The reference server's answers to one stream (built once)."""
    reqs = ref_make_workload(RefSpec(seed=seed, **STREAM))
    srv = RefServer(enable_cache=cache)
    resps = [srv.plan_one(r.q, r.card, cost=r.cost) for r in reqs]
    return ([_resp_key(r) for r in resps], srv.layers.stats.as_dict(),
            srv.cache.stats.as_dict(), dict(srv.router.decisions))


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
@pytest.mark.parametrize("seed", [0, 2])
def test_plan_one_stream_matches_reference(seed, cache):
    want, want_layers, want_cache, want_decisions = \
        _reference_stream(seed, cache)
    srv = PlanServer(enable_cache=cache, device=CPU)
    reqs = make_workload(WorkloadSpec(seed=seed, **STREAM))
    got = []
    for r in reqs:
        resp = srv.plan_one(r.q, r.card, cost=r.cost)
        assert "dp_table" not in resp.meta
        if resp.tree is not None:
            assert resp.tree.mask == r.q.full_mask
        got.append(_resp_key(resp))
    assert got == want
    assert srv.layers.stats.as_dict() == want_layers
    assert srv.cache.stats.as_dict() == want_cache
    assert dict(srv.router.decisions) == want_decisions
    assert srv.stats.served == len(reqs)
    routes = {(k[2][1], k[2][2]) for k in got}
    assert {("dpconv", "batch"), ("dpccp", "batch")} <= routes
    if not cache:
        assert srv.layers.stats.search_hits > 0
        assert srv.layers.stats.value_hits > 0


def test_budgeted_request_degrades_to_goo_with_certificate():
    """A budget no exact method meets degrades to GOO, as in the
    reference: status "degraded" and a certificate recomputed from the
    returned tree."""
    q = clique(7)
    card = make_cardinalities(q, seed=3)
    srv, ref = PlanServer(device=CPU), RefServer()
    for cost in ("max", "out", "cap", "smj"):
        got = srv.plan_one(_pq(q), card, cost=cost, latency_budget=1e-12,
                           explain=True)
        want = ref.plan_one(q, card, cost=cost, latency_budget=1e-12)
        assert (got.route.method, got.route.reason) == \
            (want.route.method, want.route.reason) == \
            ("goo", "deadline: degraded to greedy best-effort")
        assert got.status == want.status == "degraded"
        cert = got.meta["certificate"]
        fn = {"max": got.tree.cost_max, "out": got.tree.cost_out,
              "smj": got.tree.cost_smj, "cap": got.tree.cost_out}[cost]
        assert cert["upper_bound"] == got.cost == float(fn(card))
        assert float(got.cost).hex() == float(want.cost).hex()
        assert got.explain["method"] == "goo"
    assert srv.stats.deadline_fallbacks == ref.stats.deadline_fallbacks == 4


def test_degraded_insert_never_clobbers_exact():
    """A degraded plan under the primary key is withheld from an exact
    request, which solves and replaces it; a later degraded completion
    leaves the exact entry in place."""
    q = chain(7)
    card = make_cardinalities(q, seed=8)
    srv = PlanServer(device=CPU)
    deg = srv.plan_one(_pq(q), card, cost="max", latency_budget=1e-12)
    assert deg.status == "degraded" and not deg.cache_hit
    exact = srv.plan_one(_pq(q), card, cost="max")
    assert exact.status == "exact" and not exact.cache_hit
    assert srv.cache.stats.degraded_skips == 1
    again = srv.plan_one(_pq(q), card, cost="max", latency_budget=1e-12)
    assert again.cache_hit and again.status == "exact"
    assert float(again.cost).hex() == float(exact.cost).hex()
    form = canonicalize(_pq(q), card)
    goo = srv.router.failure_fallback("max", "test")
    req = PlanRequest(q=_pq(q), card=card)
    cost_v, tree, meta = srv._solve_single(form.q, form.card, "max", goo)
    srv._complete(req, form, goo, cost_v, tree, meta)
    primary = srv.router.route(form.q, "max", None,
                               signature=form.signature)
    key = srv.cache.make_key(form.key, "max", primary.method,
                             primary.params)
    assert srv.cache.peek(key).status == "exact"


def test_registry_snapshot_shows_providers():
    srv = PlanServer(device=CPU)
    q = cycle(6)
    card = make_cardinalities(q, seed=4)
    srv.plan_one(_pq(q), card, cost="out")
    srv.plan_one(_pq(q), card, cost="out")
    snap = srv.registry.snapshot()
    assert set(snap["providers"]) == PROVIDERS
    prov = snap["providers"]
    assert prov["cache"] == srv.cache.stats.as_dict()
    assert prov["cache"]["hits"] == 1
    assert prov["layercache"] == srv.layers.stats.as_dict()
    assert prov["router"]["decisions"] == {"dpccp": 2}
    assert prov["router"]["engine_hint"] == {"dpconv": "fused",
                                             "dpccp": "fused"}
    assert prov["solver"]["total_solved"] == 1
    assert prov["engine"]["dispatches"] >= 1


def test_dp_table_never_reaches_a_response_or_the_cache():
    srv = PlanServer(device=CPU)
    resps = []
    for maker in (chain, star, cycle):
        q = maker(7)
        card = make_cardinalities(q, seed=12)
        resps.append(srv.plan_one(_pq(q), card, cost="out"))
        resps.append(srv.plan_one(_pq(q), card, cost="out"))
    assert [r.cache_hit for r in resps] == [False, True] * 3
    assert all(r.route.method == "dpccp" and r.route.lane == "batch"
               for r in resps)
    assert all("dp_table" not in r.meta for r in resps)
    assert all("dp_table" not in e.meta for e in srv.cache._entries.values())
    assert srv.layers.stats.value_inserts > 0


def test_einsum_workload_is_not_ported():
    """The einsum replay lane needs the planner, which the port does not
    carry yet: both entry points raise."""
    with pytest.raises(NotImplementedError):
        workload.make_einsum_workload()
    with pytest.raises(NotImplementedError):
        workload.einsum_replay_pool()


SETTINGS = {"max_wait": 0.001, "trace": False, "lanes": 4,
            "replica_id": "r1"}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_runtime_settings_are_stored_as_in_the_reference(name):
    """The runtime's and the cluster's settings are stored as the
    reference stores them and reach the runtime ``make_runtime`` and
    ``serve`` build."""
    setting = {name: SETTINGS[name]}
    srv, ref = PlanServer(device=CPU, **setting), RefServer(**setting)
    assert getattr(srv, name) == getattr(ref, name) == SETTINGS[name]
    for attr in ("max_batch", "max_wait", "lanes", "trace", "replica_id"):
        assert getattr(srv, attr) == getattr(ref, attr)
    got, want = srv.make_runtime().config, ref.make_runtime().config
    assert (got.max_batch, got.max_wait, got.lanes) == \
        (want.max_batch, want.max_wait, want.lanes)
    reqs = [PlanRequest(q=_pq(chain(6)), card=make_cardinalities(
        chain(6), seed=1))]
    srv.serve(reqs, closed_loop=True)
    rt = srv.last_runtime
    assert (rt.config.max_wait, rt.config.lanes, rt.config.trace) == \
        (srv.max_wait, srv.lanes, srv.trace)
    assert rt.tracer.enabled == srv.trace


ENTRY_POINTS = ["serve", "make_runtime", "async_runtime", "plan_async",
                "plan_request_async", "prewarm", "prewarm_from_manifest"]


def _answer(r):
    return (r.req_id, float(r.cost).hex(), repr(r.tree), r.status,
            _route(r.route))


def _entry_point(name, srv, pkg):
    """Drive one entry point of a server of ``pkg`` (the reference's or
    the port's service package): comparable results."""
    qg = querygraph if pkg is port_service else ref_querygraph
    q = qg.clique(6)
    card = qg.make_cardinalities(q, seed=21)
    if name == "serve":
        reqs = pkg.make_workload(pkg.WorkloadSpec(
            n_requests=12, seed=4, n_range=(5, 7), pool_size=4))
        resps, stats = srv.serve(reqs, closed_loop=True)
        return [_answer(r) for r in resps], stats.served
    if name == "make_runtime":
        rt = srv.make_runtime(clock=pkg.VirtualClock(),
                              duration_fn=lambda kind, info: 0.5)
        t = rt.submit(pkg.PlanRequest(q=q, card=card, req_id=5))
        rt.drain()
        return _answer(t.response), t.completed_at, t.span.shape()
    if name == "async_runtime":
        rt = srv.async_runtime()
        try:
            assert rt is srv.async_runtime()
            return (rt.executor, type(rt.clock).__name__,
                    rt.config.max_batch, rt.config.max_wait,
                    rt.config.lanes)
        finally:
            rt.close()
    if name in ("plan_async", "plan_request_async"):
        async def main():
            if name == "plan_async":
                return await asyncio.gather(
                    srv.plan_async(q, card, cost="max", req_id=1),
                    srv.plan_async(q, card, cost="out", req_id=2))
            return await asyncio.gather(*(
                srv.plan_request_async(pkg.PlanRequest(
                    q=q, card=card, cost=c, req_id=i, tenant="t"))
                for i, c in enumerate(("cap", "max"))))
        try:
            resps = asyncio.run(main())
        finally:
            srv.async_runtime().close()
        return [_answer(r) for r in resps], srv.stats.served
    if name == "prewarm":
        first = srv.prewarm([6], costs=("max",))
        again = srv.prewarm([6], costs=("max",))
        return first["compiled"], again["compiled"], srv.prewarm_manifest
    manifest = [{"n": 6, "cost": "out", "max_batch": 2, "backend": "xla"},
                {"n": 3, "cost": "max", "max_batch": 2, "backend": "xla"}]
    got = srv.prewarm_from_manifest(manifest)
    return got["compiled"], srv.prewarm_manifest


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_runtime_entry_points_match_reference(name):
    """Each stream-serving, async and prewarm entry point runs in the
    port and answers as the reference's; prewarm builds the buckets the
    reference compiles (manifest ``backend``: the port's tier), after
    which a solve of a prewarmed bucket is a program-cache hit."""
    if name.startswith("prewarm"):
        ref_engine.clear_executable_cache()
        engine.clear_executable_cache()
    srv = PlanServer(max_batch=2, device=CPU)
    ref = RefServer(max_batch=2)
    got = _entry_point(name, srv, port_service)
    want = _entry_point(name, ref, ref_service)
    if name == "prewarm":
        assert got[:2] == want[:2] and got[0] > 0 and got[1] == 0
        assert got[2] == [dict(e, backend={"xla": "f64"}[e["backend"]])
                          for e in want[2]]
        mark = engine.dispatch_mark()
        q = querygraph.clique(6)
        srv.solver.solve([(q, querygraph.make_cardinalities(q, seed=2))])
        recs = engine.dispatches_since(mark)
        assert recs and all(r.aot_cache_hit for r in recs)
    elif name == "prewarm_from_manifest":
        assert got[0] == want[0] > 0
        assert got[1] == [dict(e, backend={"xla": "f64"}[e["backend"]])
                          for e in want[1]]
    else:
        assert got == want


def test_server_runs_on_the_card_unless_asked():
    """``device=None`` means CUDA: without a card it raises, never
    falls back to the CPU."""
    if torch.cuda.is_available():
        assert PlanServer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            PlanServer()
    assert PlanServer(device=CPU).solver.device.type == "cpu"


def test_latency_histogram():
    h = LatencyHistogram()
    assert h.summary() == {"count": 0, "p50_ms": 0.0, "p90_ms": 0.0,
                           "p99_ms": 0.0}
    for s in (1e-3, 2e-3, 3e-3, 1.0):
        h.record(s)
    assert h.count == 4 and h.percentile(50) == pytest.approx(2.5e-3)
    assert sum(c for _, c in h.buckets()) == 4


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_host_engine_server_launches_ranked_conv(cuda_device):
    """A host-engine server's batch lane runs the middle layers through
    the ranked-convolution kernel and answers as the fused server."""
    qs = [maker(13) for maker in (clique, chain, star, cycle)]
    cards = [make_cardinalities(q, seed=600 + i, base_range=(1e1, 1e3))
             for i, q in enumerate(qs)]
    reqs = [PlanRequest(q=_pq(q), card=c) for q, c in zip(qs, cards)]
    host = PlanServer(batch_policy=BatchPolicy(engine="host"),
                      enable_cache=False, device=cuda_device)
    fused = PlanServer(enable_cache=False, device=cuda_device)
    ops.reset_launch_counts()
    got = host._process(reqs)
    assert ops.launch_counts()["ranked_conv"] > 0
    want = fused._process(reqs)
    assert [float(g.cost).hex() for g in got] == \
        [float(w.cost).hex() for w in want]
    assert [repr(g.tree) for g in got] == [repr(w.tree) for w in want]
