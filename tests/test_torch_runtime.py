"""The port's serving runtime against ``repro``'s, ticket by ticket.

The same seeded request stream (made by each package's own generator,
which draws the same stream from the same seed) goes through
``repro.service`` and ``repro_torch.service`` (``device="cpu"``) on a
``VirtualClock`` with the same injected ``duration_fn``.  The runtime's
batch former also reads the solver's measured chunk timings (they feed
the router's EWMA prices); both sides get the same fixed timings
(``_fixed_timings``), as ``duration_fn`` fixes the clock.  Under that,
every ticket must be bitwise equal: the cost's ``float.hex``, the
tree's ``repr``, status, cache hit, route, shed or error reason,
``completed_at`` and span-tree shape, and ``RuntimeStats.as_dict()``.
The labels that differ on purpose are mapped (``meta["backend"]``:
``xla`` -> ``f64``, ``pallas`` -> ``cuda``), never skipped.

The cases mirror the contracts of ``tests/test_runtime.py``,
``tests/test_lanes.py`` and ``tests/test_service_server.py``.
"""
import asyncio
import dataclasses
import random
import types

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.service as R
import repro_torch.service as P
from repro.core import engine as ref_engine
from repro.core import querygraph as RQ
from repro.core.dpconv import optimize as ref_optimize
from repro_torch.core import engine
from repro_torch.core import querygraph as PQ

DUR = {"admit": 0.0, "solve": 1.0, "single": 0.01}
BACKENDS = {"xla": "f64", "pallas": "cuda"}
META_KEYS = ("coalesced", "cached", "best_effort", "certificate", "chunk",
             "batched", "engine", "gamma", "shed", "approx")

REF = types.SimpleNamespace(svc=R, qg=RQ, engine=ref_engine, kw={})
PORT = types.SimpleNamespace(svc=P, qg=PQ, engine=engine,
                             kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dur(kind, info):
    return DUR[kind]


def _lane_dur(kind, info):
    if kind == "solve" and info.get("n") == 6:
        return 0.2                  # small-n buckets solve fast
    return DUR[kind]


def _fixed_timings(srv):
    """Feed the router fixed chunk timings (1 ms per query) instead of
    the measured ones, so that its prices, and with them every batch
    timeout, are the same on both sides."""
    observe = srv._observe_batch
    srv._observe_batch = lambda timings: observe(
        [(n, cnt, 1e-3 * cnt, eng, cost, tags)
         for n, cnt, _, eng, cost, tags in timings])
    return srv


def _server(side, **kw):
    return _fixed_timings(side.svc.PlanServer(**kw, **side.kw))


def _mk(side, max_batch=8, duration_fn=_dur, injector=None, srv_kw=None,
        **cfg_kw):
    srv = _server(side, max_batch=max_batch, **(srv_kw or {}))
    clk = side.svc.VirtualClock()
    cfg = side.svc.RuntimeConfig(max_batch=max_batch, **cfg_kw)
    return srv, clk, srv.make_runtime(clock=clk, config=cfg,
                                      duration_fn=duration_fn,
                                      injector=injector)


def _spec(side, **kw):
    base = dict(n_requests=24, seed=0, n_range=(6, 7), pool_size=6,
                rate=500.0)
    base.update(kw)
    return side.svc.WorkloadSpec(**base)


def _workload(side, **kw):
    return side.svc.make_workload(_spec(side, **kw))


def _batch_miss(reqs):
    return next(r for r in reqs if r.cost == "max" and r.q.n >= 6)


def _route(r):
    return None if r is None else (r.cost, r.method, r.lane, r.params,
                                   r.reason)


def _meta(meta, port: bool):
    """The compared part of a response's meta.  The port labels a
    chunk-1 batch-lane result with the tier it ran (``f64``, or ``cuda``
    for a max solve on the card's kernel tier), where the reference sets
    no ``backend``: that label is checked here and then left out."""
    d = {k: meta[k] for k in META_KEYS if k in meta}
    if "backend" in meta:
        d["backend"] = BACKENDS.get(meta["backend"], meta["backend"])
        if port and meta.get("chunk") == 1 and meta.get("batched") is False:
            assert d.pop("backend") in ("f64", "cuda")
    return d


def _resp(r):
    if r is None:
        return None
    port = type(r).__module__.startswith("repro_torch")
    return (r.req_id, float(r.cost).hex(), repr(r.tree), r.status,
            r.cache_hit, _route(r.route), _meta(r.meta, port),
            None if r.error is None else (type(r.error).__name__,
                                          str(r.error)))


def _answer(r):
    """A response of ``serve`` without injected durations: the reference
    charges a bucket's first JAX compile to the solve's wall time, which
    may trip its watchdog into the host-exact rung (same answer, other
    meta), so only the answer and its route are compared."""
    return (r.req_id, float(r.cost).hex(), repr(r.tree), r.status,
            r.cache_hit, _route(r.route))


def _ticket(t):
    """Everything a ticket shows, in comparable form."""
    return (t.done, t.refused, t.refuse_reason, t.status, t.downgraded,
            t.faulted, t.completed_at, t.deadline, _route(t.route),
            None if t.error is None else (type(t.error).__name__,
                                          str(t.error)),
            _resp(t.response), t.span.shape() if t.span else None)


def _both(fn):
    """``fn(side)`` on the reference and the port: both results."""
    return fn(REF), fn(PORT)


def _same(fn):
    """Run ``fn`` on both sides and assert equal results; return the
    port's."""
    want, got = _both(fn)
    assert got == want
    return got


def _pq(q):
    return PQ.QueryGraph(q.n, tuple(q.edges), tuple(q.hyperedges))


# ------------------------------------------------------------- scenarios
def test_hit_overtakes_inflight_miss():
    def run(side):
        reqs = _workload(side)
        srv, clk, rt = _mk(side)
        hot = reqs[0]
        prime = srv.make_runtime(clock=side.svc.VirtualClock(),
                                 duration_fn=_dur)
        prime.submit(hot)                           # prime the plan cache
        prime.drain()
        miss = _batch_miss(reqs[1:])
        t_miss = rt.submit(miss)
        rt.flush()                                  # solve starts
        assert not t_miss.done and len(rt._inflight) == 1
        clk.advance_to(0.5)
        rt.poll()
        t_hit = rt.submit(hot)                      # arrives mid-flight
        assert t_hit.done and t_hit.response.cache_hit
        assert t_hit.completed_at == 0.5
        assert rt.stats.fast_path_hits == 1 and rt.stats.overtakes == 1
        rt.drain()
        assert t_miss.done and t_miss.completed_at == 1.0
        return [_ticket(t_miss), _ticket(t_hit)], rt.stats.as_dict()
    _same(run)


def test_coalescing_joins_relabeled_duplicates_on_one_solve():
    def run(side):
        reqs = _workload(side)
        miss = _batch_miss(reqs)
        perm = np.random.default_rng(3).permutation(miss.q.n)
        dup = dataclasses.replace(
            miss, q=side.qg.relabel(miss.q, perm),
            card=side.qg.permute_card(miss.card, miss.q.n, perm),
            req_id=999)
        srv, clk, rt = _mk(side)
        side.engine.reset_stats()
        ta, tb = rt.submit(miss), rt.submit(dup)
        rt.drain()
        assert rt.stats.coalesced == 1 and rt.stats.batches == 1
        assert side.engine.stats().solves == 1       # one fused solve
        assert tb.response.meta.get("coalesced") is True
        assert ta.response.tree.mask == miss.q.full_mask
        assert tb.response.tree.cost_max(dup.card) == \
            float(tb.response.cost)
        return [_ticket(ta), _ticket(tb)], rt.stats.as_dict()
    _same(run)


def test_timeout_closes_partial_batch():
    def run(side):
        miss = _batch_miss(_workload(side))
        srv, clk, rt = _mk(side)
        t = rt.submit(miss)
        close_at = rt.next_event_time()
        assert close_at <= side.svc.RuntimeConfig().max_wait
        clk.advance_to(close_at)
        rt.poll()
        assert rt.stats.batches == 1
        assert rt.stats.mean_batch_occupancy == 1.0
        rt.run_until(close_at + DUR["solve"])
        assert t.done and t.completed_at == close_at + DUR["solve"]
        return close_at, _ticket(t)
    _same(run)


def test_shed_on_unmeetable_deadline_refuse_and_downgrade():
    def run(side):
        S = side.svc
        classes = {"strict": S.SLOClass("strict", 1e-12, "refuse"),
                   "loose": S.SLOClass("loose", 1e-12, "downgrade")}
        miss = _batch_miss(_workload(side))
        srv, clk, rt = _mk(side, slo_classes=classes)
        t_ref = rt.submit(dataclasses.replace(miss, slo="strict"))
        assert t_ref.done and t_ref.refused and t_ref.response is None
        t_dg = rt.submit(dataclasses.replace(miss, slo="loose", req_id=1))
        rt.drain()
        assert t_dg.response.route.method == "goo" and t_dg.downgraded
        assert rt.stats.deadline_misses == 0
        assert rt.stats.per_class["strict"].shed == 1
        assert rt.stats.per_class["loose"].downgraded == 1
        return [_ticket(t_ref), _ticket(t_dg)], rt.stats.as_dict()
    _same(run)


def test_met_deadline_class_has_zero_misses():
    def run(side):
        classes = {"std": side.svc.SLOClass("std", 10.0)}
        reqs = [dataclasses.replace(r, slo="std")
                for r in _workload(side, n_requests=12)]
        srv, clk, rt = _mk(side, slo_classes=classes)
        ts = [rt.submit(r) for r in reqs]
        rt.drain()
        cs = rt.stats.per_class["std"]
        assert cs.served == len(reqs) and cs.deadline_misses == 0
        return [_ticket(t) for t in ts], rt.stats.as_dict()
    _same(run)


def test_backpressure_refuses_past_max_pending():
    def run(side):
        reqs = _workload(side)
        misses = [r for r in reqs if r.cost == "max" and r.q.n >= 6][:3]
        srv, clk, rt = _mk(side, max_batch=16, max_pending=1)
        ts = [rt.submit(m) for m in misses]
        rt.drain()
        assert ts[0].form.key != ts[1].form.key and ts[1].refused
        assert rt.stats.shed_backpressure >= 1
        assert ts[0].done and ts[0].response is not None
        return [_ticket(t) for t in ts], rt.stats.as_dict()
    _same(run)


def test_sync_serve_is_runtime_backed_and_sheds_visibly():
    def run(side):
        reqs = _workload(side, n_requests=8)
        srv = _server(side, max_batch=4)
        resps, stats = srv.serve(list(reqs), closed_loop=True)
        assert srv.last_runtime.stats.served == len(reqs)
        with pytest.raises(ValueError):         # unknown class is loud
            _server(side, max_batch=4).serve(
                [dataclasses.replace(reqs[0], slo="x")], closed_loop=True)
        return [_answer(r) for r in resps], stats.served
    _same(run)


def test_solve_error_recovers_through_the_failure_ladder():
    """A batched solve that raises is retried solo by the failure
    ladder and recovers the exact answer; the coalesced follower rides
    along and nothing is left in flight."""
    def run(side):
        reqs = _workload(side)
        miss = _batch_miss(reqs)
        srv, clk, rt = _mk(side)

        def exploding_submit(items, extract_tree=True):
            raise RuntimeError("boom")

        srv.solver.submit = exploding_submit
        ta = rt.submit(miss)
        tb = rt.submit(dataclasses.replace(miss, req_id=1))
        rt.drain()
        assert ta.faulted and ta.status == "exact"
        assert rt.fstats.retries + rt.fstats.isolation_retries >= 1
        assert not rt._inflight and not rt._by_key
        del srv.solver.submit
        tc = rt.submit(next(r for r in reqs if r.cost == "max"
                            and r.q.n >= 6 and r.q.edges != miss.q.edges))
        rt.drain()
        assert tc.response is not None
        return ([_ticket(t) for t in (ta, tb, tc)], rt.stats.as_dict(),
                rt.fstats.as_dict())
    got = _same(run)
    miss = _batch_miss(_workload(REF))
    assert got[0][0][10][1] == \
        float(ref_optimize(miss.q, miss.card, cost="max").cost).hex()


# ---------------------------------------------------------- async façade
def test_plan_async_concurrent_parity_and_coalesce():
    """The WallClock thread front end on the CPU: three concurrent
    awaiters of one canonical form batch or coalesce, and their answers
    equal the reference's host solve."""
    miss = _batch_miss(_workload(REF, n_requests=6, seed=3))
    perm = np.random.default_rng(5).permutation(miss.q.n)
    q, card = _pq(miss.q), miss.card
    dup_q = PQ.relabel(q, perm)
    dup_card = PQ.permute_card(card, q.n, perm)
    srv = P.PlanServer(max_batch=4, device="cpu")

    async def main():
        return await asyncio.gather(
            srv.plan_async(q, card, cost="max"),
            srv.plan_async(dup_q, dup_card, cost="max"),
            srv.plan_async(q, card, cost="max", req_id=3))

    try:
        r1, r2, r3 = asyncio.run(main())
    finally:
        srv.async_runtime().close()
    ref = ref_optimize(miss.q, miss.card, cost="max", engine="host")
    want = R.PlanServer().plan_one(miss.q, miss.card, cost="max")
    assert float(r1.cost).hex() == float(r2.cost).hex() == \
        float(r3.cost).hex() == float(ref.cost).hex()
    assert repr(r1.tree) == repr(r3.tree) == repr(want.tree)
    assert r2.tree.cost_max(dup_card) == float(ref.cost)
    rt = srv.async_runtime()
    assert rt.executor == "thread"
    assert rt.stats.coalesced + rt.stats.fast_path_hits >= 1
    assert rt.stats.served == 3 and srv.stats.served == 3


# -------------------------------------------- fixed interleavings: parity
ORDERS = [(0, 1), (11, 7), (403, 29), (5150, 3), (77, 1234), (90210, 8)]


@pytest.mark.parametrize("wl_seed,order_seed", ORDERS,
                         ids=[f"wl{w}-ord{o}" for w, o in ORDERS])
def test_any_interleaving_matches_sync_serve(wl_seed, order_seed):
    """Any submission order and clock skew gives the answers of the
    synchronous ``serve`` on the same workload, and the port's tickets
    equal the reference's under the same order."""
    def run(side):
        reqs = _workload(side, n_requests=16, seed=wl_seed % 997,
                         n_range=(5, 7), pool_size=5)
        sync, _ = _server(side, max_batch=8).serve(list(reqs),
                                                   closed_loop=True)
        by_id = {r.req_id: r for r in sync}
        rng = random.Random(order_seed)
        order = list(reqs)
        rng.shuffle(order)
        srv, clk, rt = _mk(side)
        tickets = []
        for r in order:
            clk.advance(rng.random() * 2e-3)
            rt.poll()
            tickets.append(rt.submit(r))
        rt.drain()
        for t in tickets:
            want = by_id[t.request.req_id]
            assert t.response is not None
            assert float(t.response.cost).hex() == float(want.cost).hex()
            assert repr(t.response.tree) == repr(want.tree)
        return [_ticket(t) for t in tickets], rt.stats.as_dict()
    _same(run)


# ------------------------------------------------------------ serve / server
def _small(side, **kw):
    base = dict(n_requests=24, seed=0, n_range=(5, 7), pool_size=6,
                rate=500.0)
    base.update(kw)
    return side.svc.make_workload(side.svc.WorkloadSpec(**base))


@pytest.mark.parametrize("closed_loop", [True, False],
                         ids=["closed_loop", "arrivals"])
def test_serve_matches_reference(closed_loop):
    """``serve`` answers as the reference's, request by request, with
    the same plan-cache and router counters; closed-loop and arrival-
    driven serving give the same answers."""
    def run(side):
        reqs = _small(side)
        srv = _server(side, max_batch=8)
        resps, stats = srv.serve(reqs, closed_loop=closed_loop)
        assert stats.served == len(reqs)
        assert [r.req_id for r in resps] == [r.req_id for r in reqs]
        assert all(r.latency > 0 for r in resps)
        cs = srv.cache.stats
        assert cs.lookups == len(reqs)
        for req, resp in zip(reqs, resps):
            if resp.tree is not None:
                assert resp.tree.validate()
                assert resp.tree.mask == req.q.full_mask
        if not closed_loop:
            # arrival-driven serving charges measured solve times to the
            # virtual clock, so which repeats coalesce and which hit the
            # cache depends on the host: answers only
            return [_answer(r)[1:3] for r in resps]
        assert cs.hits > 0                   # repeats hit the cache
        return ([_answer(r) for r in resps], cs.as_dict(),
                dict(srv.router.decisions))
    got = _same(run)
    if closed_loop:
        again = _server(PORT, max_batch=8).serve(_small(PORT))[0]
        assert [_answer(r)[1:3] for r in again] == [a[1:3] for a in got[0]]


def test_deadline_fallback_served_and_counted():
    def run(side):
        reqs = _small(side, n_requests=16, budget_frac=1.0, budget_s=1e-12)
        srv = _server(side, max_batch=4)
        resps, stats = srv.serve(reqs, closed_loop=True)
        assert stats.deadline_fallbacks == len(reqs)
        assert all(r.route.method == "goo" and r.tree.validate()
                   for r in resps)
        return [_answer(r) for r in resps]
    _same(run)


def test_stats_accumulate_across_serves():
    def run(side):
        reqs = _small(side, n_requests=8)
        srv = _server(side, max_batch=4)
        srv.serve(reqs, closed_loop=True)
        srv.serve(reqs, closed_loop=True)
        assert srv.stats.served == 16 and srv.cache.stats.hits >= 8
        return srv.stats.served, srv.cache.stats.as_dict()
    _same(run)


# --------------------------------------------------------------- lanes
def _lane_reqs(side, n, count, cost="max", topo="chain", seed0=0):
    q = getattr(side.qg, topo)(n)
    return [side.svc.PlanRequest(
        q=q, card=side.qg.make_cardinalities(q, seed=seed0 + i),
        cost=cost, req_id=seed0 + i) for i in range(count)]


def test_lane_affinity_keeps_a_bucket_home():
    def run(side):
        srv, clk, rt = _mk(side, lanes=3, duration_fn=_lane_dur)
        for r in _lane_reqs(side, 6, 3):
            rt.submit(r)
            rt.drain()
        lanes = rt.stats.lane_dispatches
        assert sum(lanes.values()) == 3 and len(lanes) == 1
        home = next(iter(lanes))
        assert rt._affinity[(6, "max")] == home
        assert srv.registry.counter(
            f"runtime.lane{home}.dispatches").value == 3
        return rt.stats.as_dict(), dict(rt._affinity)
    _same(run)


@pytest.mark.parametrize("budget", [0.5, None], ids=["deadline", "none"])
def test_steal_only_to_keep_a_promised_deadline(budget):
    """A deadline-promised work whose home lane is busy runs on a free
    lane; a best-effort one waits out its home lane."""
    def run(side):
        srv, clk, rt = _mk(side, lanes=2, duration_fn=_lane_dur)
        big = _lane_reqs(side, 7, 1)[0]
        small = dataclasses.replace(_lane_reqs(side, 6, 1, seed0=50)[0],
                                    latency_budget=budget)
        rt._affinity[(7, "max")] = 0
        rt._affinity[(6, "max")] = 0
        tb = rt.submit(big)
        rt.flush()
        t = rt.submit(small)
        rt.drain()
        if budget is None:
            assert rt.stats.steals == 0
            assert rt.stats.lane_dispatches == {0: 2}
        else:
            assert rt.stats.lane_steals == {1: 1}
            assert t.completed_at <= t.deadline
            assert rt.stats.deadline_misses == 0
        return [_ticket(tb), _ticket(t)], rt.stats.as_dict()
    _same(run)


def test_lane_counters_sum_and_bitwise_parity_vs_single_lane():
    """Four buckets over four lanes: per-lane counters sum to the batch
    count, and every response equals the one-lane runtime's (and the
    reference's four-lane runtime's)."""
    def run(side, lanes):
        stream = (_lane_reqs(side, 6, 3) + _lane_reqs(side, 7, 3)
                  + _lane_reqs(side, 6, 3, "cap", "star", 20)
                  + _lane_reqs(side, 7, 3, "cap", "star", 30))
        srv, clk, rt = _mk(side, lanes=lanes, duration_fn=_lane_dur)
        tickets = [rt.submit(r) for r in stream]
        rt.drain()
        return rt, tickets

    rt1, t1 = run(PORT, 1)
    rt4, t4 = run(PORT, 4)
    ref4, r4 = run(REF, 4)
    lanes4 = rt4.stats.lane_dispatches
    assert rt1.stats.lane_dispatches == {0: rt1.stats.batches}
    assert sum(lanes4.values()) == rt4.stats.batches == rt1.stats.batches
    assert len(lanes4) > 1
    for a, b in zip(t1, t4):
        assert _resp(a.response)[1:3] == _resp(b.response)[1:3]
    assert [_ticket(t) for t in t4] == [_ticket(t) for t in r4]
    assert rt4.stats.as_dict() == ref4.stats.as_dict()
    # each lane's solver ran on the server's device, its records carry
    # the lane
    assert {s.device.type for s in rt4._solvers} == {"cpu"}
    assert [s.lane for s in rt4._solvers] == [0, 1, 2, 3]


def _half_open_setup(side, lanes, plan=None):
    S = side.svc
    inj = S.faults.FaultInjector(plan) if plan is not None else None
    srv, clk, rt = _mk(side, lanes=lanes, duration_fn=_lane_dur,
                       injector=inj,
                       breaker=S.faults.BreakerConfig(failure_threshold=1,
                                                      cooldown_s=0.1))
    warm = _lane_reqs(side, 6, 1, seed0=70)[0]
    t0 = rt.submit(warm)
    rt.drain()
    key = rt._breaker_key(t0.route, warm.q.n)
    rt.breakers.on_failure(key)
    assert rt.breakers.state(key) == "open"
    clk.advance(0.2)                        # past cooldown: half-open
    return srv, clk, rt, key


@pytest.mark.parametrize("case", ["winner", "probe_fails", "single_lane"])
def test_hedged_probes(case):
    """A half-open probe on two lanes races a host-exact shadow: the
    first finisher answers and the loser still settles the breaker; a
    failing probe re-opens it; one lane is never hedged."""
    def run(side):
        plan = None
        if case == "probe_fails":
            plan = side.svc.faults.FaultPlan(seed=0, specs=(
                side.svc.faults.FaultSpec("dispatch", "raise", rate=1.0,
                                          after=1, max_fires=1),))
        lanes = 1 if case == "single_lane" else 2
        srv, clk, rt, key = _half_open_setup(side, lanes, plan)
        req = _lane_reqs(side, 6, 1, seed0=80)[0]
        t = rt.submit(req)
        assert rt.stats.hedges == (0 if lanes == 1 else 1)
        rt.drain()
        assert t.done and t.response is not None
        want = "open" if case == "probe_fails" else "closed"
        assert rt.breakers.state(key) == want
        out = ([_ticket(t)], rt.stats.as_dict(), rt.fstats.as_dict(),
               rt.breakers.snapshot())
        rt.close()
        return out
    got = _same(run)
    req = _lane_reqs(REF, 6, 1, seed0=80)[0]
    assert got[0][0][10][1] == \
        float(ref_optimize(req.q, req.card, cost="max").cost).hex()


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_runtime_on_card_matches_cpu(cuda_device):
    """The same stream through a card runtime (inline and thread
    executors) answers as the CPU runtime, and its batch-lane dispatch
    records carry the card and a device-timed ``execute_s``."""
    reqs = _small(PORT, n_requests=24, n_range=(12, 13), pool_size=6,
                  topologies=("clique",))
    cpu, _ = _server(PORT, max_batch=8).serve(list(reqs), closed_loop=True)
    srv = _fixed_timings(P.PlanServer(max_batch=8, device=cuda_device))
    srv.prewarm([12, 13], costs=("max",))
    mark = engine.dispatch_mark()
    got, _ = srv.serve(list(reqs), closed_loop=True)
    recs = engine.dispatches_since(mark)
    assert [_resp(r)[1:3] for r in got] == [_resp(r)[1:3] for r in cpu]
    assert recs and all(r.devices == ("cuda:0",) and r.execute_s > 0
                        for r in recs)
    rt = srv.make_runtime(executor="thread")
    try:
        ts = [rt.submit(r) for r in reqs]
        rt.drain()
    finally:
        rt.close()
    assert [_resp(t.response)[1:3] for t in ts] == \
        [_resp(r)[1:3] for r in cpu]
    assert rt.fstats.as_dict() == {k: 0 for k in rt.fstats.as_dict()}
