"""The port's resilience layer (``service.faults`` and the runtime's
failure ladder) against ``repro``'s.

The breaker board, the quarantine and the seeded injector are copies:
driven by the same script they must give the same states and snapshots.
The ladder is held end to end: the same seeded stream and the same
fault plan through both runtimes on a ``VirtualClock`` with the same
injected durations (and the same fixed chunk timings, see
``tests/test_torch_runtime.py``) give bitwise-equal tickets, fault
counters, breaker and quarantine snapshots.  The cases mirror the
contracts of ``tests/test_faults.py``; the chaos property runs on fixed
seeds.
"""
import dataclasses
import types

import jax  # noqa: F401
import pytest
import torch

import repro.service as R
import repro_torch.service as P
from repro.core import engine as ref_engine
from repro.core.dpconv import optimize as ref_optimize
from repro.service import faults as ref_faults
from repro_torch.core import engine
from repro_torch.service import faults

DUR = {"admit": 0.0, "solve": 1.0, "single": 0.01}
CHAOS_CFG = dict(watchdog_min=0.5, retry_backoff=1e-3,
                 retry_backoff_cap=0.05)

REF = types.SimpleNamespace(svc=R, faults=ref_faults, engine=ref_engine,
                            kw={})
PORT = types.SimpleNamespace(svc=P, faults=faults, engine=engine,
                             kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dur(kind, info):
    return DUR[kind]


def _fixed_timings(srv):
    """Fixed chunk timings for the router's prices (both sides)."""
    observe = srv._observe_batch
    srv._observe_batch = lambda timings: observe(
        [(n, cnt, 1e-3 * cnt, eng, cost, tags)
         for n, cnt, _, eng, cost, tags in timings])
    return srv


def _mk(side, max_batch=8, plan=None, **cfg_kw):
    srv = _fixed_timings(side.svc.PlanServer(max_batch=max_batch,
                                             **side.kw))
    clk = side.svc.VirtualClock()
    cfg = side.svc.RuntimeConfig(max_batch=max_batch, **cfg_kw)
    inj = side.faults.FaultInjector(plan) if plan is not None else None
    return srv, clk, srv.make_runtime(clock=clk, config=cfg,
                                      duration_fn=_dur, injector=inj)


def _workload(side, **kw):
    base = dict(n_requests=24, seed=0, n_range=(6, 7), pool_size=6,
                rate=500.0)
    base.update(kw)
    return side.svc.make_workload(side.svc.WorkloadSpec(**base))


def _batch_miss(reqs):
    return next(r for r in reqs if r.cost == "max" and r.q.n >= 6)


def _ref_cost(req):
    return float(ref_optimize(req.q, req.card, cost=req.cost).cost)


def _ticket(t):
    r = t.response
    return (t.request.req_id, t.done, t.refused, t.refuse_reason, t.status,
            t.faulted, t.downgraded, t.completed_at,
            None if t.error is None else (type(t.error).__name__,
                                          str(t.error)),
            None if r is None else (float(r.cost).hex(), repr(r.tree),
                                    r.status, r.cache_hit,
                                    r.route.method, r.route.lane,
                                    bool(r.meta.get("best_effort")),
                                    r.meta.get("certificate")),
            t.span.shape())


def _state(rt, tickets):
    return ([_ticket(t) for t in tickets], rt.fstats.as_dict(),
            rt.breakers.snapshot(), rt.quarantine.snapshot(),
            rt.stats.as_dict(),
            None if rt.injector is None else rt.injector.snapshot())


def _same(fn):
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


# -------------------------------------------------------- breaker FSM
def _breaker_script(f, clk):
    cfg = f.BreakerConfig(failure_threshold=3, cooldown_s=1.0,
                          half_open_probes=1)
    b = f.BreakerBoard(clk, cfg)
    key = "fused:n=8"
    out = [b.allow(key), bool(b.lanes)]
    b.on_failure(key)
    b.on_failure(key)
    out += [b.state(key), b.allow(key)]
    b.on_success(key)
    for _ in range(3):
        b.on_failure(key)
        out.append(b.state(key))
    out += [b.opens, b.allow(key), b.open_lanes()]
    clk.advance(1.0)
    out += [b.allow(key), b.state(key), b.allow(key)]
    b.on_failure(key, probe=True)
    out += [b.state(key), b.opens, b.allow(key)]
    clk.advance(0.5)
    out.append(b.allow(key))
    clk.advance(0.5)
    out.append(b.allow(key))
    b.on_success(key, probe=True)
    out += [b.state(key), b.closes, b.allow(key), b.snapshot()]
    return out


def test_breaker_fsm_closed_open_halfopen_roundtrip():
    got = _breaker_script(faults, P.VirtualClock())
    assert got == _breaker_script(ref_faults, R.VirtualClock())
    assert got[:6] == [(True, False), False, "closed", (True, False),
                       "closed", "closed"]
    assert got[6:10] == ["open", 1, (False, False), ["fused:n=8"]]
    assert got[10:13] == [(True, True), "half_open", (False, False)]
    assert got[13:18] == ["open", 2, (False, False), (False, False),
                          (True, True)]
    assert got[18:21] == ["closed", 1, (True, False)]
    assert got[21]["opens"] == 2 and got[21]["open_lanes"] == []


def test_breaker_non_probe_success_does_not_close_half_open():
    def run(f, clk):
        b = f.BreakerBoard(clk, f.BreakerConfig(failure_threshold=1,
                                                cooldown_s=0.1))
        b.on_failure("k")
        clk.advance(0.2)
        out = [b.allow("k")]
        b.on_success("k", probe=False)
        out.append(b.state("k"))
        b.on_success("k", probe=True)
        return out + [b.state("k"), b.snapshot()]
    got = run(faults, P.VirtualClock())
    assert got == run(ref_faults, R.VirtualClock())
    assert got[:3] == [(True, True), "half_open", "closed"]


# -------------------------------------------------------- quarantine
def test_quarantine_ttl_expiry():
    def run(f, clk):
        q = f.Quarantine(clk, ttl_s=5.0)
        out = [q.active("k")]
        q.add("k", reason="boom")
        out += [q.active("k"), q.hits]
        clk.advance(4.999)
        out.append(q.active("k"))
        clk.advance(0.001)
        out += [q.active("k"), q.expired, q.active("k")]
        return out + [q.snapshot()]
    got = run(faults, P.VirtualClock())
    assert got == run(ref_faults, R.VirtualClock())
    assert got == [False, True, 1, True, False, 1, False,
                   {"ttl_s": 5.0, "live": 0, "added": 1, "hits": 2,
                    "expired": 1}]


# --------------------------------------------------- injector determinism
SEAMS = ("dispatch", "cache", "dispatch", "dispatch", "cache", "dispatch",
         "dispatch", "dispatch", "dispatch")


def _injector_run(f):
    plan = f.FaultPlan(seed=7, specs=(
        f.FaultSpec("dispatch", "raise", rate=0.5),
        f.FaultSpec("dispatch", "garbage", rate=0.5, after=3,
                    max_fires=2),
        f.FaultSpec("cache", "raise", rate=0.3)))
    inj = f.FaultInjector(plan)
    seq = [inj.arm(s) for s in SEAMS]
    return [None if s is None else (s.seam, s.kind) for s in seq], \
        inj.snapshot()


def test_injector_is_deterministic_and_respects_caps():
    got = _injector_run(faults)
    assert got == _injector_run(faults) == _injector_run(ref_faults)
    seq = got[0]
    assert sum(1 for s in seq if s and s[1] == "garbage") <= 2
    assert all(s[1] != "garbage" for s in (seq[0], seq[2], seq[3]) if s)
    chaos = faults.FaultPlan.chaos(seed=3, rate=0.2)
    want = ref_faults.FaultPlan.chaos(seed=3, rate=0.2)
    assert [dataclasses.astuple(s) for s in chaos.specs] == \
        [dataclasses.astuple(s) for s in want.specs]


def test_fault_spec_validation_and_taxonomy():
    with pytest.raises(ValueError):
        faults.FaultSpec("disk")
    with pytest.raises(ValueError):
        faults.FaultSpec("dispatch", kind="explode")
    err = faults.as_plan_error(RuntimeError("boom"))
    assert isinstance(err, faults.EngineError)
    assert isinstance(err.__cause__, RuntimeError)
    assert faults.as_plan_error(err) is err
    assert faults.TimeoutError is faults.PlanTimeoutError
    assert issubclass(faults.WorkerDied, faults.EngineError)
    assert issubclass(faults.CompileError, faults.EngineError)
    q = faults.QuarantinedError("x", req_id=3)
    assert q.code == "quarantined" and q.context == {"req_id": 3}
    codes = {name: getattr(faults, name).code for name in (
        "PlanError", "ShedError", "EngineError", "WorkerDied",
        "CompileError", "CacheBackendError", "PlanTimeoutError",
        "QuarantinedError", "NetworkError", "ReplicaDeadError")}
    assert codes == {name: getattr(ref_faults, name).code
                     for name in codes}


# --------------------------------------------------- the ladder, end to end
def _one_fault(side, seam, kind, n_fires=1, req_kw=None, **cfg_kw):
    """One batch miss under one fault spec: the runtime's state."""
    f = side.faults
    plan = f.FaultPlan(seed=0, specs=(
        f.FaultSpec(seam, kind, rate=1.0, max_fires=n_fires),))
    miss = dataclasses.replace(_batch_miss(_workload(side)),
                               **(req_kw or {}))
    srv, clk, rt = _mk(side, plan=plan, **cfg_kw)
    t = rt.submit(miss)
    rt.drain()
    assert t.done and not rt._inflight and not rt._by_key
    out = _state(rt, [t])
    rt.close()
    return out


LADDER = {
    # name: (seam, kind, fires, request fields, config)
    "watchdog": ("dispatch", "hang", 1, None, {"watchdog_min": 0.5}),
    "watchdog_off": ("dispatch", "hang", 1, None, {"watchdog_factor": 0.0}),
    "garbage": ("dispatch", "garbage", 1, None, {}),
    "retry_headroom_denied": ("dispatch", "raise", 1,
                              {"latency_budget": 5.0},
                              {"retry_backoff": 100.0,
                               "retry_backoff_cap": 100.0}),
    "retry_with_headroom": ("dispatch", "raise", 1, None,
                            {"retry_backoff": 100.0,
                             "retry_backoff_cap": 100.0}),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_failure_ladder_matches_reference(case):
    """Watchdog, garbage containment and deadline-capped retries: the
    request recovers the exact optimum, and every ticket field, fault
    counter and breaker state equals the reference's."""
    seam, kind, fires, req_kw, cfg = LADDER[case]
    got = _same(lambda side: _one_fault(side, seam, kind, fires, req_kw,
                                        **cfg))
    (ticket,), fstats = got[0], got[1]
    want = float(_ref_cost(_batch_miss(_workload(REF)))).hex()
    assert ticket[4] == "exact" and ticket[9][0] == want
    expect = {
        "watchdog": {"watchdog_fires": 1, "zombie_completions": 1},
        "watchdog_off": {"watchdog_fires": 0},
        "garbage": {"garbage_caught": 1},
        "retry_headroom_denied": {"retries": 0, "failover_host": 1},
        "retry_with_headroom": {"retries": 1, "failover_host": 0,
                                "retry_denied_headroom": 0},
    }[case]
    assert {k: fstats[k] for k in expect} == expect
    if case == "retry_headroom_denied":
        assert fstats["retry_denied_headroom"] >= 1


def test_garbage_result_never_reaches_the_cache():
    def run(side):
        f = side.faults
        plan = f.FaultPlan(seed=0, specs=(
            f.FaultSpec("dispatch", "garbage", rate=1.0, max_fires=1),))
        miss = _batch_miss(_workload(side))
        srv, clk, rt = _mk(side, plan=plan)
        t = rt.submit(miss)
        rt.drain()
        t2 = rt.submit(dataclasses.replace(miss, req_id=991))
        assert t2.done and t2.response.cache_hit
        out = _state(rt, [t, t2])
        rt.close()
        return out
    got = _same(run)
    want = float(_ref_cost(_batch_miss(_workload(REF)))).hex()
    assert got[0][0][9][0] == got[0][1][9][0] == want


def test_poisoned_key_quarantined_then_released_after_ttl():
    """Persistent solo failure walks the whole ladder to the certified
    GOO floor and quarantines the key; a repeat is refused with a typed
    error; after the TTL the key and the primary lane recover."""
    def run(side):
        f = side.faults
        plan = f.FaultPlan(seed=0, specs=(
            f.FaultSpec("dispatch", "raise", rate=1.0, max_fires=6),))
        miss = _batch_miss(_workload(side))
        srv, clk, rt = _mk(side, plan=plan, quarantine_ttl=30.0)
        t1 = rt.submit(miss)
        rt.drain()
        assert t1.status == "degraded" and t1.faulted
        cert = t1.response.meta["certificate"]
        assert cert["kind"] == "goo"
        assert cert["upper_bound"] == t1.response.cost
        assert rt.breakers.open_lanes()
        t2 = rt.submit(dataclasses.replace(miss, req_id=991))
        assert t2.status == "error"
        assert isinstance(t2.error, f.QuarantinedError)
        assert rt.stats.shed == 0 and rt.stats.shed_backpressure == 0
        clk.advance(31.0)
        t3 = rt.submit(dataclasses.replace(miss, req_id=992))
        rt.drain()
        assert t3.status == "exact"
        assert not any(k.startswith("fused")
                       for k in rt.breakers.open_lanes())
        out = _state(rt, [t1, t2, t3]), dict(rt.recorder.counts)
        rt.close()
        return out
    got = _same(run)
    tickets, fstats = got[0][0], got[0][1]
    assert fstats["quarantined"] == fstats["failover_goo"] == 1
    assert fstats["quarantine_refusals"] == 1
    want = float(_ref_cost(_batch_miss(_workload(REF)))).hex()
    assert float.fromhex(tickets[0][9][0]) >= float.fromhex(want)
    assert tickets[2][9][0] == want


def test_compile_fault_recovers_via_ladder():
    """An injected build failure at the engine's program-build seam
    fails the dispatch; the ladder lands the exact plan, and ``close``
    uninstalls the hook."""
    def run(side):
        f = side.faults
        plan = f.FaultPlan(seed=0, specs=(
            f.FaultSpec("compile", "raise", rate=1.0, max_fires=1),))
        srv, clk, rt = _mk(side, plan=plan)
        side.engine.clear_executable_cache()
        try:
            t = rt.submit(_batch_miss(_workload(side)))
            rt.drain()
            assert t.status == "exact" and t.faulted
            out = _state(rt, [t])
        finally:
            rt.close()
        assert side.engine._COMPILE_FAULT_HOOK is None
        return out
    got = _same(run)
    assert got[5]["fired"] == 1


def test_cache_fault_fails_open_to_a_miss():
    def run(side):
        f = side.faults
        plan = f.FaultPlan(seed=0, specs=(
            f.FaultSpec("cache", "raise", rate=1.0),))
        miss = _batch_miss(_workload(side))
        srv, clk, rt = _mk(side, plan=plan)
        prime = srv.make_runtime(clock=side.svc.VirtualClock(),
                                 duration_fn=_dur)
        prime.submit(miss)
        prime.drain()
        t = rt.submit(dataclasses.replace(miss, req_id=991))
        rt.drain()
        assert rt.fstats.cache_faults >= 1
        assert t.status == "exact" and t.faulted
        out = _state(rt, [t])
        rt.close()
        return out
    got = _same(run)
    assert got[0][0][9][0] == \
        float(_ref_cost(_batch_miss(_workload(REF)))).hex()


# ------------------------------------------------------ chaos, fixed seeds
def _chaos(side, seed, wl_seed, rate):
    """One chaos run from a cold program cache (so the build seam arms
    at the same points on both sides)."""
    side.engine.clear_executable_cache()
    reqs = _workload(side, n_requests=16, seed=wl_seed)
    plan = side.faults.FaultPlan.chaos(seed=seed, rate=rate)
    srv, clk, rt = _mk(side, plan=plan, **CHAOS_CFG)
    tickets = [rt.submit(r) for r in reqs]
    rt.drain()
    assert not rt._inflight and not rt._by_key
    out = _state(rt, tickets)
    rt.close()
    return reqs, tickets, out


CHAOS = [(13, 2, 0.25), (101, 0, 0.15), (4242, 5, 0.15)]


@pytest.mark.parametrize("seed,wl_seed,rate", CHAOS,
                         ids=[f"seed{s}" for s, _, _ in CHAOS])
def test_chaos_schedule_matches_reference_and_never_lies(seed, wl_seed,
                                                         rate):
    """Under a seeded fault schedule every request resolves to an exact
    plan equal to the fault-free answer, a certified degraded plan or a
    typed error, and the port's run equals the reference's ticket for
    ticket (statuses, costs, trees, completion times, fault counters,
    breakers, quarantine and injector)."""
    _, _, want = _chaos(REF, seed, wl_seed, rate)
    reqs, tickets, got = _chaos(PORT, seed, wl_seed, rate)
    assert got == want
    clean, _ = P.PlanServer(max_batch=8, device="cpu").serve(
        list(reqs), closed_loop=True)
    for req, t, ref in zip(reqs, tickets, clean):
        if t.status == "exact":
            if ref.status == "exact":
                assert float(t.response.cost).hex() == \
                    float(ref.cost).hex()
        elif t.status == "degraded":
            meta = t.response.meta
            assert (meta.get("best_effort") or meta.get("approx")
                    or t.response.route.method in ("goo", "approx"))
        else:
            assert t.status == "error"
            assert isinstance(t.error, faults.PlanError)


def test_chaos_replay_is_bit_identical():
    a = _chaos(PORT, 13, 2, 0.25)[2]
    assert a == _chaos(PORT, 13, 2, 0.25)[2]
    assert a[5] != _chaos(PORT, 14, 2, 0.25)[2][5]


def test_zero_fault_path_touches_no_resilience_state():
    def run(side):
        srv, clk, rt = _mk(side)
        tickets = [rt.submit(r) for r in _workload(side)]
        rt.drain()
        assert all(t.done for t in tickets)
        assert rt.fstats.as_dict() == {k: 0 for k in rt.fstats.as_dict()}
        assert not rt.breakers.lanes
        assert rt.quarantine.snapshot()["added"] == 0
        snap = rt._faults_snapshot()
        assert snap.get("injector") is None
        out = _state(rt, tickets)
        rt.close()
        return out
    _same(run)
