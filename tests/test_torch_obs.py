"""The port's observability layer (``repro_torch.obs`` and the engine's
dispatch records) against ``repro.obs``.

Histograms, registries, the Prometheus text, the tracer's head
sampling and the flight recorder are copies: the same operations must
give the same numbers and the same text.  Span trees come from both
runtimes on a ``VirtualClock`` with the same injected durations (and the
same fixed chunk timings, see ``tests/test_torch_runtime.py``), so their
``shape()``s must be equal once the port's own spans are taken out
(``tests/_torch_spans.py``: admit's children, ``seed``, ``lane_wait``);
the port's whole trees are pinned here, and its ``dispatch`` spans start
where the lane begins, so with ``lane_wait`` they cover the reference's
``dispatch``.  The engine's dispatch records carry the
port's own build/execute split and work count; they are held to the
reference's structure, with the labels that differ on purpose mapped
(``backend``: ``xla`` -> ``f64``; the key's device entry).  The cases
mirror ``tests/test_obs.py``, except the ``obs_tail`` ones, which wait
for the port's cluster.
"""
import json
import sys
import threading
import types

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.service as R
import repro_torch.service as P
from repro import obs as ref_obs
from repro.core import engine as ref_engine
from repro.core import querygraph as RQ
from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core import querygraph as PQ
from repro_torch.obs.metrics import BOUNDS, MetricsRegistry

from _torch_spans import PORT_SPANS, port_span_count, reference_shape

DUR = {"admit": 0.0, "solve": 1.0, "single": 0.01}
REF = types.SimpleNamespace(svc=R, obs=ref_obs, qg=RQ, kw={})
PORT = types.SimpleNamespace(svc=P, obs=obs, qg=PQ, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dur(kind, info):
    return DUR[kind]


def _server(side, **kw):
    srv = side.svc.PlanServer(**kw, **side.kw)
    observe = srv._observe_batch
    srv._observe_batch = lambda timings: observe(
        [(n, cnt, 1e-3 * cnt, eng, cost, tags)
         for n, cnt, _, eng, cost, tags in timings])
    return srv


def _mk(side, max_batch=8, **cfg_kw):
    srv = _server(side, max_batch=max_batch)
    clk = side.svc.VirtualClock()
    cfg = side.svc.RuntimeConfig(max_batch=max_batch, **cfg_kw)
    return srv, clk, srv.make_runtime(clock=clk, config=cfg,
                                      duration_fn=_dur)


def _reqs(side, **kw):
    base = dict(n_requests=24, seed=0, n_range=(6, 7), pool_size=6,
                rate=500.0)
    base.update(kw)
    return side.svc.make_workload(side.svc.WorkloadSpec(**base))


def _miss(reqs):
    return next(r for r in reqs if r.cost == "max" and r.q.n >= 6)


def _same(fn):
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


def _shape(side, span):
    """A span tree's shape in the reference's taxonomy."""
    return reference_shape(span.shape()) if side is PORT else span.shape()


def _tracer_stats(side, rt, roots):
    """The tracer's stats with the port's own spans (of the trees
    ``roots``) taken out of its open/close tallies."""
    st = dict(rt.tracer.stats())
    if side is PORT:
        k = sum(port_span_count(r) for r in roots)
        st["spans_opened"] -= k
        st["spans_closed"] -= k
    return st


def _port_tree(*phases):
    """The port's tree of a batch-lane miss served by one dispatch,
    with ``phases`` (queue_wait, coalesce...) before the seed."""
    return ("request", (("admit", (("canonicalize", ()), ("probe", ()),
                                   ("route", ()))),)
            + tuple((p, ()) for p in phases)
            + (("lane_wait", ()), ("dispatch", ()), ("extract", ()),
               ("respond", ())))


# ------------------------------------------------------------ histograms
def _histogram_script(mod, case):
    h = mod.Histogram("t")
    vals = {"empty": [], "single": [0.5], "overflow": [5e4] * 100,
            "underflow": [1e-12, 0.0],
            "ordering": [1e-4] * 90 + [1e-1] * 9 + [10.0]}[case]
    for v in vals:
        h.observe(v)
    return (h.summary(), h.count, h.overflow, h.max, h.sum,
            [h.percentile(p) for p in (50, 95, 99)])


@pytest.mark.parametrize("case", ["empty", "single", "overflow",
                                  "underflow", "ordering"])
def test_histogram_matches_reference(case):
    from repro.obs import metrics as ref_metrics
    from repro_torch.obs import metrics
    got = _histogram_script(metrics, case)
    assert got == _histogram_script(ref_metrics, case)
    summary, count, overflow, hmax, hsum, pcts = got
    if case == "empty":
        assert summary["count"] == 0 and pcts == [0.0, 0.0, 0.0]
    elif case == "single":
        assert 0.5 <= summary["p50"] <= 0.5 * 10 ** 0.25 * 1.001
    elif case == "overflow":
        assert overflow == 100 and pcts[0] == pcts[2] == hmax == 5e4
    elif case == "underflow":
        assert count == 2 and pcts[0] <= BOUNDS[0]
    else:
        assert pcts[0] < pcts[1] <= pcts[2]
        assert abs(hsum - (90 * 1e-4 + 9 * 1e-1 + 10.0)) < 1e-9


# -------------------------------------------------------------- registry
def test_registry_name_type_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.histogram("x")


def test_registry_thread_safety_under_contention():
    reg = MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h")

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(1e-3)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value == 16000 and h.count == 16000


def test_prometheus_and_snapshot_text_match_reference():
    def run(mod):
        reg = mod.MetricsRegistry()
        reg.counter("engine.dispatches").inc(3)
        reg.gauge("runtime.queue").set(2.5)
        for v in (0.01, 0.2, 3.0, 5e4):
            reg.histogram("trace.dispatch_s").observe(v)
        reg.register_provider("p", lambda: {"a": 1})
        return (mod.prometheus(reg), json.dumps(mod.registry_snapshot(reg),
                                                sort_keys=True))
    text, snap = run(obs)
    assert (text, snap) == run(ref_obs)
    assert "# TYPE engine_dispatches counter" in text
    assert "engine_dispatches 3" in text and 'le="+Inf"' in text
    assert "trace_dispatch_s_count 4" in text


# --------------------------------------------------------- engine records
def test_engine_stats_registry_backed_and_reset():
    engine.reset_stats()
    st = engine.stats()
    d = st.as_dict()
    assert set(d) == set(engine.EngineStats.FIELDS)
    assert set(ref_engine.EngineStats.FIELDS) <= set(d)
    assert all(v == 0 for v in d.values())
    st.inc("dispatches", 2)
    assert st.dispatches == 2
    engine.reset_stats()
    assert engine.stats().dispatches == 0


def _dispatch_pair(eng, cards, **kw):
    eng.reset_stats()
    eng.clear_executable_cache()
    mark = eng.dispatch_mark()
    fs = eng.fused_dpconv_max(cards, 6, **kw)
    (r,) = eng.dispatches_since(mark)
    mark = eng.dispatch_mark()
    eng.fused_dpconv_max(cards, 6, **kw)
    (r2,) = eng.dispatches_since(mark)
    return fs, r, r2


def test_engine_dispatch_records_compile_execute_split():
    """One record per solve: a miss builds (``compile_s`` > 0, no cache
    hit), a repeat hits with no build charged; ``execute_s`` is timed to
    a finished result; ``flops``/``bytes_accessed`` are the port's own
    positive count; the rest equals the reference's record."""
    q = PQ.chain(6)
    cards = np.asarray(PQ.make_cardinalities(q, seed=3), np.float64)[None]
    fs, r, r2 = _dispatch_pair(engine, cards, device="cpu")
    rfs, rr, rr2 = _dispatch_pair(ref_engine, cards)
    assert not r.aot_cache_hit and r.compile_s > 0
    assert r.execute_s > 0 and r.rounds == fs.rounds == rfs.rounds
    assert r.flops > 0 and r.bytes_accessed > 0
    assert r2.aot_cache_hit and r2.compile_s == 0.0
    assert (r2.flops, r2.bytes_accessed) == (r.flops, r.bytes_accessed)
    assert r2.seq == r.seq + 1
    for got, want in ((r, rr), (r2, rr2)):
        assert (got.cost, got.n, got.B, got.C, got.aot_cache_hit,
                got.rounds, got.shards, got.lane) == \
            (want.cost, want.n, want.B, want.C, want.aot_cache_hit,
             want.rounds, want.shards, want.lane)
        assert got.backend == {"xla": "f64"}[want.backend]
        # key: (n, B, C, tier, direct_layers, extract, cost, G) + device;
        # the reference adds its shard count before the device identity
        assert got.key[:3] == want.key[:3]
        assert got.key[3] == {"xla": "f64"}[want.key[3]]
        assert got.key[4:8] == want.key[4:8]
        assert got.key[8] == "cpu" == got.devices[0]
        assert want.key[9][0] == "cpu"
    d = r.as_dict()
    assert set(d) == set(rr.as_dict()) | HOST_SPLIT
    assert isinstance(d["key"], list)
    assert engine.stats().exec_cache_misses == 1
    assert engine.stats().exec_cache_hits == 1


# the port's split of a record's host time, whether its call replayed
# CUDA graphs, and its (min,+) sweep's live and total sets and valid
# splits, beyond the reference's fields
HOST_SPLIT = {"queries", "prepare_s", "launch_s", "sync_s", "readback_s",
              "trees_s", "t0_ns", "t1_ns", "graphed", "sweep_sets",
              "sweep_total", "sweep_pairs"}


@pytest.mark.parametrize("cost", ["max", "cap", "out"])
def test_dispatch_record_splits_host_time(cost):
    """``launch_s + sync_s`` is ``execute_s``; ``queries`` is the real
    row count under a padded ``B``; the search's loop reads are blocked
    time; prep, readback and trees are timed around the call, and
    ``t0_ns``/``t1_ns`` bound it on ``time.time_ns()``'s clock."""
    import time
    qs = [PQ.chain(6), PQ.cycle(6), PQ.star(6)]
    cards = np.stack([np.asarray(PQ.make_cardinalities(q, seed=i),
                                 np.float64) for i, q in enumerate(qs)])
    call = {"max": lambda: engine.fused_dpconv_max(cards, 6, device="cpu"),
            "cap": lambda: engine.fused_ccap(cards, 6, device="cpu"),
            "out": lambda: engine.fused_out(qs, cards, 6, device="cpu")}
    call[cost]()                       # build the bucket
    mark = engine.dispatch_mark()
    t0 = time.time_ns()
    call[cost]()
    t1 = time.time_ns()
    (r,) = engine.dispatches_since(mark)
    assert (r.queries, r.B) == (3, 4)
    assert r.aot_cache_hit and r.compile_s == 0.0
    assert r.launch_s + r.sync_s == pytest.approx(r.execute_s, abs=1e-12)
    assert r.launch_s > 0 and r.sync_s >= 0
    if cost != "out":                  # the search reads its condition
        assert r.sync_s > 0
    assert r.prepare_s > 0 and r.readback_s > 0 and r.trees_s > 0
    assert t0 <= r.t0_ns < r.t1_ns <= t1
    assert r.execute_s * 1e9 <= r.t1_ns - r.t0_ns + 1e6


def test_engine_keeps_no_dispatch_histograms():
    """The ring is the one record of a dispatch: the engine registry
    holds its counters and nothing per dispatch or per lane."""
    q = PQ.chain(6)
    cards = np.asarray(PQ.make_cardinalities(q, seed=3), np.float64)[None]
    with engine.dispatch_lane(3):
        engine.fused_dpconv_max(cards, 6, device="cpu")
    names = {m.name for m in engine.stats().registry.metrics()}
    assert names == {"engine." + f for f in engine.EngineStats.FIELDS}


def test_program_work_counts_rounds_and_shapes():
    """The work count grows with the search rounds and the batch, and
    the out program (no search) counts its sweep and extraction."""
    w = engine.program_work
    a = w(10, 4, 1024, "max", "cuda", 1, 5, True)
    assert a[0] > 0 and a[1] > 0
    assert w(10, 4, 1024, "max", "cuda", 1, 6, True)[0] > a[0]
    assert w(10, 8, 1024, "max", "cuda", 1, 5, True)[1] > a[1]
    assert w(10, 4, 1024, "max", "f64", 1, 5, True)[1] > a[1]
    out = w(10, 4, 0, "out", "f64", 1, 0, True)
    assert out[0] > 0 and out[1] > 0
    assert w(10, 4, 1024, "cap_conn", "f64", 1, 5, True)[0] > \
        w(10, 4, 1024, "cap", "f64", 1, 5, True)[0]


def test_dispatch_lane_is_thread_local_and_nests():
    seen = {}

    def worker(k):
        with engine.dispatch_lane(k):
            with engine.dispatch_lane(k + 10):
                seen[(k, "inner")] = engine.current_lane()
            seen[(k, "outer")] = engine.current_lane()

    threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert seen == {(1, "inner"): 11, (1, "outer"): 1, (2, "inner"): 12,
                    (2, "outer"): 2}
    assert engine.current_lane() is None


def test_build_lock_builds_a_bucket_once_under_threads():
    """Lanes missing the same bucket at once build it once: one miss,
    one compile-fault hook call, and every solve equal."""
    engine.clear_executable_cache()
    engine.reset_stats()
    calls = []
    engine.set_compile_fault_hook(lambda **kw: calls.append(kw))
    cards = np.asarray(PQ.make_cardinalities(PQ.clique(7), seed=1),
                       np.float64)[None]
    results = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: results.append(
            engine.fused_dpconv_max(cards, 7, device="cpu").optima[0]))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        engine.set_compile_fault_hook(None)
    assert calls == [{"n": 7, "B": 1, "C": engine.candidate_bucket(7),
                      "backend": "f64", "cost": "max"}]
    assert engine.stats().exec_cache_misses == 1
    assert engine.stats().exec_cache_hits == 7
    assert len(results) == 8 and len({float(v).hex() for v in results}) == 1


# ----------------------------------------------------------- span trees
def test_deterministic_span_tree_batch_miss():
    trees = {}

    def run(side):
        srv, clk, rt = _mk(side)
        t = rt.submit(_miss(_reqs(side)))
        rt.drain()
        d = t.span.find("dispatch")
        assert d.attrs["duration_s"] == 1.0 and d.attrs["items"] == 1
        assert d.attrs["dispatches"] == 1 and d.attrs["execute_s"] > 0
        assert d.attrs["flops"] > 0 and d.attrs["bytes_accessed"] > 0
        assert t.span.t0 == 0.0 and t.span.t1 == t.completed_at
        st = rt.tracer.stats()
        assert st["unclosed_spans"] == st["open_spans"] == \
            st["lane_shape_mismatches"] == 0
        trees[side is PORT] = t.span
        return (_shape(side, t.span), t.completed_at, d.attrs["engine_tag"],
                d.attrs["rounds"], _tracer_stats(side, rt, [t.span]))
    got = _same(run)
    assert got[0] == ("request", (("admit", ()), ("queue_wait", ()),
                                  ("dispatch", ()), ("extract", ()),
                                  ("respond", ())))
    assert got[2] == "fused"
    port = trees[True]
    assert port.shape() == _port_tree("queue_wait", "seed")
    # the lane was idle: no lane wait, and the dispatch is the solve
    lw, d = port.find("lane_wait"), port.find("dispatch")
    assert lw.duration == 0.0 and d.t0 == lw.t1 and d.duration == 1.0
    assert d.duration + lw.duration == trees[False].find("dispatch").duration


def test_fast_path_span_tree_and_relabel_hit():
    def run(side):
        srv, clk, rt = _mk(side)
        base = _miss(_reqs(side))
        rt.submit(base)
        rt.drain()
        perm = np.random.default_rng(7).permutation(base.q.n)
        t1 = rt.submit(side.svc.PlanRequest(
            q=side.qg.relabel(base.q, perm),
            card=side.qg.permute_card(base.card, base.q.n, perm),
            cost=base.cost, req_id="relabeled"))
        assert t1.done and t1.response.cache_hit
        if side is PORT:
            assert t1.span.shape() == (
                "request", (("admit", (("canonicalize", ()),
                                       ("probe", ()))),
                            ("fast_path", ()), ("respond", ())))
        return _shape(side, t1.span), srv.cache.stats.relabel_hits
    got = _same(run)
    assert got[0] == ("request", (("admit", ()), ("fast_path", ()),
                                  ("respond", ())))
    assert got[1] >= 1


def test_coalesced_follower_span_tree():
    def run(side):
        srv, clk, rt = _mk(side)
        miss = _miss(_reqs(side))
        t_lead, t_follow = rt.submit(miss), rt.submit(miss)
        rt.drain()
        assert rt.stats.coalesced == 1
        assert t_lead.span.find("coalesce") is None
        if side is PORT:
            # the seed is probed once, for the leader's solve
            assert t_lead.span.shape() == _port_tree("queue_wait", "seed")
            assert t_follow.span.shape() == _port_tree("coalesce",
                                                       "queue_wait")
        return (_shape(side, t_lead.span), _shape(side, t_follow.span),
                t_follow.response.meta.get("coalesced"),
                rt.tracer.stats()["lane_shape_mismatches"])
    got = _same(run)
    assert got[1] == ("request", (("admit", ()), ("coalesce", ()),
                                  ("queue_wait", ()), ("dispatch", ()),
                                  ("extract", ()), ("respond", ())))
    assert got[2:] == (True, 0)


def test_shed_span_tree_and_recorder_capture():
    def run(side):
        srv = _server(side)
        cfg = side.svc.RuntimeConfig(slo_classes={
            "strict": side.svc.SLOClass("strict", 1e-9, "refuse")})
        rt = srv.make_runtime(clock=side.svc.VirtualClock(), config=cfg,
                              duration_fn=_dur)
        miss = _miss(_reqs(side))
        t = rt.submit(miss.__class__(**{**miss.__dict__,
                                        "slo": "strict"}))
        assert t.refused
        rec = rt.recorder
        assert rec.incidents[0]["span"] is t.span
        parsed = [json.loads(ln) for ln in rec.dump_jsonl()]
        if side is PORT:
            # refused in the routing ladder: route closes with admit
            assert t.span.shape() == (
                "request", (("admit", (("canonicalize", ()),
                                       ("probe", ()), ("route", ()))),
                            ("shed", ())))
            assert rt.tracer.stats()["lane_shape_mismatches"] == 0
        return _shape(side, t.span), dict(rec.counts), \
            [{k: v for k, v in p.items() if k != "span"} for p in parsed]
    got = _same(run)
    assert got[0] == ("request", (("admit", ()), ("shed", ())))
    assert got[1]["shed"] == 1


def test_tracer_disabled_is_null_and_costless():
    def run(side):
        srv, clk, rt = _mk(side, trace=False)
        t = rt.submit(_reqs(side)[0])
        rt.drain()
        assert t.span is side.obs.NULL_SPAN
        return rt.tracer.stats(), dict(rt.recorder.counts)
    got = _same(run)
    assert got[0]["requests"] == got[0]["spans_opened"] == 0
    assert got[1]["completed"] == 0


def test_unclosed_span_forced_and_counted():
    def run(side):
        tr = side.obs.Tracer(side.svc.VirtualClock(),
                             registry=side.obs.MetricsRegistry())
        root = tr.request()
        root.child("dispatch")               # never closed
        tr.finish(root, expected_spans=2)
        return tr.unclosed_spans, tr.shape_mismatches, tr.stats()
    assert _same(run)[:2] == (1, 0)


def test_span_phase_summary_reads_trace_histograms():
    def run(side):
        srv, clk, rt = _mk(side)
        for r in _reqs(side)[:6]:
            rt.submit(r)
        rt.drain()
        return side.obs.span_phase_summary(
            srv.registry, phases=("admit", "queue_wait", "coalesce",
                                  "fast_path", "dispatch", "extract",
                                  "respond", "request", "lane_wait"))
    want, phases = run(REF), run(PORT)
    # the reference's dispatch is the port's lane_wait and dispatch
    d, lw = phases.pop("dispatch"), phases.pop("lane_wait")
    ref_d = want.pop("dispatch")
    assert phases == want
    assert d["count"] == lw["count"] == ref_d["count"]
    assert d["mean_ms"] + lw["mean_ms"] == pytest.approx(ref_d["mean_ms"],
                                                         rel=1e-12)
    assert phases["request"]["count"] >= 6
    assert d["count"] >= 1


def test_recorder_ring_bounded_incident_counts_exact():
    def run(side):
        rec = side.obs.FlightRecorder(capacity=4, incident_capacity=8)
        tr = side.obs.Tracer(side.svc.VirtualClock(), recorder=rec)
        for _ in range(10):
            tr.finish(tr.request())
        for i in range(20):
            rec.incident("deadline_miss", None, req_id=str(i))
        return len(rec.ring), len(rec.incidents), dict(rec.counts), \
            rec.dump_jsonl()
    got = _same(run)
    assert got[:2] == (4, 8)
    assert got[2]["completed"] == 10 and got[2]["deadline_miss"] == 20


# --------------------------------------------------- runtime stats schema
def test_runtime_stats_and_registry_snapshot_match_reference():
    port_hists = {f"trace.{name}_s" for name in PORT_SPANS}

    def run(side):
        srv, clk, rt = _mk(side)
        tickets = [rt.submit(r) for r in _reqs(side)[:8]]
        rt.drain()
        snap = srv.registry.snapshot()
        prov = snap["providers"]
        assert prov["tracer"]["open_spans"] == 0
        assert any(k.startswith("trace.") for k in snap["metrics"])
        metrics = {k: v for k, v in snap["metrics"].items()
                   if k.startswith(("trace.", "runtime."))}
        if side is PORT:
            assert port_hists <= set(metrics)
            assert prov["tracer"]["lane_shape_mismatches"] == 0
        # the reference's dispatch is the port's lane_wait and dispatch:
        # the same count, other durations
        metrics = {k: (v["count"] if k == "trace.dispatch_s" else v)
                   for k, v in metrics.items() if k not in port_hists}
        provs = sorted(prov)
        if side is PORT:
            # the port's own canonicalization counters
            assert prov["canon"]["forms"] >= 1
            provs.remove("canon")
        return (rt.stats.as_dict(), provs, prov["runtime"],
                _tracer_stats(side, rt, [t.span for t in tickets]),
                prov["recorder"], prov["faults"], metrics)
    got = _same(run)
    assert set(got[0]) == {
        "submitted", "served", "fast_path_hits", "overtakes",
        "coalesced", "coalesce_rate", "downgraded", "shed",
        "shed_backpressure", "shed_rate", "batches",
        "mean_batch_occupancy", "steals", "hedges", "lanes",
        "deadline_misses", "solve_s", "miss_solve_ms_mean",
        "hit_p99_ms", "per_class"}
    assert {"cache", "router", "serve", "solver", "engine", "runtime",
            "tracer", "recorder"} <= set(got[1])


# ------------------------------------------------ explain + connected cap
def test_explain_provenance_on_miss_and_hit():
    def run(side):
        srv = _server(side)
        r = _miss(_reqs(side))
        miss = srv.plan_one(r.q, r.card, cost="max", explain=True)
        hit = srv.plan_one(r.q, r.card, cost="max", explain=True)
        return miss.explain, hit.explain
    miss, hit = _same(run)
    assert {"lane", "method", "lane_cost", "engine_tag", "cache_key",
            "cache_hit"} <= set(miss)
    assert miss["cache_hit"] is False and hit["cache_hit"] is True


def test_connected_cap_runtime_bucket_separation():
    def run(side):
        srv, clk, rt = _mk(side)
        q = side.qg.chain(7)
        card = side.qg.make_cardinalities(q, seed=6)
        t_plain = rt.submit(side.svc.PlanRequest(q=q, card=card,
                                                 cost="cap", req_id="p"))
        t_conn = rt.submit(side.svc.PlanRequest(q=q, card=card, cost="cap",
                                                connected=True,
                                                req_id="c"))
        keys = sorted(rt._buckets)
        rt.drain()
        assert rt.stats.coalesced == 0
        return (keys, float(t_plain.response.cost).hex(),
                float(t_conn.response.cost).hex(),
                t_conn.span.find("dispatch").attrs["engine_tag"],
                _shape(side, t_conn.span))
    got = _same(run)
    assert got[0] == [(7, "cap"), (7, "cap_conn")]
    assert float.fromhex(got[2]) >= float.fromhex(got[1])
    assert got[3].endswith("cap_conn")


# ---------------------------------------------- head sampling (tracer)
def test_tracer_sample_rate_validation():
    with pytest.raises(ValueError):
        obs.Tracer(P.VirtualClock(), sample_rate=1.5)
    with pytest.raises(ValueError):
        obs.Tracer(P.VirtualClock(), sample_rate=-0.1)


@pytest.mark.parametrize("rate,n", [(0.25, 100), (1.0, 20), (0.0, 20)])
def test_tracer_head_sampling_deterministic_even_spread(rate, n):
    def run(side):
        tr = side.obs.Tracer(side.svc.VirtualClock(), sample_rate=rate)
        picks = []
        for _ in range(n):
            root = tr.request()
            picks.append(root is not side.obs.NULL_SPAN)
            tr.finish(root)
        return picks, tr.stats()
    picks, st = _same(run)
    assert sum(picks) == int(n * rate) == st["sampled"]
    assert st["sampled_out"] == n - sum(picks)
    assert st["open_spans"] == st["unclosed_spans"] == 0


def test_runtime_sampling_keeps_incident_capture_unconditional():
    def run(side):
        srv = _server(side)
        cfg = side.svc.RuntimeConfig(trace_sample=0.0, slo_classes={
            "strict": side.svc.SLOClass("strict", 1e-9, "refuse")})
        rt = srv.make_runtime(clock=side.svc.VirtualClock(), config=cfg,
                              duration_fn=_dur)
        shed = 0
        for r in _reqs(side)[:8]:
            t = rt.submit(r.__class__(**{**r.__dict__, "slo": "strict"}))
            shed += t.refused
            assert t.span is side.obs.NULL_SPAN
        rt.drain()
        assert all(i["span"] is None and i["info"]
                   for i in rt.recorder.incidents)
        return shed, rt.tracer.stats(), dict(rt.recorder.counts)
    shed, st, counts = _same(run)
    assert shed > 0 and counts["shed"] == shed
    assert st["sampled"] == st["spans_opened"] == 0
    assert st["sampled_out"] == 8


def test_runtime_sampling_traces_exact_fraction():
    def run(side):
        srv, clk, rt = _mk(side, trace_sample=0.5)
        tickets = [rt.submit(r) for r in _reqs(side)[:12]]
        rt.drain()
        return (_tracer_stats(side, rt, [t.span for t in tickets]),
                dict(rt.recorder.counts))
    st, counts = _same(run)
    assert st["requests"] == 12
    assert st["sampled"] == st["sampled_out"] == 6
    assert counts["completed"] == 6


# ------------------------------------- the port's own spans and span log
def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def span_log(monkeypatch):
    """A fresh process-wide span log for one test."""
    from repro_torch.obs import trace
    log = trace.SpanLog()
    monkeypatch.setattr(trace, "SPAN_LOG", log)
    return log


def test_span_log_lies_over_the_profiler_trace(span_log):
    """A span closed around a torch op under a CPU profiler session holds
    the op's kineto interval: the log's clock is the profiler's.  Without
    a session nothing is logged, and a virtual clock logs nothing."""
    from repro_torch.obs import trace
    x = torch.ones(1 << 16, dtype=torch.float64)
    tr = obs.Tracer(P.WallClock())
    root = tr.request(req_id="r1")
    sp = root.child("op")
    torch.add(x, x)
    sp.close()
    assert not trace.profiling() and len(span_log.entries) == 0
    virtual = obs.Tracer(P.VirtualClock()).request(req_id="v")
    with _profile() as prof:
        assert trace.profiling()
        sp = root.child("op")
        torch.add(x, x)
        sp.close()
        virtual.child("op").close()
    assert not trace.profiling()
    (entry,) = span_log.entries
    name, req, parent, t0, t1, thread = entry
    assert (name, req, parent) == ("op", "r1", "request")
    assert thread == threading.current_thread().name
    adds = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add"]
    assert adds and all(t0 <= a and b <= t1 for a, b in adds)
    assert span_log.dropped == 0


def test_inline_lane_wait_models_the_busy_lane():
    """Two buckets on one lane of the inline executor: the first starts
    on an idle lane (no wait), the second waits out the first's modeled
    solve (1 s), and each dispatch starts where its lane_wait ends."""
    srv, clk, rt = _mk(PORT)
    a, b = PQ.chain(6), PQ.chain(7)
    ta = rt.submit(P.PlanRequest(q=a, card=PQ.make_cardinalities(a, seed=1),
                                 req_id="a"))
    tb = rt.submit(P.PlanRequest(q=b, card=PQ.make_cardinalities(b, seed=2),
                                 req_id="b"))
    rt.flush()
    rt.drain()
    waits = []
    for t in (ta, tb):
        lw, d = t.span.find("lane_wait"), t.span.find("dispatch")
        assert d.t0 == lw.t1 and d.duration == 1.0
        assert t.span.shape() == _port_tree("queue_wait", "seed")
        waits.append(lw.duration)
    assert waits == [0.0, 1.0]
    assert (ta.completed_at, tb.completed_at) == (1.0, 2.0)
    assert rt.tracer.stats()["lane_shape_mismatches"] == 0


def test_thread_lane_wait_ends_where_the_lane_begins(span_log):
    """On the worker-thread executor the lane only stamps when it begins
    a work; the driving thread closes lane_wait there and opens dispatch
    there.  Under a profiler session the log holds every span, closed
    on the driving thread."""
    import time
    srv = _server(PORT, max_batch=4)
    rt = srv.make_runtime(clock=P.WallClock(),
                          config=P.RuntimeConfig(max_batch=4, max_wait=0.0),
                          executor="thread")
    try:
        with _profile():
            ts = [rt.submit(r) for r in _reqs(PORT, n_requests=6,
                                              pool_size=6)]
            deadline = time.monotonic() + 120
            while not all(t.done for t in ts) \
                    and time.monotonic() < deadline:
                rt.poll()
                time.sleep(1e-3)
    finally:
        rt.close()
    assert all(t.done and not t.refused for t in ts)
    st = rt.tracer.stats()
    assert st["lane_shape_mismatches"] == st["unclosed_spans"] == 0
    threads = {e[5] for e in span_log.entries}
    assert threads == {threading.current_thread().name}
    for t in ts:
        lw = t.span.find("lane_wait")
        if lw is None:                        # a cache hit
            continue
        d = t.span.find("dispatch")
        assert lw.t0 <= lw.t1 == d.t0 <= d.t1
        mine = [e for e in span_log.entries if e[1] == t.request.req_id]
        assert {e[0] for e in mine} >= {"admit", "lane_wait", "dispatch",
                                        "request"}


def test_plan_one_tree_under_a_profiler_session(span_log):
    """``plan_one`` logs the runtime's names under one request id of its
    own while a session is active, and nothing without one: a miss is
    admit {canonicalize, probe, route}, seed, dispatch (holding the
    engine's program call), extract, respond; a hit is admit
    {canonicalize, probe}, fast_path, respond."""
    srv = _server(PORT)
    q = PQ.clique(7)
    card = PQ.make_cardinalities(q, seed=5)
    srv.plan_one(PQ.chain(6), PQ.make_cardinalities(PQ.chain(6), seed=1))
    assert len(span_log.entries) == 0
    mark = engine.dispatch_mark()
    with _profile():
        miss = srv.plan_one(q, card)
        hit = srv.plan_one(q, card)
    assert not miss.cache_hit and hit.cache_hit
    by_req: dict = {}
    for e in span_log.entries:
        by_req.setdefault(e[1], []).append(e)
    assert len(by_req) == 2
    first, second = sorted(by_req.values(), key=lambda es: es[0][3])

    def tree(es):
        return sorted((e[0], e[2]) for e in es)
    assert tree(first) == sorted([
        ("canonicalize", "admit"), ("probe", "admit"), ("route", "admit"),
        ("admit", "request"), ("seed", "request"), ("dispatch", "request"),
        ("extract", "request"), ("respond", "request"), ("request", None)])
    assert tree(second) == sorted([
        ("canonicalize", "admit"), ("probe", "admit"),
        ("admit", "request"), ("fast_path", "request"),
        ("respond", "request"), ("request", None)])
    span = {e[0]: e for e in first}
    for name, e in span.items():
        assert span["request"][3] <= e[3] <= e[4] <= span["request"][4]
        if e[2] == "admit":
            assert span["admit"][3] <= e[3] <= e[4] <= span["admit"][4]
    order = ["admit", "seed", "dispatch", "extract", "respond"]
    assert [span[n][3] for n in order] == sorted(span[n][3] for n in order)
    (rec,) = engine.dispatches_since(mark)
    assert span["dispatch"][3] <= rec.t0_ns < rec.t1_ns \
        <= span["dispatch"][4]


def test_span_log_bound_under_contending_threads():
    """Threads appending at once (a runtime's event loop, plan_one callers)
    lose no count: what the log holds plus what it dropped is what was
    appended, and a window over the drops reads None."""
    from repro_torch.obs import trace
    log = trace.SpanLog(capacity=64)
    per, nthreads = 500, 12
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                t = k * per + i
                log.append("x", k, "request", t, t + 1, thread=str(k))
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert len(log.entries) == 64
    assert log.dropped == nthreads * per - 64
    assert log.window(0, 1 << 40) is None
    assert log.window(log.last_dropped_ns + 1, 1 << 40) is not None
