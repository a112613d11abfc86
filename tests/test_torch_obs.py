"""The port's observability layer (``repro_torch.obs`` and the engine's
dispatch records) against ``repro.obs``.

Histograms, registries, the Prometheus text, the tracer's head
sampling and the flight recorder are copies: the same operations must
give the same numbers and the same text.  Span trees come from both
runtimes on a ``VirtualClock`` with the same injected durations (and the
same fixed chunk timings, see ``tests/test_torch_runtime.py``), so their
``shape()``s must be equal.  The engine's dispatch records carry the
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
    assert set(d) == set(rr.as_dict())
    assert isinstance(d["key"], list)
    assert engine.stats().exec_cache_misses == 1
    assert engine.stats().exec_cache_hits == 1


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
        return (t.span.shape(), t.completed_at, d.attrs["engine_tag"],
                d.attrs["rounds"], st)
    got = _same(run)
    assert got[0] == ("request", (("admit", ()), ("queue_wait", ()),
                                  ("dispatch", ()), ("extract", ()),
                                  ("respond", ())))
    assert got[2] == "fused"


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
        return t1.span.shape(), srv.cache.stats.relabel_hits
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
        return (t_lead.span.shape(), t_follow.span.shape(),
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
        return t.span.shape(), dict(rec.counts), \
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
        return side.obs.span_phase_summary(srv.registry)
    phases = _same(run)
    assert phases["request"]["count"] >= 6
    assert phases["dispatch"]["count"] >= 1


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
    def run(side):
        srv, clk, rt = _mk(side)
        for r in _reqs(side)[:8]:
            rt.submit(r)
        rt.drain()
        snap = srv.registry.snapshot()
        prov = snap["providers"]
        assert prov["tracer"]["open_spans"] == 0
        assert any(k.startswith("trace.") for k in snap["metrics"])
        return (rt.stats.as_dict(), sorted(prov), prov["runtime"],
                prov["tracer"], prov["recorder"], prov["faults"],
                {k: v for k, v in snap["metrics"].items()
                 if k.startswith(("trace.", "runtime."))})
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
                t_conn.span.shape())
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
        for r in _reqs(side)[:12]:
            rt.submit(r)
        rt.drain()
        return rt.tracer.stats(), dict(rt.recorder.counts)
    st, counts = _same(run)
    assert st["requests"] == 12
    assert st["sampled"] == st["sampled_out"] == 6
    assert counts["completed"] == 6
