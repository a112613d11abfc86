"""The port's replica cluster (``service.cluster``) against ``repro``'s.

Each loopback case of ``tests/test_cluster.py`` runs on both packages:
``repro.service`` and ``repro_torch.service`` (``device="cpu"``), n
replicas on one shared ``VirtualClock`` with the same injected
``duration_fn`` and the same seeded ``FaultPlan``.  Every answer must
then be bitwise the reference's (``float.hex`` cost, ``repr`` tree,
status, cache hit, route, virtual-clock latency), and so must the
client's counters, the transport's call count, the dead sets, the clock
and each replica's cache counters.  The ring hashes keys to the same
owners in both packages.  A two-replica TCP cluster of spawned
processes on the CPU plans, prewarms its peer from replica 0's manifest
and dumps its flight recorders, which ``scripts/obs_tail.py`` merges.
"""
import importlib.util
import json
import os
import types

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.service as R
import repro_torch.service as P
from repro.core import querygraph as RQ
from repro.service import net as ref_net
from repro_torch import obs
from repro_torch.core import querygraph as PQ
from repro_torch.service import net as net_mod

REF = types.SimpleNamespace(svc=R, qg=RQ, net=ref_net, kw={})
PORT = types.SimpleNamespace(svc=P, qg=PQ, net=net_mod,
                             kw={"device": "cpu"})
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _host_server(side):
    return side.svc.PlanServer(
        enable_batch=False,
        batch_policy=side.svc.BatchPolicy(engine="host"), **side.kw)


def _loopback(side, n=3, plan=None, **cfg_kw):
    """n loopback replicas on one shared VirtualClock."""
    clk = side.svc.VirtualClock()
    states = {}
    for i in range(n):
        srv = _host_server(side)
        rt = srv.make_runtime(
            clock=clk, config=side.svc.RuntimeConfig(max_batch=1, **cfg_kw),
            duration_fn=lambda kind, info: 1e-3)
        states[f"r{i}"] = side.svc.ReplicaState(srv, replica_id=f"r{i}",
                                                runtime=rt)
    injector = None if plan is None else side.svc.FaultInjector(plan)
    transport = side.svc.LoopbackTransport(states, clock=clk,
                                           injector=injector)
    client = side.svc.ClusterClient(transport, sorted(states))
    return clk, states, transport, client


def _query(side, seed=0, n=6, topo="chain"):
    q = getattr(side.qg, topo)(n)
    return q, side.qg.make_cardinalities(q, seed=seed)


def _isomorph(side, q, card, seed=0):
    p = [int(x) for x in np.random.default_rng(seed).permutation(q.n)]
    return side.qg.relabel(q, p), side.qg.permute_card(
        np.asarray(card, np.float64), q.n, p)


def _resp(r):
    route = None if r.route is None else (r.route.cost, r.route.method,
                                          r.route.lane, r.route.params)
    return (r.req_id, float(r.cost).hex(), repr(r.tree), r.status,
            r.cache_hit, route, r.latency,
            None if r.error is None else type(r.error).__name__)


def _cluster_state(clk, states, transport, client):
    return {"clock": clk.now(), "calls": transport.calls,
            "dead": sorted(transport.dead),
            "client": client.snapshot(),
            "caches": {rid: s.server.cache.stats.as_dict()
                       for rid, s in states.items()}}


def _both(fn):
    """``fn(side)`` on the reference and on the port; assert the results
    are equal and return the port's."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


def _owner(client, side, q, card):
    return client.ring.owner(side.svc.canonicalize(q, card).key)


# ------------------------------------------------------------- hash ring
@pytest.mark.parametrize("replicas,vnodes", [(2, 64), (4, 64), (5, 32)])
def test_ring_equals_reference(replicas, vnodes):
    ids = [f"r{i}" for i in range(replicas)]
    a, b = P.HashRing(ids, vnodes=vnodes), R.HashRing(ids, vnodes=vnodes)
    keys = [f"key-{i}" for i in range(200)]
    assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]
    assert [a.successors(k) for k in keys[:20]] == \
        [b.successors(k) for k in keys[:20]]
    assert set(a.owner(k) for k in keys) == set(ids)
    for k in keys[:5]:
        order = a.successors(k)
        assert order[0] == a.owner(k) and sorted(order) == sorted(ids)


def test_ring_rejects_empty_and_isomorphs_colocate():
    with pytest.raises(ValueError):
        P.HashRing([])
    ring = P.HashRing([f"r{i}" for i in range(4)])
    q, card = _query(PORT, seed=3, n=7, topo="star")
    q2, card2 = _isomorph(PORT, q, card, seed=9)
    k1 = P.canonicalize(q, card).key
    k2 = P.canonicalize(q2, card2).key
    assert k1 == k2 and ring.owner(k1) == ring.owner(k2)
    rq, rcard = _query(REF, seed=3, n=7, topo="star")
    assert R.canonicalize(rq, rcard).key == k1


# --------------------------------------------------------- loopback e2e
def test_loopback_plan_parity_and_owner_affinity_hit():
    def run(side):
        lb = _loopback(side, 3)
        client, states = lb[3], lb[1]
        q, card = _query(side, seed=1)
        resp = client.plan(q, card, cost="max", req_id=1)
        again = client.plan(q, card, cost="max", req_id=2)
        ref = _host_server(side).plan_one(q, card, cost="max")
        assert resp.status == "exact" and not resp.cache_hit
        assert again.cache_hit
        assert float(again.cost).hex() == float(ref.cost).hex()
        assert str(resp.tree) == str(ref.tree)
        owner = _owner(client, side, q, card)
        assert states[owner].server.cache.stats.hits >= 1
        return [_resp(resp), _resp(again)], _cluster_state(*lb)
    _both(run)


def test_shared_cache_publish_then_cluster_wide_isomorph_hit():
    def run(side):
        lb = _loopback(side, 3)
        clk, states, transport, client = lb
        q, card = _query(side, seed=2, n=7)
        owner = _owner(client, side, q, card)
        spread = side.svc.ClusterClient(transport, sorted(states),
                                        affinity=False)
        resp = spread.plan(q, card, cost="max", req_id=1)
        assert resp.status == "exact" and spread.stats["publishes"] == 1
        assert states[owner].server.cache.stats.remote_inserts == 1
        q2, card2 = _isomorph(side, q, card, seed=5)
        hit = client.plan(q2, card2, cost="max", req_id=2)
        assert hit.cache_hit and hit.status == "exact"
        assert states[owner].server.cache.stats.cross_hits >= 1
        ref = _host_server(side).plan_one(q2, card2, cost="max")
        assert float(hit.cost).hex() == float(ref.cost).hex()
        assert hit.tree == ref.tree
        return [_resp(resp), _resp(hit)], spread.snapshot(), \
            _cluster_state(*lb)
    _both(run)


def test_partition_failover_recovers_exact():
    def run(side):
        plan = side.svc.FaultPlan(seed=3, specs=(
            side.svc.FaultSpec("net", "raise", rate=1.0, max_fires=1),))
        lb = _loopback(side, 3, plan=plan)
        client = lb[3]
        q, card = _query(side, seed=4)
        resp = client.plan(q, card, cost="max", req_id=1)
        assert resp.status == "exact"
        assert client.stats["net_errors"] == client.stats["failovers"] == 1
        assert client.stats["replica_deaths"] == 0 and not client.dead
        return _resp(resp), _cluster_state(*lb)
    _both(run)


def test_replica_death_midflight_failover_and_avoidance():
    def run(side):
        plan = side.svc.FaultPlan(seed=5, specs=(
            side.svc.FaultSpec("replica", "raise", rate=1.0, max_fires=1),))
        lb = _loopback(side, 3, plan=plan)
        clk, states, transport, client = lb
        q, card = _query(side, seed=6)
        owner = _owner(client, side, q, card)
        resp = client.plan(q, card, cost="max", req_id=1)
        assert resp.status == "exact"
        assert client.dead == {owner} and transport.dead == {owner}
        calls = transport.calls
        again = client.plan(q, card, cost="max", req_id=2)
        assert again.cache_hit and transport.calls == calls + 1
        return [_resp(resp), _resp(again)], _cluster_state(*lb)
    _both(run)


def test_slow_replica_hang_counts_hedge_and_charges_clock():
    def run(side):
        plan = side.svc.FaultPlan(seed=7, specs=(
            side.svc.FaultSpec("net", "hang", rate=1.0, max_fires=1,
                               hang_s=0.5),))
        lb = _loopback(side, 3, plan=plan)
        clk, states, transport, client = lb
        t0 = clk.now()
        q, card = _query(side, seed=8)
        resp = client.plan(q, card, cost="max", req_id=1)
        assert resp.status == "exact"
        assert client.stats["hedges"] == 1 and client.stats["failovers"] == 0
        assert clk.now() >= t0 + 0.5
        hung = client.ring.successors(
            side.svc.canonicalize(q, card).key)[0]
        assert states[hung].server.cache.stats.misses >= 1
        return _resp(resp), _cluster_state(*lb)
    _both(run)


def test_all_replicas_dead_raises_typed_error():
    def run(side):
        plan = side.svc.FaultPlan(seed=9, specs=(
            side.svc.FaultSpec("replica", "raise", rate=1.0),))
        lb = _loopback(side, 2, plan=plan)
        q, card = _query(side, seed=10)
        with pytest.raises(side.svc.ReplicaDeadError):
            lb[3].plan(q, card, cost="max", req_id=1)
        assert lb[3].stats["replica_deaths"] == 2
        return _cluster_state(*lb)
    _both(run)


def test_client_ceiling_presheds_before_the_network():
    def run(side):
        lb = _loopback(side, 2)
        transport, client = lb[2], lb[3]
        client.ceilings.update("noisy", 0.9)
        q, card = _query(side, seed=11)
        calls0 = transport.calls
        resps = [client.plan(q, card, cost="max", tenant="noisy", req_id=i)
                 for i in range(10)]
        shed = [r for r in resps if r.status == "error"]
        assert client.stats["client_shed"] == len(shed) == 9
        assert all(r.error.context.get("client") for r in shed)
        assert transport.calls == calls0 + 1
        ok = client.plan(q, card, cost="max", req_id=99)
        assert ok.status == "exact"
        return [_resp(r) for r in resps + [ok]], _cluster_state(*lb)
    _both(run)


def test_plan_many_preserves_order_and_refreshes_ceilings():
    def run(side):
        lb = _loopback(side, 2)
        client = lb[3]
        reqs = []
        for i in range(6):
            q, card = _query(side, seed=20 + i, n=5)
            reqs.append(side.svc.PlanRequest(q=q, card=card, cost="max",
                                             req_id=i))
        resps = client.plan_many(reqs, threads=1)
        assert [r.req_id for r in resps] == list(range(6))
        assert all(r.status == "exact" for r in resps)
        stats = client.broadcast({"op": "stats"})
        assert set(stats) == {"r0", "r1"} and all(
            v["ok"] for v in stats.values())
        return [_resp(r) for r in resps], client.refresh_ceilings(), \
            _cluster_state(*lb)
    _both(run)


def test_loopback_chaos_replays_bit_identical():
    """Same seeded plan, same stream: identical answers and counters,
    twice on the port and equal to the reference's."""
    def run(side):
        plan = side.svc.FaultPlan(seed=13, specs=(
            side.svc.FaultSpec("net", "raise", rate=0.3),
            side.svc.FaultSpec("net", "hang", rate=0.1, hang_s=0.2),))
        lb = _loopback(side, 3, plan=plan)
        out = []
        for i in range(8):
            q, card = _query(side, seed=30 + i % 3, n=5)
            try:
                out.append(_resp(lb[3].plan(q, card, cost="max", req_id=i)))
            except side.svc.NetworkError as e:
                out.append(("raised", e.code))
        return out, _cluster_state(*lb)
    got = _both(run)
    assert run(PORT) == got


def test_loopback_dump_merges_through_obs_tail(tmp_path):
    """Each replica's ``dump`` op writes a replica-tagged flight-recorder
    dump; the unchanged ``scripts/obs_tail.py`` merges the port's dumps
    in timestamp order, and its summary counts every request."""
    clk, states, transport, client = _loopback(PORT, 2, trace=True)
    for i in range(6):
        q, card = _query(PORT, seed=50 + i, n=5)
        client.plan(q, card, cost="max", req_id=i)
    paths = []
    for rid in sorted(states):
        path = str(tmp_path / f"flight_{rid}.jsonl")
        out = transport.call(rid, {"op": "dump", "path": path})
        assert out["ok"]
        paths.append(path)
    ot = _obs_tail()
    recs = ot.merge_records(paths)
    served = sum(s.server.stats.served for s in states.values())
    assert served == 6
    summary = ot.summarize(recs)
    assert summary["kinds"].get("completed") == 6
    assert {r["replica"] for r in recs} <= {"r0", "r1"}
    at = [r["at"] if r.get("at") is not None else r["span"]["t0"]
          for r in recs]
    assert at == sorted(at)


# -------------------------------------------------- obs_tail on the port
def _obs_tail():
    path = os.path.join(ROOT, "scripts", "obs_tail.py")
    spec = importlib.util.spec_from_file_location("obs_tail", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dump_replica(tmp_path, rid, t0, n_completed, n_shed):
    """``tests/test_obs.py``'s replica dump, made with the port's
    tracer and flight recorder."""
    clk = P.VirtualClock()
    clk.advance(t0)
    rec = obs.FlightRecorder()
    tr = obs.Tracer(clk, recorder=rec)
    for i in range(n_completed):
        clk.advance(0.5)
        root = tr.request(req_id=f"{rid}-{i}")
        child = root.child("solve")
        clk.advance(0.010)
        child.close()
        tr.finish(root)
    bare = obs.Tracer(clk)
    for i in range(n_shed):
        clk.advance(0.5)
        root = bare.request(req_id=f"{rid}-shed-{i}")
        root.close()
        rec.incident("shed", root, req_id=f"{rid}-shed-{i}", tenant="noisy")
    path = tmp_path / f"flight_{rid}.jsonl"
    rec.dump_jsonl(str(path), replica=rid)
    return str(path)


def test_obs_tail_merges_tags_and_orders_port_dumps(tmp_path):
    ot = _obs_tail()
    p0 = _dump_replica(tmp_path, "r0", t0=0.00, n_completed=3, n_shed=1)
    p1 = _dump_replica(tmp_path, "r1", t0=0.25, n_completed=2, n_shed=2)
    recs = ot.merge_records([p0, p1])
    assert len(recs) == 8 and {r["replica"] for r in recs} == {"r0", "r1"}
    at = [r.get("at") if r.get("at") is not None else r["span"]["t0"]
          for r in recs]
    assert at == sorted(at)
    assert {r["replica"] for r in recs[:2]} == {"r0", "r1"}
    summary = ot.summarize(recs)
    assert summary["records"] == 8
    assert summary["kinds"] == {"completed": 5, "shed": 3}
    assert summary["replicas"]["r0"] == {"completed": 3, "shed": 1}
    assert summary["replicas"]["r1"] == {"completed": 2, "shed": 2}
    assert summary["phases"]["solve"]["count"] == 5
    assert summary["phases"]["solve"]["p50_ms"] == pytest.approx(
        10.0, rel=1e-6)
    line = ot.format_line(recs[-1])
    assert "shed" in line and "tenant=noisy" in line and "t=" in line


def test_obs_tail_untagged_port_dump_falls_back_to_filename(tmp_path):
    ot = _obs_tail()
    rec = obs.FlightRecorder()
    rec.incident("error", None, req_id="x")
    path = tmp_path / "flight_r9.jsonl"
    rec.dump_jsonl(str(path))
    (tmp_path / "flight_bad.jsonl").write_text(
        "not json\n\n" + "\n".join(rec.dump_jsonl()) + "\n")
    recs = ot.load_records(str(path))
    assert recs and all(r["replica"] == "r9" for r in recs)
    bad = ot.load_records(str(tmp_path / "flight_bad.jsonl"))
    assert len(bad) == 1 and bad[0]["replica"] == "bad"


def test_obs_tail_main_kind_filter_and_summary(tmp_path, capsys):
    ot = _obs_tail()
    p0 = _dump_replica(tmp_path, "r0", t0=0.0, n_completed=2, n_shed=2)
    assert ot.main([p0, "--kinds", "shed"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and all("shed" in ln for ln in out)
    assert ot.main([p0, "--summary"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["kinds"] == {"completed": 2, "shed": 2}


# ------------------------------------------------- real processes (TCP)
def test_tcp_cluster_two_replicas_smoke(tmp_path):
    """Spawned server processes on the CPU behind the asyncio line
    protocol: plan parity with the reference, the stats op, replica 0's
    prewarm manifest shipped to the peer, and the replicas' dumps merged
    by ``obs_tail``.  Startup waits at most 240 s per replica and every
    call at most the transport's 60 s."""
    cluster = P.ReplicaCluster(2, config={"device": "cpu",
                                          "engine": "host",
                                          "enable_batch": False,
                                          "prewarm_ns": (6,),
                                          "prewarm_costs": ("max",)},
                               startup_timeout_s=240.0)
    procs = []
    try:
        client = cluster.start()
        procs = list(cluster.procs)
        assert len(cluster.endpoints) == 2
        assert cluster.manifest, "replica 0 recorded no prewarm manifest"
        reqs = []
        for i in range(4):
            q, card = _query(PORT, seed=40 + i, n=6)
            reqs.append(P.PlanRequest(q=q, card=card, cost="max", req_id=i))
        resps = client.plan_many(reqs, threads=2)
        for i, resp in enumerate(resps):
            rq, rcard = _query(REF, seed=40 + i, n=6)
            ref = _host_server(REF).plan_one(rq, rcard, cost="max")
            assert resp.status == "exact"
            assert float(resp.cost).hex() == float(ref.cost).hex()
            assert str(resp.tree) == str(ref.tree)
        stats = cluster.stats()
        assert set(stats) == {"r0", "r1"}
        for rid, out in stats.items():
            assert out["ok"], rid
            assert client.transport.call(
                rid, {"op": "manifest"})["manifest"] == cluster.manifest
        dumps = cluster.dump_recorders(str(tmp_path))
        assert all(v["ok"] for v in dumps.values())
        recs = _obs_tail().merge_records(
            [str(tmp_path / f"flight_{rid}.jsonl") for rid in ("r0", "r1")])
        assert sum(r["kind"] == "completed" for r in recs) == 4
    finally:
        cluster.stop()
    assert procs and all(not p.is_alive() for p in procs)
