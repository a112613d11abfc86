"""The port's wire layer (``service.net``) against ``repro``'s.

The ``tests/test_net.py`` contracts on the port (fixed cases instead of
property draws): every float, ndarray, tree, graph, route and typed
error survives encode -> JSON -> decode bit for bit; ``ReplicaState``
answers its ops and keeps the shared-cache coherence rules; a real
asyncio ``NetFrontend`` / ``NetClient`` round trip on the CPU.  Then the
frames cross packages: a request, response, error and cached plan that
one package encodes are the same JSON text the other encodes, and decode
bitwise in the other.
"""
import dataclasses
import json
import math
import threading

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import querygraph as ref_qg
from repro.core.jointree import JoinTree as RefJoinTree
from repro.service import PlanServer as RefServer
from repro.service import faults as ref_faults
from repro.service import net as ref_net
from repro.service.batch import BatchPolicy as RefPolicy
from repro.service.canon import canonicalize as ref_canonicalize
from repro.service.router import Route as RefRoute
from repro.service.server import PlanRequest as RefRequest
from repro_torch.core.jointree import JoinTree
from repro_torch.core.querygraph import chain, make_cardinalities, star
from repro_torch.service import PlanServer, faults
from repro_torch.service import net as net_mod
from repro_torch.service.batch import BatchPolicy
from repro_torch.service.cache import CachedPlan, PlanCache
from repro_torch.service.canon import canonicalize
from repro_torch.service.net import (NetClient, NetFrontend, ReplicaState,
                                     decode_request, decode_response,
                                     encode_request, encode_response)
from repro_torch.service.router import Route
from repro_torch.service.server import PlanRequest, PlanResponse

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _host_server() -> PlanServer:
    return PlanServer(enable_batch=False,
                      batch_policy=BatchPolicy(engine="host"), device=CPU)


def _ref_host_server() -> RefServer:
    return RefServer(enable_batch=False,
                     batch_policy=RefPolicy(engine="host"))


def _json(v):
    """The actual wire boundary: through the JSON text format."""
    return json.loads(json.dumps(v))


# ----------------------------------------------------------------- codec
FLOATS = [0.0, -0.0, 1.0, -2.5, 1 / 3, -1e-17, 5e-324,
          2.2250738585072014e-308, 1.7976931348623157e308, 123456.789e200,
          float("inf"), float("-inf"), 6.02214076e23, -7.25e-290]


@pytest.mark.parametrize("x", FLOATS, ids=[float(x).hex() for x in FLOATS])
def test_codec_floats_bit_exact(x):
    y = net_mod._dec(_json(net_mod._enc(x)))
    assert isinstance(y, float) and x.hex() == y.hex()
    assert json.dumps(net_mod._enc(x)) == json.dumps(ref_net._enc(x))
    nan = net_mod._dec(_json(net_mod._enc(float("nan"))))
    assert isinstance(nan, float) and math.isnan(nan)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "uint64"])
@pytest.mark.parametrize("size", [1, 7, 40])
def test_codec_ndarray_bit_exact(size, dtype):
    rng = np.random.default_rng(size)
    scale = 1e18 if np.dtype(dtype).kind == "f" else 2e9
    a = (rng.random(size) * scale).astype(dtype)
    b = net_mod._dec(_json(net_mod._enc(a)))
    assert b.dtype == a.dtype and b.shape == a.shape
    assert a.tobytes() == b.tobytes()
    c = ref_net._dec(_json(net_mod._enc(a)))
    assert c.dtype == a.dtype and a.tobytes() == c.tobytes()


def test_codec_containers_trees_graphs_routes():
    q = chain(5)
    tree = JoinTree(0b11111, JoinTree(0b00111, JoinTree(0b011),
                                      JoinTree(0b100)), JoinTree(0b11000))
    route = Route(cost="max", method="dpconv", lane="batch",
                  params=(("engine", "host"),), reason="test")
    v = {"t": (1, 2.5, "x"), "tree": tree, "q": q, "route": route,
         "nested": {"inf": float("inf"), "neg0": -0.0},
         "list": [1, (2, 3)]}
    out = net_mod._dec(_json(net_mod._enc(v)))
    assert out["t"] == (1, 2.5, "x") and isinstance(out["t"], tuple)
    assert out["tree"] == tree and out["q"] == q and out["route"] == route
    assert out["nested"]["inf"] == float("inf")
    assert math.copysign(1.0, out["nested"]["neg0"]) == -1.0
    assert out["list"] == [1, (2, 3)]
    # the same values built with the reference's types: the same text
    ref_tree = RefJoinTree(0b11111, RefJoinTree(
        0b00111, RefJoinTree(0b011), RefJoinTree(0b100)),
        RefJoinTree(0b11000))
    ref_v = {**v, "tree": ref_tree, "q": ref_qg.chain(5),
             "route": RefRoute(cost="max", method="dpconv", lane="batch",
                               params=(("engine", "host"),), reason="test")}
    assert json.dumps(net_mod._enc(v)) == json.dumps(ref_net._enc(ref_v))


def test_codec_nonstring_and_dunder_keys_round_trip():
    v = {(6, "max"): 3, 1: "one"}
    assert net_mod._dec(_json(net_mod._enc(v))) == v
    dunder = {"__f__": "not-a-float"}
    assert net_mod._dec(_json(net_mod._enc(dunder))) == dunder
    with pytest.raises(TypeError):
        net_mod._enc(object())


def test_error_taxonomy_round_trips_every_subclass():
    reg = net_mod._error_registry()
    assert set(reg) == set(ref_net._error_registry())
    assert "net" in reg and "replica_dead" in reg
    for code, cls in reg.items():
        err = cls("boom", detail=(1, 2.5), arr=np.arange(3.0))
        frame = _json(net_mod.encode_error(err))
        for dec, want_cls in ((net_mod.decode_error, cls),
                              (ref_net.decode_error,
                               ref_net._error_registry()[code])):
            back = dec(frame)
            assert type(back) is want_cls
            assert back.code == code and "boom" in str(back)
            assert back.context["detail"] == (1, 2.5)
            assert back.context["arr"].tobytes() == \
                np.arange(3.0).tobytes()


def test_request_round_trip_bit_exact():
    q = star(6)
    card = make_cardinalities(q, seed=3)
    req = PlanRequest(q=q, card=card, cost="cap", latency_budget=0.25,
                      arrival=1.5, req_id=42, slo="interactive",
                      connected=True, explain=True, tenant="acme")
    back = decode_request(_json(encode_request(req)))
    for f in dataclasses.fields(PlanRequest):
        a, b = getattr(req, f.name), getattr(back, f.name)
        if f.name == "card":
            assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
        else:
            assert a == b, f.name


def test_response_round_trip_including_error_payload():
    srv = _host_server()
    q = chain(6)
    card = make_cardinalities(q, seed=1)
    resp = srv.plan_one(q, card, cost="max", explain=True)
    back = decode_response(_json(encode_response(resp)))
    assert float(back.cost).hex() == float(resp.cost).hex()
    assert back.tree == resp.tree and back.route == resp.route
    assert back.status == resp.status == "exact"
    assert back.explain["lane"] == resp.explain["lane"]
    err_resp = PlanResponse(req_id=7, cost=float("inf"), tree=None,
                            meta={"shed": "over quota"}, route=None,
                            cache_hit=False, status="error",
                            error=faults.ShedError("over quota",
                                                   tenant="acme"))
    back = decode_response(_json(encode_response(err_resp)))
    assert isinstance(back.error, faults.ShedError)
    assert back.error.context["tenant"] == "acme"
    assert back.cost == float("inf") and back.status == "error"


# --------------------------------------------------------- replica state
def test_replica_state_ping_stats_manifest_and_unknown_op():
    srv = _host_server()
    state = ReplicaState(srv, replica_id="rA")
    assert state.handle({"op": "ping"}) == {"ok": True, "replica": "rA"}
    srv.prewarm([6], costs=("max",))
    out = state.handle({"op": "manifest"})
    assert out["ok"] and out["manifest"] == srv.prewarm_manifest
    assert state.handle({"op": "stats"})["ok"]
    bad = state.handle({"op": "no_such_op"})
    assert not bad["ok"]
    assert isinstance(net_mod.decode_error(bad["error"]), faults.PlanError)


def test_cache_put_coherence_rules():
    """Only exact plans enter; an existing exact entry never gets
    clobbered; local-origin publishes are re-tagged with the sender."""
    srv = _host_server()
    state = ReplicaState(srv, replica_id="rA")
    q = chain(6)
    card = make_cardinalities(q, seed=2)
    form = canonicalize(q, card)
    resp = _host_server().plan_one(q, card, cost="max")
    frame = net_mod.cache_put_frame(form, "max", resp, sender="rB")
    key = tuple(net_mod._dec(frame["key"]))
    out = state.handle(_json(frame))
    assert out["ok"] and out["inserted"]
    entry = srv.cache.peek(key)
    assert entry is not None and entry.origin == "rB"
    assert entry.status == "exact"
    assert float(entry.cost).hex() == float(resp.cost).hex()
    out = state.handle(_json(frame))
    assert out["ok"] and not out["inserted"]
    degraded = dataclasses.replace(resp, status="degraded")
    assert net_mod.cache_put_frame(form, "max", degraded,
                                   sender="rB") is None
    bad = _json(frame)
    bad["plan"]["status"] = "degraded"
    out = state.handle(bad)
    assert out["ok"] and not out["inserted"]
    again = srv.plan_one(q, card, cost="max")
    assert again.cache_hit and srv.cache.stats.cross_hits >= 1


def test_cache_get_round_trips_published_plan():
    srv = _host_server()
    state = ReplicaState(srv, replica_id="rA")
    q = chain(6)
    card = make_cardinalities(q, seed=4)
    form = canonicalize(q, card)
    resp = _host_server().plan_one(q, card, cost="max")
    frame = net_mod.cache_put_frame(form, "max", resp, sender="rB")
    state.handle(_json(frame))
    out = state.handle(_json({"op": "cache_get", "key": frame["key"]}))
    plan = net_mod.decode_plan(out["plan"])
    assert isinstance(plan, CachedPlan)
    assert float(plan.cost).hex() == float(resp.cost).hex()
    miss_key = net_mod._enc(tuple(PlanCache.make_key("nope", "max",
                                                     "dpconv")))
    out = state.handle(_json({"op": "cache_get", "key": miss_key}))
    assert out["ok"] and out["plan"] is None


def test_layer_store_ops_round_trip(tmp_path):
    srv = _host_server()
    q = chain(7)
    srv.plan_one(q, make_cardinalities(q, seed=5), cost="max")
    state = ReplicaState(srv, replica_id="rA")
    path = str(tmp_path / "layers.npz")
    out = state.handle({"op": "save_layers", "path": path})
    assert out["ok"] and out["saved"] >= 1
    out2 = ReplicaState(_host_server()).handle({"op": "load_layers",
                                                "path": path})
    assert out2["ok"] and out2["loaded"] == out["saved"]


# ------------------------------------------------- asyncio socket round trip
def _serve_in_thread(srv):
    """Run a NetFrontend on an ephemeral port in a daemon thread."""
    import asyncio

    fe = NetFrontend(srv, replica_id="rT")
    started = threading.Event()
    box = {}

    def run():
        async def main():
            box["port"] = await fe.start()
            started.set()
            await fe.serve_forever()

        asyncio.run(main())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(30)
    return fe, box["port"], t


def test_net_frontend_client_plan_and_shutdown():
    srv = _host_server()
    fe, port, t = _serve_in_thread(srv)
    client = NetClient("127.0.0.1", port, timeout_s=30.0)
    try:
        assert client.ping()["replica"] == "rT"
        q = chain(6)
        card = make_cardinalities(q, seed=6)
        resp = client.plan(PlanRequest(q=q, card=card, cost="max",
                                       req_id=9))
        ref = _host_server().plan_one(q, card, cost="max")
        assert float(resp.cost).hex() == float(ref.cost).hex()
        assert resp.tree == ref.tree and resp.status == "exact"
        with client._lock:
            client._sock.sendall(b"this is not json\n")
            line = client._file.readline()
        out = json.loads(line)
        assert not out["ok"]
        assert isinstance(net_mod.decode_error(out["error"]),
                          faults.NetworkError)
        assert client.ping()["replica"] == "rT"
        # the reference's client speaks to the port's front end
        ref_client = ref_net.NetClient("127.0.0.1", port, timeout_s=30.0)
        try:
            rq = ref_qg.chain(6)
            r2 = ref_client.plan(RefRequest(q=rq, card=card, cost="max",
                                            req_id=10))
            assert float(r2.cost).hex() == float(ref.cost).hex()
            assert str(r2.tree) == str(ref.tree)
        finally:
            ref_client.close()
    finally:
        client.call({"op": "shutdown"})
        client.close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_net_frontend_serves_frames_above_64_kib():
    """A request at n = 13 is a frame line above asyncio's 64 KiB
    default stream limit.  The port's front end serves it; the
    reference's drops the connection (a reference fault, kept there)."""
    q, card = chain(13), make_cardinalities(chain(13), seed=2)
    req = PlanRequest(q=q, card=card, cost="max", req_id=1)
    assert len(json.dumps({"op": "plan", "req": encode_request(req)})) \
        > 1 << 16
    fe, port, t = _serve_in_thread(_host_server())
    client = NetClient("127.0.0.1", port, timeout_s=60.0)
    try:
        resp = client.plan(req)
        want = _host_server().plan_one(q, card, cost="max")
        assert resp.status == "exact"
        assert float(resp.cost).hex() == float(want.cost).hex()
        assert str(resp.tree) == str(want.tree)
    finally:
        client.call({"op": "shutdown"})
        client.close()
        t.join(timeout=30)
    assert not t.is_alive()
    ref_fe = ref_net.NetFrontend(_ref_host_server(), replica_id="rR")
    started, box = threading.Event(), {}

    def run():
        import asyncio

        async def main():
            box["port"] = await ref_fe.start()
            started.set()
            await ref_fe.serve_forever()

        asyncio.run(main())

    rt = threading.Thread(target=run, daemon=True)
    rt.start()
    assert started.wait(30)
    ref_client = ref_net.NetClient("127.0.0.1", box["port"], timeout_s=60.0)
    try:
        with pytest.raises(ref_faults.ReplicaDeadError):
            ref_client.plan(RefRequest(q=ref_qg.chain(13), card=card,
                                       cost="max", req_id=1))
    finally:
        ref_client.call({"op": "shutdown"})
        ref_client.close()
        rt.join(timeout=30)
    assert not rt.is_alive()


# ------------------------------------------------ frames across packages
def _same_request(a, b):
    for f in dataclasses.fields(PlanRequest):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "card":
            assert x.tobytes() == y.tobytes() and x.dtype == y.dtype
        elif f.name == "q":
            assert (x.n, x.edges, x.hyperedges) == \
                (y.n, y.edges, y.hyperedges)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("seed", [0, 3])
def test_request_frames_cross_packages(seed):
    q, card = star(7), make_cardinalities(star(7), seed=seed)
    kw = dict(card=card, cost="max", latency_budget=0.5, arrival=2.25,
              req_id=seed, slo="batch", connected=False, explain=True,
              tenant="t1")
    req = PlanRequest(q=q, **kw)
    ref_req = RefRequest(q=ref_qg.star(7), **kw)
    text = json.dumps(encode_request(req))
    assert text == json.dumps(ref_net.encode_request(ref_req))
    _same_request(ref_net.decode_request(json.loads(text)), req)
    _same_request(decode_request(
        json.loads(json.dumps(ref_net.encode_request(ref_req)))), ref_req)


@pytest.mark.parametrize("cost", ["max", "cap", "out"])
def test_response_frames_cross_packages(cost):
    q, card = chain(7), make_cardinalities(chain(7), seed=8)
    resp = _host_server().plan_one(q, card, cost=cost, explain=True)
    ref_resp = _ref_host_server().plan_one(ref_qg.chain(7), card, cost=cost,
                                           explain=True)
    for a, dec in ((resp, ref_net.decode_response),
                   (ref_resp, decode_response)):
        b = dec(_json(net_mod.encode_response(a) if a is resp
                      else ref_net.encode_response(a)))
        assert float(b.cost).hex() == float(a.cost).hex()
        assert str(b.tree) == str(a.tree)
        assert (b.route.cost, b.route.method, b.route.lane, b.route.params) \
            == (a.route.cost, a.route.method, a.route.lane, a.route.params)
        assert (b.status, b.cache_hit, b.req_id) == \
            (a.status, a.cache_hit, a.req_id)
    assert float(resp.cost).hex() == float(ref_resp.cost).hex()


def test_error_frames_cross_packages():
    errs = [faults.ShedError("over quota", tenant="acme", client=True),
            faults.ReplicaDeadError("gone", replica="r2"),
            faults.NetworkError("partition", replica="r1", hang_s=0.5)]
    for err in errs:
        text = json.dumps(net_mod.encode_error(err))
        ref_err = type(ref_net.decode_error(json.loads(text)))(
            str(err), **err.context)
        assert text == json.dumps(ref_net.encode_error(ref_err))
        back = ref_net.decode_error(json.loads(text))
        assert type(back).__name__ == type(err).__name__
        assert back.context == err.context
        again = net_mod.decode_error(
            json.loads(json.dumps(ref_net.encode_error(back))))
        assert type(again) is type(err) and again.context == err.context
    resp = PlanResponse(req_id=3, cost=float("inf"), tree=None,
                        meta={"shed": "x"}, route=None, cache_hit=False,
                        status="error", error=errs[0])
    back = ref_net.decode_response(_json(encode_response(resp)))
    assert isinstance(back.error, ref_faults.ShedError)
    assert back.error.context["tenant"] == "acme"


def test_cached_plan_frames_cross_packages():
    """A publish frame the port builds is the reference's text, and each
    package's ``ReplicaState`` inserts the other's publish and answers
    the query from it."""
    q, card = chain(7), make_cardinalities(chain(7), seed=9)
    rq = ref_qg.chain(7)
    resp = _host_server().plan_one(q, card, cost="max")
    ref_resp = _ref_host_server().plan_one(rq, card, cost="max")
    frame = net_mod.cache_put_frame(canonicalize(q, card), "max", resp,
                                    sender="rB")
    ref_frame = ref_net.cache_put_frame(ref_canonicalize(rq, card), "max",
                                        ref_resp, sender="rB")
    assert json.dumps(frame) == json.dumps(ref_frame)
    ref_srv = _ref_host_server()
    out = ref_net.ReplicaState(ref_srv, replica_id="rA").handle(
        _json(frame))
    assert out["ok"] and out["inserted"]
    hit = ref_srv.plan_one(rq, card, cost="max")
    assert hit.cache_hit and float(hit.cost).hex() == float(resp.cost).hex()
    srv = _host_server()
    out = ReplicaState(srv, replica_id="rA").handle(_json(ref_frame))
    assert out["ok"] and out["inserted"]
    hit = srv.plan_one(q, card, cost="max")
    assert hit.cache_hit and str(hit.tree) == str(ref_resp.tree)
    got = ref_net.decode_plan(_json(net_mod.encode_plan(
        srv.cache.peek(tuple(net_mod._dec(frame["key"]))))))
    assert float(got.cost).hex() == float(resp.cost).hex()
    assert got.status == "exact" and got.origin == "rB"
