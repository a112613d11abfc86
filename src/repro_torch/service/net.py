"""Network front end: wire codec + line-protocol server for PlanServer
(counterpart of ``repro.service.net``; the wire format is the
reference's byte for byte, so a frame one package encodes decodes in the
other).  One difference: the front end reads frame lines up to
``FRAME_LIMIT``, where the reference's stops at asyncio's 64 KiB default
and drops the connection of any request at n >= 13.

This is the bottom half of the distributed-serving subsystem (the top
half — hash ring, shared cache tier, tenant ceilings — lives in
``repro_torch.service.cluster``).  Three layers:

* **Wire codec** — a tagged-JSON encoding under which every
  ``PlanRequest`` / ``PlanResponse`` / ``PlanError`` round-trips
  **bit-exactly**: floats travel as ``float.hex()`` (inf/nan included),
  ndarrays as dtype/shape/base64 bytes, tuples/join trees/query graphs/
  routes as tagged objects.  Bit-exactness is not cosmetic — the
  cluster's cross-replica parity gate diffs plan costs across replicas,
  so the codec must never launder a float through decimal.

* **``ReplicaState``** — one replica's op dispatch table, shared by the
  real asyncio server and the deterministic loopback transport the
  chaos tests drive, so both exercise the same protocol code.  Ops:
  ``ping``, ``stats``, ``manifest``, ``prewarm``, ``cache_get``,
  ``cache_put`` (the shared plan-cache tier's publish path), ``dump``
  (replica-tagged flight-recorder JSONL), ``save_layers`` /
  ``load_layers`` (fragment-store persistence), ``plan``.

* **``NetFrontend`` / ``NetClient``** — an asyncio line-protocol server
  (one JSON frame per ``\\n``-terminated line) wrapping
  ``PlanServer.plan_request_async``, and the matching blocking client.
  The protocol is deliberately dumb: no streaming, no multiplexing —
  one frame in, one frame out, so fault injection at the socket seam
  has exactly one place to bite.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import socket
import threading

import numpy as np

from repro_torch.core.jointree import JoinTree
from repro_torch.core.querygraph import QueryGraph
from repro_torch.service import faults
from repro_torch.service.cache import CachedPlan, PlanCache
from repro_torch.service.router import Route
from repro_torch.service.server import PlanRequest, PlanResponse


# ------------------------------------------------------------------- codec
def _enc(v):
    """Encode an arbitrary protocol value into JSON-safe form."""
    if v is None or isinstance(v, (str, bool, int)):
        return v
    if isinstance(v, float):
        # hex round-trips every double bit-exactly, inf/nan included —
        # json's repr-based floats do too in CPython, but hex is
        # explicit about it and survives any locale/parser quirks
        return {"__f__": v.hex() if v == v else "nan"}
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return _enc(float(v))
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        return {"__nd__": {"dtype": str(a.dtype), "shape": list(a.shape),
                           "data": base64.b64encode(a.tobytes()).decode()}}
    if isinstance(v, JoinTree):
        return {"__jt__": [int(v.mask), _enc(v.left), _enc(v.right)]}
    if isinstance(v, QueryGraph):
        return {"__qg__": {"n": int(v.n),
                           "edges": [[int(a), int(b)] for a, b in v.edges],
                           "hyper": [[int(a), int(b)]
                                     for a, b in v.hyperedges]}}
    if isinstance(v, Route):
        return {"__route__": {"cost": v.cost, "method": v.method,
                              "lane": v.lane, "params": _enc(v.params),
                              "reason": v.reason}}
    if isinstance(v, BaseException):
        return {"__err__": encode_error(v)}
    if isinstance(v, tuple):
        return {"__t__": [_enc(x) for x in v]}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        if all(isinstance(k, str) and not k.startswith("__") for k in v):
            return {k: _enc(x) for k, x in v.items()}
        return {"__map__": [[_enc(k), _enc(x)] for k, x in v.items()]}
    raise TypeError(f"unencodable protocol value: {type(v).__name__}")


def _dec(v):
    if isinstance(v, list):
        return [_dec(x) for x in v]
    if not isinstance(v, dict):
        return v
    if "__f__" in v:
        h = v["__f__"]
        return float("nan") if h == "nan" else float.fromhex(h)
    if "__nd__" in v:
        d = v["__nd__"]
        a = np.frombuffer(base64.b64decode(d["data"]),
                          dtype=np.dtype(d["dtype"]))
        return a.reshape(d["shape"]).copy()
    if "__jt__" in v:
        mask, left, right = v["__jt__"]
        return JoinTree(int(mask), _dec(left), _dec(right))
    if "__qg__" in v:
        d = v["__qg__"]
        return QueryGraph(int(d["n"]),
                          tuple((int(a), int(b)) for a, b in d["edges"]),
                          tuple((int(a), int(b)) for a, b in d["hyper"]))
    if "__route__" in v:
        d = v["__route__"]
        return Route(cost=d["cost"], method=d["method"], lane=d["lane"],
                     params=_dec(d["params"]), reason=d["reason"])
    if "__err__" in v:
        return decode_error(v["__err__"])
    if "__t__" in v:
        return tuple(_dec(x) for x in v["__t__"])
    if "__map__" in v:
        return {_dec(k): _dec(x) for k, x in v["__map__"]}
    return {k: _dec(x) for k, x in v.items()}


def _error_registry() -> dict:
    """code -> PlanError subclass, walked from the live taxonomy so new
    error types register themselves."""
    reg = {faults.PlanError.code: faults.PlanError}
    stack = [faults.PlanError]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            reg[sub.code] = sub
            stack.append(sub)
    return reg


def encode_error(err: BaseException) -> dict:
    e = faults.as_plan_error(err)
    return {"code": e.code, "msg": str(e), "context": _enc(e.context)}


def decode_error(d: dict) -> "faults.PlanError":
    cls = _error_registry().get(d["code"], faults.PlanError)
    err = cls(d["msg"], **_dec(d["context"]))
    return err


def encode_request(req: PlanRequest) -> dict:
    return {f.name: _enc(getattr(req, f.name))
            for f in dataclasses.fields(PlanRequest)}


def decode_request(d: dict) -> PlanRequest:
    kw = {f.name: _dec(d[f.name])
          for f in dataclasses.fields(PlanRequest) if f.name in d}
    return PlanRequest(**kw)


def encode_response(resp: PlanResponse) -> dict:
    return {f.name: _enc(getattr(resp, f.name))
            for f in dataclasses.fields(PlanResponse)}


def decode_response(d: dict) -> PlanResponse:
    kw = {f.name: _dec(d[f.name])
          for f in dataclasses.fields(PlanResponse) if f.name in d}
    return PlanResponse(**kw)


def encode_plan(plan: CachedPlan) -> dict:
    return {f.name: _enc(getattr(plan, f.name))
            for f in dataclasses.fields(CachedPlan)}


def decode_plan(d: dict) -> CachedPlan:
    kw = {f.name: _dec(d[f.name])
          for f in dataclasses.fields(CachedPlan) if f.name in d}
    return CachedPlan(**kw)


# ----------------------------------------------------------- replica state
class ReplicaState:
    """One replica's protocol-op dispatch, transport-agnostic.

    ``runtime`` is the ServingRuntime that owns this replica's flight
    recorder and quota board; the asyncio front end passes the server's
    shared WallClock async runtime, the deterministic loopback
    transport passes its own VirtualClock runtime (and serves ``plan``
    synchronously through it).
    """

    def __init__(self, server, replica_id: str = "", runtime=None):
        self.server = server
        self.replica_id = replica_id or server.replica_id or "r?"
        self.runtime = runtime

    # every op except "plan" is synchronous bookkeeping
    def handle(self, frame: dict) -> dict:
        op = frame.get("op")
        try:
            if op == "ping":
                return {"ok": True, "replica": self.replica_id}
            if op == "stats":
                return {"ok": True, "replica": self.replica_id,
                        "stats": _enc(self._stats())}
            if op == "manifest":
                return {"ok": True,
                        "manifest": list(self.server.prewarm_manifest)}
            if op == "prewarm":
                r = self.server.prewarm_from_manifest(
                    frame.get("manifest", []))
                return {"ok": True, **r}
            if op == "cache_get":
                key = tuple(_dec(frame["key"]))
                entry = self.server.cache.peek(key)
                return {"ok": True,
                        "plan": None if entry is None
                        else encode_plan(entry)}
            if op == "cache_put":
                return self._cache_put(frame)
            if op == "dump":
                rt = self.runtime or getattr(self.server, "_async_rt",
                                             None)
                lines = [] if rt is None else rt.recorder.dump_jsonl(
                    path=frame.get("path"), replica=self.replica_id)
                return {"ok": True, "lines": len(lines),
                        **({} if frame.get("path") else
                           {"jsonl": lines})}
            if op == "save_layers":
                n = self.server.layers.save(frame["path"])
                return {"ok": True, "saved": n}
            if op == "load_layers":
                n = self.server.layers.load(frame["path"])
                return {"ok": True, "loaded": n}
            raise faults.PlanError(f"unknown op {op!r}")
        except faults.PlanError as e:
            return {"ok": False, "error": encode_error(e)}
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, "error": encode_error(e)}

    def _stats(self) -> dict:
        out = {"serve": {"served": self.server.stats.served}}
        rt = self.runtime or getattr(self.server, "_async_rt", None)
        if rt is not None:
            out["runtime"] = rt.stats.as_dict()
            if rt.quotas is not None:
                out["tenancy"] = rt.quotas.snapshot()
        out["cache"] = self.server.cache.stats.as_dict()
        out["layercache"] = self.server.layers.stats.as_dict()
        return out

    def _cache_put(self, frame: dict) -> dict:
        """The shared-cache tier's publish path: a peer replica (or the
        cluster client) pushes a solved canonical plan.  Coherence
        rules: only ``status == "exact"`` plans are accepted (a remote
        degraded plan must never poison a local exact-capable probe),
        and a published plan never clobbers an existing local exact
        entry (first-solve-wins; both sides hold the same bit-exact
        answer anyway, which the parity gate asserts)."""
        key = tuple(_dec(frame["key"]))
        plan = decode_plan(frame["plan"])
        if plan.status != "exact":
            return {"ok": True, "inserted": False,
                    "reason": "degraded plans are not published"}
        existing = self.server.cache.peek(key)
        if existing is not None and existing.status == "exact":
            return {"ok": True, "inserted": False,
                    "reason": "exact entry already present"}
        if not plan.origin or plan.origin == "local":
            plan.origin = str(frame.get("from", "remote"))
        self.server.cache.insert(key, plan)
        return {"ok": True, "inserted": True}

    # ------------------------------------------------- synchronous plan
    def plan_sync(self, req: PlanRequest) -> PlanResponse:
        """Serve one request through this replica's (VirtualClock)
        runtime, draining the event loop to completion — the loopback
        transport's ``plan`` op.  Refusals become typed error responses
        (the sync ``serve`` driver's contract), never raises."""
        rt = self.runtime
        if rt is None:
            raise faults.PlanError("replica has no sync runtime")
        ticket = rt.submit(req)
        stalls = 0
        while not ticket.done:
            nxt = rt.next_event_time()
            if nxt is not None:
                rt.clock.advance_to(nxt)
            if rt.poll() == 0 and nxt is None:
                stalls += 1
                if stalls > 3:
                    raise faults.PlanTimeoutError(
                        "loopback runtime stalled", req_id=req.req_id)
            else:
                stalls = 0
        if ticket.response is not None:
            self.server.stats.served += 1
            return ticket.response
        err = ticket.error if ticket.error is not None \
            else faults.ShedError(ticket.refuse_reason)
        return PlanResponse(
            req_id=req.req_id, cost=float("inf"), tree=None,
            meta={"shed": ticket.refuse_reason, "error": repr(err)},
            route=ticket.route, cache_hit=False, latency=ticket.latency,
            status="error", error=err)


# --------------------------------------------------------- asyncio server
# The longest frame line the front end reads.  asyncio's default stream
# limit (64 KiB) is below a request frame at n >= 13 (a 2^13 float64
# card is 64 KiB before base64), which the reference's front end refuses
# by dropping the connection; the frames themselves are unchanged.
FRAME_LIMIT = 1 << 28


class NetFrontend:
    """Line-protocol asyncio server around one ``PlanServer``.

    Frames are single JSON objects, newline-terminated.  ``plan``
    frames await ``plan_request_async`` (concurrent requests share the
    scheduler: batching, coalescing and cache overtaking all apply);
    every other op answers synchronously via ``ReplicaState``.  A typed
    ``PlanError`` from the runtime becomes an **error response frame**
    — the protocol never drops a connection on a planning failure.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 replica_id: str = ""):
        self.server = server
        self.host = host
        self.port = port          # 0 = ephemeral; real port after start()
        self.state = ReplicaState(server, replica_id=replica_id)
        self._srv = None
        self._stopping = None

    async def start(self) -> int:
        import asyncio

        # bind the replica's async runtime eagerly so ops that arrive
        # before the first plan (dump, stats) see it
        self.state.runtime = self.server.async_runtime()
        self._stopping = asyncio.Event()
        self._srv = await asyncio.start_server(
            self._conn, self.host, self.port, limit=FRAME_LIMIT)
        self.port = self._srv.sockets[0].getsockname()[1]
        return self.port

    async def serve_forever(self) -> None:
        await self._stopping.wait()
        self._srv.close()
        await self._srv.wait_closed()

    def stop(self) -> None:
        if self._stopping is not None:
            self._stopping.set()

    async def _conn(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                frame = {}
                try:
                    frame = json.loads(line)
                except ValueError:
                    out = {"ok": False, "error": encode_error(
                        faults.NetworkError("malformed frame"))}
                else:
                    out = await self._dispatch(frame)
                writer.write((json.dumps(out) + "\n").encode())
                await writer.drain()
                if frame.get("op") == "shutdown":
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    async def _dispatch(self, frame: dict) -> dict:
        op = frame.get("op")
        if op == "shutdown":
            self.stop()
            return {"ok": True, "replica": self.state.replica_id}
        if op != "plan":
            return self.state.handle(frame)
        try:
            req = decode_request(frame["req"])
            resp = await self.server.plan_request_async(req)
            return {"ok": True, "resp": encode_response(resp)}
        except faults.PlanError as e:
            return {"ok": False, "error": encode_error(e)}
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, "error": encode_error(e)}


# -------------------------------------------------------- blocking client
class NetClient:
    """Blocking JSON-line client for one replica endpoint.

    Thread-compatible via an instance per thread (the cluster client
    keeps thread-local instances); reconnects lazily after any error.
    ``call`` raises the decoded typed ``PlanError`` for error frames
    and ``NetworkError`` for transport failures.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: "socket.socket | None" = None
        self._file = None
        self._lock = threading.Lock()

    def _connect(self):
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout_s)
        s.settimeout(self.timeout_s)
        self._sock = s
        self._file = s.makefile("rb")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._file = None

    def call(self, frame: dict, timeout_s: "float | None" = None) -> dict:
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                if timeout_s is not None:
                    self._sock.settimeout(timeout_s)
                self._sock.sendall((json.dumps(frame) + "\n").encode())
                line = self._file.readline()
                if timeout_s is not None:
                    self._sock.settimeout(self.timeout_s)
            except socket.timeout as e:
                self.close()
                raise faults.NetworkError(
                    f"timeout calling {self.host}:{self.port}",
                    op=frame.get("op")) from e
            except OSError as e:
                self.close()
                raise faults.NetworkError(
                    f"transport error calling {self.host}:{self.port}: "
                    f"{e}", op=frame.get("op")) from e
            if not line:
                self.close()
                raise faults.ReplicaDeadError(
                    f"connection closed by {self.host}:{self.port}",
                    op=frame.get("op"))
        out = json.loads(line)
        if not out.get("ok", False):
            raise decode_error(out["error"])
        return out

    # convenience wrappers
    def ping(self) -> dict:
        return self.call({"op": "ping"})

    def plan(self, req: PlanRequest,
             timeout_s: "float | None" = None) -> PlanResponse:
        out = self.call({"op": "plan", "req": encode_request(req)},
                        timeout_s=timeout_s)
        return decode_response(out["resp"])


def cache_put_frame(form, cost: str, resp: PlanResponse,
                    sender: str = "client") -> "dict | None":
    """Build the shared-cache publish frame for a solved response, or
    None when the response is not publishable (degraded/error/no tree).

    The plan is re-canonicalized from the *response* label space back
    into canonical space (``relabel_tree`` through ``form.perm``) so the
    receiving replica can serve any isomorph of the query."""
    from repro_torch.service.canon import relabel_tree

    if resp.status != "exact" or resp.tree is None:
        return None
    key = PlanCache.make_key(form.key, cost, resp.route.method,
                             resp.route.params)
    meta = {k: v for k, v in resp.meta.items()
            if k not in ("cached", "fast_path")}
    plan = CachedPlan(cost=float(resp.cost),
                      tree=relabel_tree(resp.tree, form.perm),
                      meta=meta, inserted_perm=tuple(form.perm),
                      status="exact", origin=sender)
    return {"op": "cache_put", "key": _enc(tuple(key)),
            "plan": encode_plan(plan), "from": sender}
