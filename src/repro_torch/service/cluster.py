"""Replica cluster: consistent-hash routing, shared plan-cache tier,
cross-replica prewarm, tenant admission ceilings, network chaos seams
(counterpart of ``repro.service.cluster``).

The top half of the distributed-serving subsystem (the codec and the
per-replica protocol live in ``repro_torch.service.net``):

* **``HashRing``** — consistent hashing (sha256, ``vnodes`` virtual
  nodes per replica) over ``canon.CanonicalForm.key``.  Because the key
  is *canonical*, every relabeling of a query hashes to the same owner
  replica — the ring shards canonical solve identities, not raw
  queries, which is what makes the shared cache tier coherent without
  any invalidation protocol (a canonical key's exact plan is immutable).

* **``ClusterClient``** — the client-side router.  Canonicalizes
  locally, pre-sheds over-ceiling tenants (``tenancy.AdmissionCeilings``
  fed back from replica quota stats), routes to the key's ring owner
  (``affinity=True``), fails over along the ring's successor list on
  network errors / dead replicas, hedges onto the next replica when the
  owner exceeds ``hedge_s``, and **publishes** exact solves that were
  served by a non-owner back to the owner (``cache_put``) — one
  replica's DPconv solve becomes every replica's relabeling-aware hit.

* **``LoopbackTransport``** — the deterministic in-process transport:
  every frame JSON-round-trips through the real codec, every op runs
  against real ``PlanServer`` replicas on one shared ``VirtualClock``,
  and the seeded ``FaultInjector`` bites at the two new seams
  (``"net"`` = partition / slow replica, ``"replica"`` = replica
  death).  The chaos tests replay bit-for-bit.

* **``ReplicaCluster``** — the multi-process harness: N spawn-context
  server processes each running a ``NetFrontend``, a ``TcpTransport``
  with thread-local sockets, replica-0 prewarm with manifest shipping
  (peers compile the same buckets from the manifest, not from scratch),
  and optional fragment-store persistence (``layercache.save/load``).
  Each replica's ``PlanServer`` solves on the config's ``device`` (CUDA
  unless given); replicas on one card each open their own CUDA context
  and load the kernel library the parent built before spawning them.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading

import numpy as np

from repro_torch.service import faults
from repro_torch.service import net as net_mod
from repro_torch.service.canon import canonicalize
from repro_torch.service.server import PlanRequest, PlanResponse
from repro_torch.service.tenancy import AdmissionCeilings


# --------------------------------------------------------------- hash ring
def _h(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over replica ids with virtual nodes."""

    def __init__(self, replica_ids, vnodes: int = 64):
        if not replica_ids:
            raise ValueError("ring needs at least one replica")
        self.replica_ids = list(replica_ids)
        self.vnodes = vnodes
        points = []
        for rid in self.replica_ids:
            for v in range(vnodes):
                points.append((_h(f"{rid}#{v}"), rid))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [r for _, r in points]

    def owner(self, key: str) -> str:
        i = bisect.bisect_right(self._points, _h(key)) % len(self._points)
        return self._owners[i]

    def successors(self, key: str) -> "list[str]":
        """Every replica, ordered by ring position from the key's owner
        (the failover/hedge order: distinct replicas, owner first)."""
        start = bisect.bisect_right(self._points, _h(key))
        seen: "list[str]" = []
        n = len(self._points)
        for d in range(n):
            rid = self._owners[(start + d) % n]
            if rid not in seen:
                seen.append(rid)
                if len(seen) == len(self.replica_ids):
                    break
        return seen


# -------------------------------------------------------------- transports
class LoopbackTransport:
    """Deterministic in-process transport over ``net.ReplicaState``s.

    Every frame (and response) passes through ``json.dumps``/``loads``
    so the tests exercise the real wire codec.  Fault seams:

    * ``FaultSpec(seam="replica")`` — the *targeted* replica dies
      permanently: this call and every later one to it raises
      ``ReplicaDeadError`` (mid-flight death: the request is lost).
    * ``FaultSpec(seam="net", kind="raise")`` — one-shot partition:
      this call raises ``NetworkError``; the replica never sees it.
    * ``FaultSpec(seam="net", kind="hang")`` — slow replica: the op
      EXECUTES (state mutates, clock charges ``hang_s``) but the
      response is lost to a timeout ``NetworkError`` — exactly the
      ambiguity a hedging client must tolerate.
    """

    def __init__(self, states: "dict[str, net_mod.ReplicaState]",
                 clock=None,
                 injector: "faults.FaultInjector | None" = None):
        self.states = dict(states)
        self.clock = clock
        self.injector = injector
        self.dead: set = set()
        self.calls = 0

    def call(self, replica_id: str, frame: dict,
             timeout_s: "float | None" = None) -> dict:
        self.calls += 1
        if replica_id in self.dead:
            raise faults.ReplicaDeadError(
                f"replica {replica_id} is dead", replica=replica_id)
        spec = None
        if self.injector is not None:
            spec = self.injector.arm("replica")
            if spec is not None:
                self.dead.add(replica_id)
                raise faults.ReplicaDeadError(
                    f"replica {replica_id} died mid-flight (injected)",
                    replica=replica_id)
            spec = self.injector.arm("net")
        if spec is not None and spec.kind == "raise":
            raise faults.NetworkError(
                f"partition calling {replica_id} (injected)",
                replica=replica_id)
        state = self.states[replica_id]
        frame = json.loads(json.dumps(frame))   # the real wire boundary
        if frame.get("op") == "plan":
            req = net_mod.decode_request(frame["req"])
            resp = state.plan_sync(req)
            out = {"ok": True, "resp": net_mod.encode_response(resp)}
        else:
            out = state.handle(frame)
        out = json.loads(json.dumps(out))
        if spec is not None and spec.kind == "hang":
            if self.clock is not None and spec.hang_s > 0:
                self.clock.advance(spec.hang_s)
            raise faults.NetworkError(
                f"timeout calling {replica_id} (injected slow replica)",
                replica=replica_id, hang_s=spec.hang_s)
        if not out.get("ok", False):
            raise net_mod.decode_error(out["error"])
        return out


class TcpTransport:
    """Thread-local ``NetClient`` per (thread, replica): the cluster
    client's thread pool gets private sockets, no cross-thread frame
    interleaving."""

    def __init__(self, endpoints: "dict[str, tuple]",
                 timeout_s: float = 60.0):
        self.endpoints = dict(endpoints)
        self.timeout_s = timeout_s
        self._tl = threading.local()

    def _client(self, replica_id: str) -> "net_mod.NetClient":
        clients = getattr(self._tl, "clients", None)
        if clients is None:
            clients = self._tl.clients = {}
        c = clients.get(replica_id)
        if c is None:
            host, port = self.endpoints[replica_id]
            c = clients[replica_id] = net_mod.NetClient(
                host, port, timeout_s=self.timeout_s)
        return c

    def call(self, replica_id: str, frame: dict,
             timeout_s: "float | None" = None) -> dict:
        return self._client(replica_id).call(frame, timeout_s=timeout_s)


# ----------------------------------------------------------- cluster client
class ClusterClient:
    """Client-side router over a transport + hash ring.

    ``affinity=True`` routes each request to its canonical key's ring
    owner (cache locality: isomorphic repeats land on the same replica
    cluster-wide); ``affinity=False`` round-robins (spreads cold solves,
    the publish path keeps the owner warm either way).  ``hedge_s``
    bounds how long the first replica may take before the client gives
    up and tries the ring's next replica (None = transport default).
    """

    def __init__(self, transport, replica_ids, vnodes: int = 64,
                 hedge_s: "float | None" = None, publish: bool = True,
                 affinity: bool = True,
                 ceilings: "AdmissionCeilings | None" = None):
        self.transport = transport
        self.ring = HashRing(replica_ids, vnodes=vnodes)
        self.replica_ids = list(replica_ids)
        self.hedge_s = hedge_s
        self.publish = publish
        self.affinity = affinity
        self.ceilings = ceilings if ceilings is not None \
            else AdmissionCeilings()
        self.dead: set = set()
        self.stats = {"requests": 0, "failovers": 0, "hedges": 0,
                      "net_errors": 0, "replica_deaths": 0,
                      "publishes": 0, "client_shed": 0, "errors": 0}
        self._rr = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ routing
    def _order(self, key: str) -> "list[str]":
        order = self.ring.successors(key)
        if not self.affinity:
            with self._lock:
                self._rr += 1
                rot = self._rr % len(order)
            order = order[rot:] + order[:rot]
        live = [r for r in order if r not in self.dead]
        return live or order      # all dead: try anyway, surface errors

    def plan(self, q, card, cost: str = "max",
             latency_budget: "float | None" = None,
             slo: "str | None" = None, connected: bool = False,
             explain: bool = False, tenant: "str | None" = None,
             req_id: int = 0) -> PlanResponse:
        req = PlanRequest(q=q, card=np.asarray(card, np.float64),
                          cost=cost, latency_budget=latency_budget,
                          slo=slo, connected=connected, explain=explain,
                          tenant=tenant, req_id=req_id)
        return self.plan_request(req)

    def plan_request(self, req: PlanRequest) -> PlanResponse:
        with self._lock:
            self.stats["requests"] += 1
        # client-side tenant ceiling: pre-shed the traffic the replicas
        # are already denying, before it crosses the network
        if not self.ceilings.admit(req.tenant):
            with self._lock:
                self.stats["client_shed"] += 1
            err = faults.ShedError(
                f"tenant {req.tenant!r} over client admission ceiling",
                tenant=req.tenant, client=True)
            return PlanResponse(
                req_id=req.req_id, cost=float("inf"), tree=None,
                meta={"shed": str(err), "error": repr(err)}, route=None,
                cache_hit=False, status="error", error=err)
        form = canonicalize(req.q, req.card)
        order = self._order(form.key)
        frame = {"op": "plan", "req": net_mod.encode_request(req)}
        last_err: "Exception | None" = None
        for i, rid in enumerate(order):
            try:
                out = self.transport.call(rid, frame,
                                          timeout_s=self.hedge_s)
            except faults.ReplicaDeadError as e:
                with self._lock:
                    self.stats["replica_deaths"] += 1
                    self.stats["failovers"] += 1
                self.dead.add(rid)
                last_err = e
                continue
            except faults.NetworkError as e:
                with self._lock:
                    self.stats["net_errors"] += 1
                    if e.context.get("hang_s") is not None \
                            or "timeout" in str(e):
                        self.stats["hedges"] += 1
                    else:
                        self.stats["failovers"] += 1
                last_err = e
                continue
            resp = net_mod.decode_response(out["resp"])
            # shared-cache tier: a non-owner solved it — publish the
            # canonical plan to the ring owner so the whole cluster
            # hits from here on (relabeling-aware: canonical space)
            owner = order[0] if self.affinity else \
                self.ring.successors(form.key)[0]
            if (self.publish and rid != owner
                    and not resp.cache_hit and resp.status == "exact"):
                self._publish(form, req.cost, resp, rid, owner)
            if resp.status == "error":
                with self._lock:
                    self.stats["errors"] += 1
            return resp
        raise last_err if last_err is not None else faults.NetworkError(
            "no live replicas")

    def _publish(self, form, cost, resp, solver_rid, owner) -> None:
        frame = net_mod.cache_put_frame(form, cost, resp,
                                        sender=solver_rid)
        if frame is None:
            return
        try:
            self.transport.call(owner, frame)
            with self._lock:
                self.stats["publishes"] += 1
        except faults.NetworkError:
            pass                    # publish is best-effort by design

    def plan_many(self, reqs, threads: int = 8) -> "list[PlanResponse]":
        """Drive many requests concurrently (TCP transport: each worker
        thread has private sockets via the transport's thread-locals)."""
        if threads <= 1 or len(reqs) <= 1:
            return [self.plan_request(r) for r in reqs]
        import concurrent.futures as cf
        out: "list" = [None] * len(reqs)
        with cf.ThreadPoolExecutor(max_workers=threads) as ex:
            futs = {ex.submit(self.plan_request, r): i
                    for i, r in enumerate(reqs)}
            for f in cf.as_completed(futs):
                out[futs[f]] = f.result()
        return out

    # --------------------------------------------------------- management
    def refresh_ceilings(self) -> dict:
        """Pull every live replica's tenancy deny rates and fold the
        max per tenant into the client admission ceilings."""
        rates: "dict[str, float]" = {}
        for rid in self.replica_ids:
            if rid in self.dead:
                continue
            try:
                out = self.transport.call(rid, {"op": "stats"})
            except faults.NetworkError:
                continue
            ten = net_mod._dec(out.get("stats", {})).get("tenancy")
            if not ten:
                continue
            for t, st in ten.get("tenants", {}).items():
                r = float(st.get("deny_rate", 0.0))
                rates[t] = max(rates.get(t, 0.0), r)
        for t, r in rates.items():
            self.ceilings.update(t, r)
        return {t: self.ceilings.ceiling(t) for t in rates}

    def broadcast(self, frame: dict) -> dict:
        out = {}
        for rid in self.replica_ids:
            if rid in self.dead:
                continue
            try:
                out[rid] = self.transport.call(rid, dict(frame))
            except faults.NetworkError as e:
                out[rid] = {"ok": False, "error": str(e)}
        return out

    def snapshot(self) -> dict:
        return {**self.stats, "dead": sorted(self.dead),
                "ceilings": self.ceilings.snapshot()}


# ------------------------------------------------------- process harness
def _replica_main(rid: str, cfg: dict, conn) -> None:
    """Entry point of one replica process (spawn context: must live in
    an importable module, never ``__main__``).  Builds the PlanServer,
    restores the fragment store, optionally prewarms, then serves the
    asyncio line protocol until a ``shutdown`` frame."""
    import asyncio

    from repro_torch.service.batch import BatchPolicy
    from repro_torch.service.runtime import RuntimeConfig, WallClock
    from repro_torch.service.server import PlanServer

    pol = BatchPolicy(engine=cfg.get("engine", "host"),
                      max_batch=cfg.get("max_batch", 16))
    srv = PlanServer(enable_batch=cfg.get("enable_batch", False),
                     batch_policy=pol,
                     lanes=cfg.get("lanes", 1),
                     replica_id=rid,
                     device=cfg.get("device"))
    loaded = 0
    store = cfg.get("layer_store")
    if store and os.path.exists(store):
        loaded = srv.layers.load(store)
    # build the async runtime eagerly so quota/sampling config applies
    rtc = RuntimeConfig(max_batch=pol.max_batch,
                        max_wait=cfg.get("max_wait", 0.005),
                        lanes=cfg.get("lanes", 1),
                        trace=cfg.get("trace", True),
                        trace_sample=cfg.get("trace_sample", 1.0),
                        tenant_quotas=cfg.get("tenant_quotas"))
    srv._async_rt = srv.make_runtime(clock=WallClock(), config=rtc,
                                     executor="thread")
    prewarm = cfg.get("prewarm_ns")
    if prewarm:
        srv.prewarm(prewarm, costs=tuple(cfg.get("prewarm_costs",
                                                 ("max", "cap", "out"))))

    async def main():
        fe = net_mod.NetFrontend(srv, replica_id=rid)
        port = await fe.start()
        conn.send({"port": port, "loaded_fragments": loaded})
        await fe.serve_forever()

    asyncio.run(main())


def _on_card(device) -> bool:
    return device is None or str(device).startswith("cuda")


class ReplicaCluster:
    """N replica server processes + a ``ClusterClient`` over TCP.

    ``config`` is the per-replica dict ``_replica_main`` consumes
    (device, engine, lanes, tenant_quotas, layer_store, prewarm_ns...);
    ``device`` is where each replica's server solves (CUDA unless given;
    ``"cpu"`` runs the plain PyTorch path).  Only
    replica 0 gets ``prewarm_ns``; the cluster ships its manifest to
    the peers (``prewarm_from_manifest``) after startup — compiled-
    bucket lists cross the network, compile work does not.
    """

    def __init__(self, n_replicas: int, config: "dict | None" = None,
                 startup_timeout_s: float = 120.0):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.n = n_replicas
        self.config = dict(config or {})
        self.startup_timeout_s = startup_timeout_s
        self.replica_ids = [f"r{i}" for i in range(n_replicas)]
        self.procs: list = []
        self.endpoints: dict = {}
        self.manifest: list = []
        self.client: "ClusterClient | None" = None
        self._started = False

    def start(self) -> "ClusterClient":
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        if _on_card(self.config.get("device")):
            # the children load this library; building it here first
            # keeps N replicas from each running nvcc
            from repro_torch.kernels import build
            build.build()
        # replica processes are one-lane solvers by default: pin the
        # host thread pools so N replicas don't oversubscribe the box.
        # Spawn children inherit os.environ at Process.start() time.
        pinned = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                  "MKL_NUM_THREADS": "1"}
        saved = {k: os.environ.get(k) for k in pinned}
        os.environ.update(pinned)
        try:
            pipes = []
            for i, rid in enumerate(self.replica_ids):
                cfg = dict(self.config)
                if i != 0:
                    cfg.pop("prewarm_ns", None)   # peers get the manifest
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_replica_main,
                                args=(rid, cfg, child), daemon=True)
                p.start()
                child.close()
                pipes.append((rid, parent, p))
                self.procs.append(p)
            for rid, parent, p in pipes:
                if not parent.poll(self.startup_timeout_s):
                    raise faults.ReplicaDeadError(
                        f"replica {rid} failed to start", replica=rid)
                info = parent.recv()
                self.endpoints[rid] = ("127.0.0.1", info["port"])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        transport = TcpTransport(self.endpoints)
        self.client = ClusterClient(transport, self.replica_ids)
        # cross-replica prewarm: manifest from replica 0, shipped to all
        # peers (list of buckets, not work)
        out = transport.call(self.replica_ids[0], {"op": "manifest"})
        self.manifest = out.get("manifest", [])
        if self.manifest:
            for rid in self.replica_ids[1:]:
                transport.call(rid, {"op": "prewarm",
                                     "manifest": self.manifest})
        self._started = True
        return self.client

    def stats(self) -> dict:
        return self.client.broadcast({"op": "stats"})

    def dump_recorders(self, directory: str) -> dict:
        """One replica-tagged JSONL dump per replica (obs_tail input)."""
        os.makedirs(directory, exist_ok=True)
        out = {}
        for rid in self.replica_ids:
            path = os.path.join(directory, f"flight_{rid}.jsonl")
            out[rid] = self.client.transport.call(
                rid, {"op": "dump", "path": path})
        return out

    def save_layers(self, path_prefix: str) -> dict:
        return {rid: self.client.transport.call(
            rid, {"op": "save_layers", "path": f"{path_prefix}.{rid}"})
            for rid in self.replica_ids}

    def stop(self) -> None:
        if self.client is not None:
            for rid in self.replica_ids:
                try:
                    self.client.transport.call(rid, {"op": "shutdown"})
                except (faults.NetworkError, KeyError):
                    pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = []
        self._started = False

    def __enter__(self) -> "ClusterClient":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["HashRing", "LoopbackTransport", "TcpTransport",
           "ClusterClient", "ReplicaCluster"]
