"""The (min,+) sweep kernel (``kernels.minplus``, ``csrc/minplus.cu``)
and the fused C_cap lane it carries to n = 19.

On the CPU: a model of the kernel's index arithmetic (lane groups, the
bit deposit of each lane's first split, the masked-add step) held
bitwise to the gather sweep, gated, connected, seeded and batched; the
set list it reads; the sweep's live-set count and the dispatch record's
``sweep_sets``/``sweep_total``; C_cap routed to the fused batch lane up
to n = 19 and prewarmed there; a solve mesh's cap ceiling; the fused cap
lane against the benchmark's plain reference
(``planbench/references/joinorder.py``).  On the card (``cuda``-marked,
skipped without one): the kernel bitwise against the gather sweep and
against the host pipelines at n = 6..16, ``plan_one`` serving C_cap at
n = 16 through the fused program, and no split table built by pass 2.
This file imports no JAX: its card cases compare with the port's own
plain versions.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine, lattice
from repro_torch.core.bitset import layer_indices, popcounts
from repro_torch.core.ccap import ccap
from repro_torch.core.dpccp import connectivity_masks, dpccp_with_tree
from repro_torch.core.querygraph import (chain, clique, cycle,
                                         make_cardinalities, random_sparse,
                                         star)
from repro_torch.kernels.minplus import layer_offsets, layer_sets
from repro_torch.service import router as router_mod
from repro_torch.service.batch import BatchPolicy
from repro_torch.service.server import PlanServer

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
MAKERS = {"clique": clique, "chain": chain, "star": star, "cycle": cycle,
          "sparse": lambda n: random_sparse(n, extra_edges=2, seed=n)}


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


# ------------------------------------------------------------ inputs
def _inputs(kind: str, n: int, B: int, seed: int):
    """Cards, the gate ``ok`` and, by ``kind``, ``conn`` and seeds for a
    B-row sweep: ``value`` (a C_cap gate at each row's median
    cardinality), ``conn`` (connected-subset masks), ``cap_conn`` (both)
    or ``seeded`` (connected, with seeds on the sets of up to three
    relations and on every fifth larger set, some of them not the sweep's
    own values)."""
    names = sorted(MAKERS)
    qs = [MAKERS[names[(seed + b) % len(names)]](n) for b in range(B)]
    cards = np.stack([make_cardinalities(q, seed=seed + 11 * b)
                      for b, q in enumerate(qs)])
    pc = popcounts(n)
    gamma = np.median(cards[:, pc >= 2], axis=1)[:, None]
    gate = (cards <= gamma) | (pc < 2)[None, :]
    conn = np.stack([connectivity_masks(q) for q in qs])
    out = {"card": cards, "ok": gate, "conn": None, "seed_vals": None,
           "seed_ok": None}
    if kind in ("conn", "seeded"):
        out["ok"] = out["conn"] = conn
    if kind == "cap_conn":
        out["ok"] = out["conn"] = gate & conn
    if kind == "seeded":
        cold = lattice.minplus_connected_layers(
            torch.from_numpy(cards), torch.from_numpy(conn), n).numpy()
        ids = np.arange(1 << n)
        so = ((pc <= 3) | (ids % 5 == 0))[None, :] & conn
        sv = np.where(ids % 10 == 0, cold * 1.5, cold)
        out["seed_vals"], out["seed_ok"] = sv, so
    return qs, out


def _torch(d: dict, device) -> dict:
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in d.items()}


def _gather(d: dict, n: int) -> np.ndarray:
    """The plain version: the gather sweep on the CPU."""
    t = _torch(d, CPU)
    if t["conn"] is None:
        return lattice.minplus_value_layers(t["card"], t["ok"], n).numpy()
    return lattice.minplus_connected_layers(
        t["card"], t["conn"], n, seed_vals=t["seed_vals"],
        seed_ok=t["seed_ok"]).numpy()


# ------------------------------------------------- a model of the kernel
def _model_sweep(d: dict, n: int) -> np.ndarray:
    """The kernel's own enumeration, lane by lane, in Python floats (IEEE
    float64): a group of g = min(32, 2^(k-1)) lanes per (row, S), lane l
    starting at deposit(l, M) and stepping by the masked add of
    deposit(g, M); the group's minimum plus c(S)."""
    card, ok, conn = d["card"], d["ok"], d["conn"]
    sv, so = d["seed_vals"], d["seed_ok"]
    B, size = card.shape
    pc = popcounts(n)
    dp = np.where(pc == 1, 0.0, math.inf)[None, :].repeat(B, 0)
    sets = layer_sets(n)
    offs = layer_offsets(n)
    for k in range(2, n + 1):
        gb = min(k - 1, 5)
        g = 1 << gb
        splits = (1 << (k - 1)) - 1
        for r in range(B):
            for S in map(int, sets[offs[k]:offs[k + 1]]):
                if so is not None and so[r, S]:
                    dp[r, S] = sv[r, S]
                    continue
                if not ok[r, S]:
                    dp[r, S] = math.inf
                    continue
                low = S & -S
                M = S ^ low
                best = math.inf
                for lane in range(g):
                    sub = step = 0
                    rest = M
                    for b in range(6):
                        lb = rest & -rest
                        if (lane >> b) & 1:
                            sub |= lb
                        if b == gb:
                            step = lb
                        rest ^= lb
                    j = lane
                    while j < splits:
                        T, C = low | sub, M ^ sub
                        if conn is None or (conn[r, T] and conn[r, C]):
                            best = min(best, float(dp[r, T])
                                       + float(dp[r, C]))
                        sub = ((sub | ~M) + step) & M
                        j += g
                dp[r, S] = best + float(card[r, S])
    return dp


@pytest.mark.parametrize("kind", ["value", "conn", "cap_conn", "seeded"])
@pytest.mark.parametrize("n,B", [(5, 1), (8, 3)])
def test_kernel_model_matches_gather_sweep(kind, n, B):
    """The kernel's index arithmetic, run in Python, gives the gather
    sweep's table bit for bit: each unordered split once is enough."""
    _, d = _inputs(kind, n, B, seed=n + B)
    want = _gather(d, n)
    got = _model_sweep(d, n)
    assert got.tobytes() == want.tobytes()
    assert np.isfinite(want[:, popcounts(n) >= 3]).any()


def test_layer_sets_list_every_layer_in_order():
    for n in (2, 7, 13):
        sets, offs = layer_sets(n), layer_offsets(n)
        assert sets.dtype == np.int32 and sets.shape == (1 << n,)
        assert offs[n + 1] == 1 << n
        for k in range(n + 1):
            assert offs[k + 1] - offs[k] == math.comb(n, k)
            assert np.array_equal(sets[offs[k]:offs[k + 1]],
                                  layer_indices(n)[k])


# ------------------------------------------------ live sets and records
def test_live_sets_count_gated_unseeded_sets():
    n = 7
    _, d = _inputs("seeded", n, 3, seed=4)
    t = _torch(d, CPU)
    pc = popcounts(n) >= 2
    want = int((d["ok"] & pc).sum())
    assert int(lattice.live_sets(t["ok"], n)) == want
    want_seeded = int((d["ok"] & ~d["seed_ok"] & pc).sum())
    assert int(lattice.live_sets(t["ok"], n, t["seed_ok"])) == want_seeded
    assert lattice.live_sets(t["ok"], n).dtype == torch.int64


def test_dispatch_records_carry_sweep_sets_on_cpu():
    """``sweep_sets`` is the rows' gated sets of layers 2..n, counted on
    the device, ``sweep_total`` all of them; a C_max call has neither."""
    n = 6
    qs = [chain(n), cycle(n), star(n), clique(n)]     # B = 4: no padding
    cards = np.stack([make_cardinalities(q, seed=i, cap=1e12)
                      for i, q in enumerate(qs)])
    pc = popcounts(n) >= 2
    conn = np.stack([connectivity_masks(q) for q in qs])
    mark = engine.dispatch_mark()
    cap = engine.fused_ccap(cards, n, device=CPU)
    engine.fused_ccap(cards, n, qs=qs, gamma_slack=2.0, device=CPU)
    engine.fused_out(qs, cards, n, device=CPU)
    engine.fused_dpconv_max(cards, n, device=CPU)
    recs = engine.dispatches_since(mark)
    assert [r.cost for r in recs] == ["cap", "cap_conn", "out", "max"]
    gate = (cards <= cap.gammas[:, None]) & pc[None, :]
    gate2 = (cards <= 2.0 * cap.gammas[:, None]) & pc[None, :]
    want = [int(gate.sum()), int((gate2 & conn).sum()),
            int((conn & pc[None, :]).sum()), 0]
    assert [r.sweep_sets for r in recs] == want
    assert [r.sweep_total for r in recs] == \
        [4 * ((1 << n) - n - 1)] * 3 + [0]
    assert all(0 < r.sweep_sets < r.sweep_total for r in recs[:3])


def test_cpu_sweeps_launch_no_kernel():
    from repro_torch.kernels import build
    build.reset_launch_counts()
    qs = [chain(6)]
    cards = make_cardinalities(qs[0], seed=1)[None, :]
    engine.fused_ccap(cards, 6, device=CPU)
    engine.fused_out(qs, cards, 6, device=CPU)
    assert build.launch_counts()["minplus_layer"] == 0


# ------------------------------------------------------ routing, ceiling
@pytest.mark.parametrize("n", range(14, 21))
def test_cap_routes_to_the_fused_lane_up_to_19(n):
    """The router's own ceiling, the one a server on one card keeps,
    under the engine hint a server sets (its batch policy's engine)."""
    r = router_mod.Router()
    r.engine_hint["dpconv"] = BatchPolicy().engine
    route = r.route(clique(n), "cap")
    conn = r.route(chain(n), "cap", connected=True)
    fused = n <= 19
    assert r.config.fused_cap_max_n == 19
    for rt, cost in ((route, "cap"), (conn, "cap_conn")):
        assert rt.method == "dpconv"
        assert rt.lane == ("batch" if fused else "single")
        assert r.engine_tag("dpconv", n, rt.lane, cost) == \
            ("fused:" if fused else "host:") + cost


def test_prewarm_builds_cap_buckets_up_to_19(monkeypatch):
    calls = []

    def fake(ns, **kw):
        calls.append((tuple(ns), kw["max_batch"], kw["costs"],
                      kw["backend"]))
        return {"compiled": 1, "seconds": 0.0}

    monkeypatch.setattr(engine, "prewarm", fake)
    srv = PlanServer(device=CPU)
    # the ceiling a server on one card keeps (a CPU server's is 13)
    srv.router.config.fused_cap_max_n = \
        router_mod.RouterConfig().fused_cap_max_n
    srv.prewarm(range(12, 22), costs=("cap",))
    assert [c[0] for c in calls] == [(n,) for n in range(12, 20)]
    assert all(c[1:] == (16, ("cap", "cap_seeded"), "f64") for c in calls)
    assert [e["n"] for e in srv.prewarm_manifest] == list(range(12, 20))


def test_sharded_ceiling_never_lowers_a_base():
    for base, D, want in [(19, 1, 19), (19, 2, 19), (19, 4, 19),
                          (16, 8, 16), (15, 4, 15), (13, 4, 15),
                          (13, 2, 14), (11, 4, 13)]:
        assert engine.sharded_ceiling(base, D) == want


def test_cpu_server_keeps_the_gather_sweep_cap_ceiling():
    """Off one card the (min,+) sweep gathers split tables: a CPU server
    clamps its cap ceiling to the gather sweep's 13, and its C_cap at
    n = 14 takes the host pipeline, while the router alone keeps 19."""
    srv = PlanServer(device=CPU)
    cfg = srv.router.config
    assert cfg.fused_cap_max_n == router_mod.GATHER_SWEEP_MAX_N == 13
    assert cfg.fused_out_max_n == 13
    assert router_mod.Router().config.fused_cap_max_n == 19
    route = srv.router.route(clique(14), "cap")
    assert (route.method, route.lane) == ("dpconv", "single")
    assert srv.router.engine_tag("dpconv", 14, route.lane, "cap") == \
        "host:cap"
    own = router_mod.Router(router_mod.RouterConfig(fused_cap_max_n=16))
    assert PlanServer(router=own, device=CPU).router.config \
        .fused_cap_max_n == 13


def test_mesh_server_keeps_the_gather_sweep_cap_ceiling():
    """A mesh's (min,+) sweep gathers split tables: the cap ceiling of a
    ``solve_shards = D`` server is ``sharded_ceiling(13, D)``, as before
    the kernel, while the out ceiling lifts as it did."""
    from repro_torch.launch import mesh
    try:
        mesh.force_device_count(4)
        for D in (2, 4):
            cfg = PlanServer(batch_policy=BatchPolicy(solve_shards=D),
                             device=CPU).router.config
            base = router_mod.GATHER_SWEEP_MAX_N
            assert cfg.fused_cap_max_n == engine.sharded_ceiling(base, D) \
                == {2: 14, 4: 15}[D]
            assert cfg.fused_out_max_n == engine.sharded_ceiling(13, D)
    finally:
        mesh.force_device_count(None)


# -------------------------------------------- against the plain reference
def _joinorder():
    path = ROOT / "planbench" / "references" / "joinorder.py"
    spec = importlib.util.spec_from_file_location("joinorder_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_tuple(t):
    if t.left is None:
        return (int(t.mask),)
    return (int(t.mask), _tree_tuple(t.left), _tree_tuple(t.right))


@pytest.mark.parametrize("n", [6, 8, 9])
def test_fused_cap_lane_matches_plain_reference(n):
    """C_cap through ``plan_one``'s fused batch lane on seeded random
    cardinalities: the served cost is the reference's optimum and the
    served tree costs exactly that."""
    ref = _joinorder()
    sem = {"cap_slack": 1.0, "out_connected_max_density": 0.5}
    srv = PlanServer(device=CPU, enable_cache=False)
    rng = np.random.default_rng(n)
    for i, name in enumerate(("clique", "chain", "star", "cycle")):
        q = MAKERS[name](n)
        card = make_cardinalities(q, seed=int(rng.integers(1 << 31)),
                                  base_range=(1e2, 1e6),
                                  selectivity_range=(1e-4, 1.0), cap=1e8)
        mark = engine.dispatch_mark()
        resp = srv.plan_one(q, card, cost="cap")
        (rec,) = engine.dispatches_since(mark)
        assert resp.route.lane == "batch" and resp.status == "exact"
        assert rec.cost == "cap" and rec.n == n
        (sol,) = ref.solve([(n, list(q.edges), card)], "cap", sem)
        assert float(resp.cost) == sol["opt"]
        assert ref.tree_cost(_tree_tuple(resp.tree), sol, n) == sol["opt"]


# ----------------------------------------------------------- the card
def _kernel(d: dict, n: int, device) -> np.ndarray:
    t = _torch(d, device)
    if t["conn"] is None:
        dp = lattice.minplus_value_layers(t["card"], t["ok"], n)
    else:
        dp = lattice.minplus_connected_layers(
            t["card"], t["conn"], n, seed_vals=t["seed_vals"],
            seed_ok=t["seed_ok"])
    torch.cuda.synchronize()
    return dp.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["value", "conn", "cap_conn", "seeded"])
@pytest.mark.parametrize("n,B", [(6, 1), (9, 3), (12, 16), (14, 2),
                                 (16, 1)])
def test_kernel_matches_gather_sweep_on_card(cuda_device, kind, n, B):
    from repro_torch.kernels import build
    _, d = _inputs(kind, n, B, seed=3 * n + B)
    before = build.launch_counts()["minplus_layer"]
    got = _kernel(d, n, cuda_device)
    assert build.launch_counts()["minplus_layer"] - before == n - 1
    assert got.tobytes() == _gather(d, n).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["clique", "chain", "star"])
@pytest.mark.parametrize("n", [6, 10, 13, 16])
def test_fused_cap_on_card_matches_host_pipeline(cuda_device, name, n):
    q = MAKERS[name](n)
    card = make_cardinalities(q, seed=n)
    got = ccap(q, card, engine="fused", device=cuda_device)
    want = ccap(q, card, engine="host")
    assert got.engine == "fused" and want.engine == "host"
    assert (got.gamma.hex(), got.cout.hex()) == (want.gamma.hex(),
                                                 want.cout.hex())
    assert str(got.tree) == str(want.tree)
    if name != "clique":                       # the connected cap
        cards = card[None, :]
        gc = engine.fused_ccap(cards, n, gamma_slack=2.0, qs=[q],
                               device=cuda_device)
        wc = engine.fused_ccap(cards, n, gamma_slack=2.0, qs=[q],
                               device=CPU)
        assert (gc.couts.tobytes(), str(gc.trees)) == \
            (wc.couts.tobytes(), str(wc.trees))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain", "cycle", "sparse"])
@pytest.mark.parametrize("n", [6, 10, 13, 16])
def test_fused_out_on_card_matches_dpccp(cuda_device, name, n):
    qs = [MAKERS[name](n), chain(n)]
    cards = np.stack([make_cardinalities(q, seed=n + i)
                      for i, q in enumerate(qs)])
    got = engine.fused_out(qs, cards, n, device=cuda_device)
    for b, q in enumerate(qs):
        dp, tree = dpccp_with_tree(q, cards[b], mode="out")
        assert got.couts[b].hex() == float(dp[-1]).hex()
        assert got.dp[b].tobytes() == np.asarray(dp).tobytes()
        assert str(got.trees[b]) == str(tree)


@pytest.mark.cuda
def test_plan_one_serves_cap_at_16_fused_on_card(cuda_device):
    """``plan_one`` sends C_cap at n = 16 through the fused program on the
    batch lane; its answer is the host pipeline's, bitwise, and pass 2
    built no split table above pass 1's direct layers."""
    n = 16
    q = clique(n)
    card = make_cardinalities(q, seed=21)
    from repro_torch.kernels import build
    srv = PlanServer(device=cuda_device, enable_cache=False)
    assert srv.router.config.fused_cap_max_n == 19
    build.reset_launch_counts()
    mark = engine.dispatch_mark()
    resp = srv.plan_one(q, card, cost="cap")
    (rec,) = engine.dispatches_since(mark)
    assert resp.route.lane == "batch" and resp.status == "exact"
    assert rec.cost == "cap" and rec.backend == "f64"
    assert build.launch_counts()["minplus_layer"] == n - 1
    assert 0 < rec.sweep_sets <= rec.sweep_total == (1 << n) - n - 1
    want = ccap(q, card, engine="host")
    assert float(resp.cost).hex() == want.cout.hex()
    dev = str(cuda_device)
    built = [key[2] for key in lattice._DEVICE_TABLES
             if key[0] == "direct" and key[1] == n and key[3] == dev]
    assert built and max(built) <= 4
