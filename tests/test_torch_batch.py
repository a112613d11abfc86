"""The port's DPconv[max] batch lane against ``repro``, end to end.

The same queries (numpy, fixed seeds) go through both packages' fused
engine, host engine and ``BatchedSolver``; optima must be
``float.hex``-identical, trees ``str``-identical, and ``rounds`` and
``passes`` equal.  The int32 kernel tier (plain versions here) is held
against the reference's Pallas tier in interpret mode, and every golden
plan (``max``, ``cap`` and ``out``) comes out of the port's batch lane
unchanged.
"""
import functools
import importlib.util
import json
import os

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.dpconv_max import dpconv_max_batch as ref_dpconv_max_batch
from repro.core.querygraph import (chain, clique, cycle, make_cardinalities,
                                   star)
from repro.service import batch as ref_batch
from repro_torch import convert
from repro_torch.core import engine, querygraph
from repro_torch.core.dpconv import optimize, optimize_batch
from repro_torch.core.dpconv_max import (dpconv_max, dpconv_max_batch,
                                         dpconv_max_ref)
from repro_torch.kernels import ops
from repro_torch.service.batch import (BatchedSolver, BatchPolicy,
                                       _pow2_chunks, kernel_dp_fn)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_plans.json")
MAKERS = [clique, chain, star, cycle]
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _queries(n: int, B: int, seed: int):
    """B mixed queries of size n: reference graphs and their tables."""
    qs, cards = [], []
    for i in range(B):
        q = MAKERS[(seed + i) % len(MAKERS)](n)
        qs.append(q)
        cards.append(make_cardinalities(q, seed=seed + i))
    return qs, np.stack(cards)


def _port_query(q, card):
    return convert.from_reference(q.n, q.edges, q.hyperedges, card,
                                  device=CPU)


def _keys(optima, trees):
    return [convert.plan_key(o, t) for o, t in zip(optima, trees)]


# ------------------------------------------------------------ fused engine
@pytest.mark.parametrize("n,B,G", [(5, 1, 1), (6, 3, 3), (7, 5, 1),
                                   (8, 3, 1), (9, 5, 3), (5, 2, 3)])
def test_fused_engine_matches_reference(n, B, G):
    _, cards = _queries(n, B, seed=n)
    want = ref_engine.fused_dpconv_max(cards, n, gamma_batch=G)
    got = engine.fused_dpconv_max(torch.from_numpy(cards), n,
                                  gamma_batch=G, device=CPU)
    assert _keys(got.optima, got.trees) == _keys(want.optima, want.trees)
    assert (got.rounds, got.passes) == (want.rounds, want.passes)
    assert got.dispatches == 1 and got.syncs == got.rounds + 1 + 4
    assert np.array_equal(got.dp, want.dp)


@pytest.mark.parametrize("engine_name", ["fused", "host"])
@pytest.mark.parametrize("n", [6, 8])
def test_dpconv_max_batch_matches_reference(n, engine_name):
    _, cards = _queries(n, 3, seed=10 + n)
    want = ref_dpconv_max_batch(cards, n, engine=engine_name)
    got = dpconv_max_batch(cards, n, engine=engine_name, device=CPU)
    assert _keys([r.optimum for r in got], [r.tree for r in got]) == \
        _keys([r.optimum for r in want], [r.tree for r in want])
    assert [r.feasibility_passes for r in got] == \
        [r.feasibility_passes for r in want]
    assert [r.engine for r in got] == [r.engine for r in want]


# ---------------------------------------------------------- batch solver
def _solver_items(seed: int):
    """B = 5 at n = 6 (chunks 4 + 1) and B = 3 at n = 5 (2 + 1): chunking
    and the single-query path in one micro-batch."""
    items = []
    for n, B in [(6, 5), (5, 3)]:
        qs, cards = _queries(n, B, seed=seed + n)
        items += list(zip(qs, cards))
    return items


@pytest.mark.parametrize("engine_name,G", [("fused", 1), ("fused", 3),
                                           ("host", 1)])
def test_batched_solver_matches_reference(engine_name, G):
    items = _solver_items(seed=20 + G)
    want = ref_batch.BatchedSolver(ref_batch.BatchPolicy(
        max_batch=4, engine=engine_name, gamma_batch=G)).solve(items)
    solver = BatchedSolver(BatchPolicy(max_batch=4, engine=engine_name,
                                       gamma_batch=G), device=CPU)
    got = solver.solve([_port_query(q, c) for q, c in items])
    assert _keys([r.cost for r in got], [r.tree for r in got]) == \
        _keys([r.cost for r in want], [r.tree for r in want])
    for g, w in zip(got, want):
        assert g.meta["passes"] == w.meta["passes"]
        assert g.meta["chunk"] == w.meta["chunk"]
        assert g.meta["engine"] == w.meta["engine"]
    assert [t[:2] for t in solver.last_timings] == \
        [(5, 2), (5, 1), (6, 4), (6, 1)]
    assert all(r.meta["backend"] == "f64" for r in got)  # auto on a CPU


# ------------------------------------------------ int32 tier, n = 11
def test_int32_tier_host_loop_matches_reference_pallas():
    """As ``test_service_batch.py::test_pallas_tier_kernel_path``: the
    host loop with the kernel tier's ``dp_fn`` (zeta, Moebius and the
    ranked convolution on int32) against the reference's Pallas tier."""
    n = 11
    _, cards = _queries(n, 2, seed=0)
    want = ref_dpconv_max_batch(cards, n, extract_tree=False,
                                dp_fn=ref_batch.pallas_dp_fn(n))
    got = dpconv_max_batch(cards, n, extract_tree=False,
                           dp_fn=kernel_dp_fn(n), device=CPU)
    assert [r.optimum.hex() for r in got] == \
        [r.optimum.hex() for r in want]
    assert [r.feasibility_passes for r in got] == \
        [r.feasibility_passes for r in want]


def test_int32_tier_fused_matches_reference_pallas():
    n = 11
    qs, cards = _queries(n, 2, seed=4)
    want = ref_engine.fused_dpconv_max(cards, n, backend="pallas")
    got = engine.fused_dpconv_max(cards, n, backend="cuda", device=CPU)
    assert _keys(got.optima, got.trees) == _keys(want.optima, want.trees)
    assert (got.rounds, got.passes) == (want.rounds, want.passes)
    ops.reset_launch_counts()
    solver = BatchedSolver(BatchPolicy(backend="cuda"), device=CPU)
    res = solver.solve([_port_query(q, c) for q, c in zip(qs, cards)])
    assert [convert.plan_key(r.cost, r.tree) for r in res] == \
        _keys(want.optima, want.trees)
    assert all(r.meta["backend"] == "cuda" for r in res)
    assert sum(ops.launch_counts().values()) == 0     # plain versions


# ---------------------------------------------------------- golden plans
@functools.lru_cache(maxsize=1)
def _golden_instances():
    spec = importlib.util.spec_from_file_location(
        "regen_golden", os.path.join(ROOT, "scripts", "regen_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: (q, card) for name, q, card, _ in mod.golden_instances()}


def _golden_entries(cost: str):
    with open(FIXTURE) as f:
        return [e for e in json.load(f)["entries"] if e["cost"] == cost]


def _golden_max_entries():
    return _golden_entries("max")


@pytest.mark.parametrize("entry", _golden_max_entries(),
                         ids=lambda e: e["name"])
def test_golden_max_plan_from_port_batch_lane(entry):
    q, card = _golden_instances()[entry["name"]]
    (res,) = BatchedSolver(device=CPU).solve([_port_query(q, card)])
    assert convert.plan_key(res.cost, res.tree) == \
        (entry["optimum_hex"], entry["tree"])


@pytest.mark.parametrize(
    "entry", _golden_entries("cap") + _golden_entries("out"),
    ids=lambda e: f"{e['name']}/{e['cost']}")
def test_golden_cap_and_out_plans_from_port_batch_lane(entry):
    """A one-item chunk of the lane runs what ``test_golden_plans.py``'s
    ``live_solve`` runs: ``ccap(q, card)`` (fused) for cap, and
    ``optimize(cost="out", method="dpccp", engine="fused")`` for out."""
    q, card = _golden_instances()[entry["name"]]
    (res,) = BatchedSolver(device=CPU).solve(
        [_port_query(q, card) + (entry["cost"],)])
    assert convert.plan_key(res.cost, res.tree) == \
        (entry["optimum_hex"], entry["tree"])
    assert res.meta["engine"] == "fused" and res.meta["chunk"] == 1


def test_golden_max_plans_as_one_micro_batch():
    entries = _golden_max_entries()
    inst = _golden_instances()
    items = [_port_query(*inst[e["name"]]) for e in entries]
    solver = BatchedSolver(BatchPolicy(max_batch=8), device=CPU)
    got = solver.solve(items)
    assert [convert.plan_key(r.cost, r.tree) for r in got] == \
        [(e["optimum_hex"], e["tree"]) for e in entries]
    assert solver.batches_run >= 1


# ----------------------------------------------------- small contracts
def test_convert_round_trip_and_oracle():
    q0, card = _queries(6, 1, seed=3)
    q, t = convert.from_reference(q0[0].n, q0[0].edges, q0[0].hyperedges,
                                  card[0], device=CPU)
    assert isinstance(q, querygraph.QueryGraph)
    assert (q.n, q.edges, q.hyperedges) == (q0[0].n, q0[0].edges,
                                             q0[0].hyperedges)
    assert t.dtype == torch.float64 and t.numpy().tobytes() == \
        card[0].tobytes()
    r = dpconv_max(q, t, device=CPU)
    assert r.optimum == dpconv_max_ref(card[0], 6)
    assert r.tree.validate() and r.tree.cost_max(card[0]) == r.optimum
    with pytest.raises(ValueError):
        convert.from_reference(5, (), (), card[0], device=CPU)


def test_unported_paths_raise():
    """What is refused raises ``ValueError``, as in the reference: the
    host loops refuse ``shards > 1``, a fused solve refuses a mesh wider
    than the devices it may use (one CPU device here, without
    ``launch.mesh.force_device_count``), and the host batch loop refuses
    ``gamma_batch > 1`` (the (G+1)-ary search is the single-query host
    loop's and the fused engine's)."""
    qs, cards = _queries(5, 2, seed=1)
    items = [_port_query(q, c) for q, c in zip(qs, cards)]
    q0, c0 = items[0]
    for cost, kw in [("max", {"shards": 2}), ("cap", {"shards": 2}),
                     ("out", {"method": "dpccp", "engine": "fused",
                              "shards": 2}),
                     ("max", {"engine": "host", "shards": 2})]:
        with pytest.raises(ValueError):
            optimize(q0, c0, cost=cost, device=CPU, **kw)
    with pytest.raises(ValueError):
        dpconv_max_batch(cards, 5, engine="host", shards=2, device=CPU)
    with pytest.raises(ValueError):
        engine.fused_dpconv_max(cards, 5, shards=2, device=CPU)
    with pytest.raises(ValueError):
        engine.fused_ccap(cards, 5, shards=2, device=CPU)
    with pytest.raises(ValueError):
        engine.fused_out([q0, items[1][0]], cards, 5, shards=2, device=CPU)
    with pytest.raises(ValueError):
        dpconv_max_batch(cards, 5, engine="host", gamma_batch=3,
                         device=CPU)
    mixed = optimize_batch([items[0][0], querygraph.chain(6)],
                           [items[0][1], make_cardinalities(chain(6))],
                           device=CPU)
    assert not any(r.meta.get("batched") for r in mixed)
    assert _pow2_chunks(11, 16) == [8, 2, 1]
    assert _pow2_chunks(11, 6) == [4, 4, 2, 1]


# ------------------------------------------------------------ solve mesh
def test_batch_policy_solve_shards():
    """``solve_shards``/``shard_min_n`` default and validate as in the
    reference; ``_shards`` engages the mesh only at ``n >= shard_min_n``
    and clamps to the devices the mesh may use."""
    from repro_torch.launch import mesh
    for P in (BatchPolicy, ref_batch.BatchPolicy):
        assert (P().solve_shards, P().shard_min_n) == (1, 14)
        with pytest.raises(ValueError):
            P(solve_shards=0)
    pol = dict(solve_shards=4)
    port = BatchedSolver(BatchPolicy(**pol), device=CPU)
    ref = ref_batch.BatchedSolver(ref_batch.BatchPolicy(**pol))
    assert port._shards(13) == ref._shards(13) == 1
    assert port._shards(14) == 1                     # one CPU device
    try:
        mesh.force_device_count(8)
        assert [port._shards(n) for n in (13, 14, 15)] == [1, 4, 4]
        low = BatchedSolver(BatchPolicy(solve_shards=4, shard_min_n=6),
                            device=CPU)
        assert low._shards(6) == 4 and low._shards(5) == 1
    finally:
        mesh.force_device_count(None)


def test_sharded_batch_lane_matches_reference():
    """A ``solve_shards=4`` batch lane on a 4-slot CPU mesh: cap, cap_conn
    and out chunks at n = 14 run sharded fused programs and answer as
    the reference's lane (whose jax mesh is however wide jax allows)."""
    from repro_torch.launch import mesh
    n = 14
    graphs = [(clique(n), "cap", 1), (star(n), "cap", 2),
              (cycle(n), "cap_conn", 3), (chain(n), "cap_conn", 4),
              (chain(n), "out", 5), (cycle(n), "out", 6)]
    ref_items = [(q, make_cardinalities(q, seed=s), cost)
                 for q, cost, s in graphs]
    want = ref_batch.BatchedSolver(
        ref_batch.BatchPolicy(solve_shards=4)).solve(ref_items)
    try:
        mesh.force_device_count(4)
        solver = BatchedSolver(BatchPolicy(solve_shards=4), device=CPU)
        mark = engine.dispatch_mark()
        got = solver.solve([_port_query(q, c) + (cost,)
                            for q, c, cost in ref_items])
        recs = engine.dispatches_since(mark)
    finally:
        mesh.force_device_count(None)
    assert sorted(r.cost for r in recs) == ["cap", "cap_conn", "out"]
    assert all(r.shards == 4 and r.devices == ("cpu",) * 4 for r in recs)
    for g, w in zip(got, want):
        assert float(g.cost).hex() == float(w.cost).hex()
        assert repr(g.tree) == repr(w.tree)
        assert g.meta["engine"] == w.meta["engine"] == "fused"
        assert g.meta["chunk"] == w.meta["chunk"] == 2
