"""The port's planners (``planner.einsum_path``, ``planner.datajoin``)
and the model configs they plan at, against ``repro``.

Contraction lists, cardinality tables (``tobytes``), query graphs, plan
optima (``float.hex``) and trees (``str``), greedy plans and data-join
graphs must equal the reference's; a ``ContractionLog`` saved by one
package loads in the other; ``execute_plan`` (pairwise ``torch.einsum``)
agrees with ``jnp.einsum`` of the whole expression in float64 within
``rtol=1e-12``, ``atol=1e-12`` times the largest magnitude of the result
(a different contraction order sums in another order, so the results are
equal up to rounding, not bitwise); the data-join ``execute`` (numpy in
both packages) returns the same rows.
"""
import dataclasses

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.common import ModelConfig as RefModelConfig
from repro.planner import datajoin as ref_dj
from repro.planner import einsum_path as ref_ep
from repro.service import PlanServer as RefServer
from repro_torch import configs
from repro_torch.core.baselines import dpsub_max, dpsub_out
from repro_torch.models.common import ModelConfig, round_up
from repro_torch.planner import datajoin as dj
from repro_torch.planner import einsum_path as ep
from repro_torch.service import PlanServer

CPU = "cpu"
ARCHS = sorted(ref_configs.ARCHS)
EXEC_RTOL = 1e-12


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


def _c(c):
    return (tuple(c.operands), c.output, dict(c.sizes))


def _ref_contraction(c):
    return ref_ep.Contraction(tuple(c.operands), c.output, dict(c.sizes))


BUILTIN = ep.builtin_trace()
CHAIN = ep.Contraction(("ab", "bc", "cd", "de"), "ae",
                       {"a": 4, "b": 32, "c": 3, "d": 32, "e": 4})


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert isinstance(cfg, ModelConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.reduced(cfg)) == \
        dataclasses.asdict(ref_configs.reduced(ref))
    assert (cfg.hd, cfg.padded_vocab, cfg.param_count(),
            cfg.active_param_count()) == \
        (ref.hd, ref.padded_vocab, ref.param_count(),
         ref.active_param_count())
    assert [cfg.layer_is_attn(i) for i in range(cfg.n_layers)] == \
        [ref.layer_is_attn(i) for i in range(ref.n_layers)]
    assert cfg.cdtype == getattr(torch, ref.dtype)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    assert round_up(cfg.vocab_size, 256) == -(-cfg.vocab_size // 256) * 256


# ------------------------------------------------------------- traces
@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_planner_trace_equals_reference(arch, reduce):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    if reduce:
        cfg, ref = configs.reduced(cfg), ref_configs.reduced(ref)
    log, ref_log = ep.ContractionLog(), ref_ep.ContractionLog()
    got = ep.model_planner_trace(cfg, logger=log)
    want = ref_ep.model_planner_trace(ref, logger=ref_log)
    assert [_c(c) for c in got] == [_c(c) for c in want]
    assert [_c(c) for c in log.records] == [_c(c) for c in got]
    assert len(ref_log.records) == len(log.records)


def test_default_and_builtin_traces_equal_reference():
    assert [_c(c) for c in BUILTIN] == [_c(c) for c in
                                        ref_ep.builtin_trace()]
    assert [_c(c) for c in ep.model_planner_trace(layers=2, seq=32)] == \
        [_c(c) for c in ref_ep.model_planner_trace(layers=2, seq=32)]
    small = ModelConfig(name="s", family="moe", n_layers=1, d_model=64,
                        n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=256,
                        n_experts=4, top_k=2)
    ref_small = RefModelConfig(**dataclasses.asdict(small))
    assert [_c(c) for c in ep.model_planner_trace(small)] == \
        [_c(c) for c in ref_ep.model_planner_trace(ref_small)]


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_contraction_log_crosses_packages(tmp_path, direction):
    path = str(tmp_path / "log.json")
    if direction == "port_to_ref":
        log = ep.ContractionLog()
        ep.model_planner_trace(configs.get_config("olmoe-1b-7b"),
                               layers=2, logger=log)
        log.save(path)
        back = ref_ep.ContractionLog.load(path)
    else:
        log = ref_ep.ContractionLog()
        ref_ep.model_planner_trace(ref_configs.get_config("olmoe-1b-7b"),
                                   layers=2, logger=log)
        log.save(path)
        back = ep.ContractionLog.load(path)
    assert [_c(c) for c in back.records] == [_c(c) for c in log.records]
    assert back.records and all(isinstance(s, int) for c in back.records
                                for s in c.sizes.values())


# ---------------------------------------------- tables, graphs, plans
@pytest.mark.parametrize("i", range(len(BUILTIN)))
def test_cardinalities_and_query_graph_equal_reference(i):
    c = BUILTIN[i]
    rc = _ref_contraction(c)
    assert ep.cardinalities(c).tobytes() == ref_ep.cardinalities(rc).tobytes()
    q, rq = ep.query_graph(c), ref_ep.query_graph(rc)
    assert (q.n, q.edges, q.hyperedges) == (rq.n, rq.edges, rq.hyperedges)
    tree, peak, total = ep.greedy_plan(c)
    rtree, rpeak, rtotal = ref_ep.greedy_plan(rc)
    assert (str(tree), peak, total) == (str(rtree), rpeak, rtotal)
    assert ep.plan_to_einsum_calls(c, tree) == \
        ref_ep.plan_to_einsum_calls(rc, rtree)


PLANS = {"max": ("max", {}), "cap": ("cap", {}),
         "out_dpccp": ("out", {"method": "dpccp", "engine": "fused"}),
         "out_dpsub": ("out", {"method": "dpsub"})}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("i", range(len(BUILTIN)))
def test_plan_contraction_equals_reference(i, plan):
    """Optima and trees equal the reference's for C_max (DPconv), C_cap
    and C_out (the fused DPccp program and DPsub; the FFT-embedded
    ``dpconv`` method is for small integral costs, not tensor sizes)."""
    cost, kw = PLANS[plan]
    c = BUILTIN[i]
    got = ep.plan_contraction(c, cost=cost, device=CPU, **kw)
    want = ref_ep.plan_contraction(_ref_contraction(c), cost=cost, **kw)
    assert float(got.cost).hex() == float(want.cost).hex()
    assert str(got.tree) == str(want.tree)
    card = ep.cardinalities(c)
    if cost == "max":
        assert got.cost == dpsub_max(card, c.n)[-1]
    if cost == "cap":
        assert got.tree.cost_max(card) == dpsub_max(card, c.n)[-1]
        assert got.meta["gamma"] == want.meta["gamma"]
    if plan == "out_dpsub":
        assert got.cost == dpsub_out(card, c.n)[-1]


def test_plan_contraction_through_the_server_equals_reference():
    """``server=`` routes through ``PlanServer.plan_one``: the same
    routes, costs, trees and cache hits as the reference server; the
    repeat is a cache hit, and solver kwargs are refused."""
    srv, ref = PlanServer(device=CPU), RefServer()
    log = ep.ContractionLog()
    for c in BUILTIN[:4] + BUILTIN[:4]:
        for cost in ("max", "cap"):
            got = ep.plan_contraction(c, cost=cost, server=srv, logger=log)
            want = ref_ep.plan_contraction(_ref_contraction(c), cost=cost,
                                           server=ref)
            assert float(got.cost).hex() == float(want.cost).hex()
            assert str(got.tree) == str(want.tree)
            assert got.cache_hit == want.cache_hit
            assert (got.route.method, got.route.lane) == \
                (want.route.method, want.route.lane)
    assert srv.cache.stats.hits == ref.cache.stats.hits == 8
    assert len(log.records) == 16
    with pytest.raises(ValueError):
        ep.plan_contraction(BUILTIN[0], server=srv, gamma_batch=2)


def test_einsum_plan_beats_or_ties_greedy():
    """``tests/test_planner.py::test_einsum_plan_beats_or_ties_greedy``
    on the port: optimal peaks never exceed the greedy plan's."""
    rng = np.random.default_rng(0)
    idx = "abcdefg"
    for _ in range(6):
        ops, sizes = [], {}
        for i in range(5):
            a, b = idx[i], idx[i + 1]
            ops.append(a + b)
            sizes[a] = int(rng.integers(2, 64))
            sizes[b] = int(rng.integers(2, 64))
        c = ep.Contraction(tuple(ops), idx[0] + idx[5], sizes)
        res = ep.plan_contraction(c, cost="max", device=CPU)
        assert res.cost <= ep.greedy_plan(c)[1]
        assert res.cost == dpsub_max(ep.cardinalities(c), c.n)[-1]


# -------------------------------------------------------- execution
def _tensors(c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=tuple(c.sizes[i] for i in op))
            for op in c.operands]


def _check_execution(c, cost, seed, device):
    arrays = _tensors(c, seed)
    plan = ep.plan_contraction(c, cost=cost, device=CPU)
    got = ep.execute_plan(c, plan.tree, [torch.as_tensor(a, device=device)
                                         for a in arrays])
    spec = ",".join(c.operands) + "->" + c.output
    want = np.asarray(jnp.einsum(spec, *[jnp.asarray(a) for a in arrays]))
    got = got.cpu().numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=EXEC_RTOL,
                               atol=EXEC_RTOL * scale)


@pytest.mark.parametrize("cost", ["max", "cap"])
def test_execute_plan_matches_jnp_einsum(cost):
    _check_execution(CHAIN, cost, 1, CPU)


def test_execute_plan_on_a_reduced_model_trace():
    """The planned order of every distinct contraction of a reduced
    model's trace, shrunk to a few elements per index, executes to
    ``jnp.einsum``'s result."""
    cfg = configs.reduced(configs.get_config("qwen2-0.5b"))
    seen = set()
    for c in ep.model_planner_trace(cfg, batch=2, seq=4, layers=1):
        key = (c.operands, c.output)
        if key in seen:
            continue
        seen.add(key)
        small = dataclasses.replace(
            c, sizes={k: min(v, 5) for k, v in c.sizes.items()})
        _check_execution(small, "max", len(seen), CPU)


@pytest.mark.cuda
def test_execute_plan_on_card_matches_jnp_einsum(cuda_device):
    _check_execution(CHAIN, "max", 2, cuda_device)


# ------------------------------------------------------- data joins
def _pipeline(mod):
    tables = [mod.Table("examples", ("doc",), 1000),
              mod.Table("docs", ("doc", "src"), 300),
              mod.Table("sources", ("src",), 20),
              mod.Table("quality", ("doc",), 280)]
    joins = [mod.JoinSpec(0, 1, "doc", 1 / 300),
             mod.JoinSpec(1, 2, "src", 1 / 20),
             mod.JoinSpec(1, 3, "doc", 1 / 290)]
    return tables, joins


def _pipeline_data(seed=0):
    rng = np.random.default_rng(seed)
    ex = np.zeros(100, dtype=[("doc", "i8"), ("w", "f8")])
    ex["doc"] = rng.integers(0, 30, 100)
    ex["w"] = rng.random(100)
    dc = np.zeros(30, dtype=[("doc", "i8"), ("src", "i8")])
    dc["doc"] = np.arange(30)
    dc["src"] = rng.integers(0, 5, 30)
    sr = np.zeros(5, dtype=[("src", "i8"), ("lic", "i8")])
    sr["src"] = np.arange(5)
    qu = np.zeros(28, dtype=[("doc", "i8"), ("q", "f8")])
    qu["doc"] = np.arange(28)
    return [ex, dc, sr, qu]


def _rows(res):
    return sorted(tuple(r[k] for k in sorted(res.dtype.names)) for r in res)


@pytest.mark.parametrize("cost", ["max", "cap"])
def test_datajoin_equals_reference(cost):
    tables, joins = _pipeline(dj)
    rtables, rjoins = _pipeline(ref_dj)
    q, card = dj.build_graph(tables, joins)
    rq, rcard = ref_dj.build_graph(rtables, rjoins)
    assert (q.n, q.edges) == (rq.n, rq.edges)
    assert card.tobytes() == rcard.tobytes()
    plan, _ = dj.plan_joins(tables, joins, cost=cost, device=CPU)
    want, _ = ref_dj.plan_joins(rtables, rjoins, cost=cost)
    assert float(plan.cost).hex() == float(want.cost).hex()
    assert str(plan.tree) == str(want.tree)
    if cost == "cap":
        assert plan.meta["gamma"] == dpsub_max(card, 4)[-1]
    data = _pipeline_data()
    res = dj.execute(data, joins, plan.tree)
    ref_res = ref_dj.execute(data, rjoins, want.tree)
    assert res.dtype == ref_res.dtype and res.tobytes() == ref_res.tobytes()
    assert len(res) == int((data[0]["doc"] < 28).sum())


def test_datajoin_through_the_server_and_order_invariance():
    """Through ``server=``: a re-plan of the pipeline with its tables in
    another order is a cache hit, and every join order returns the same
    row multiset."""
    tables, joins = _pipeline(dj)
    srv = PlanServer(device=CPU)
    first, card = dj.plan_joins(tables, joins, cost="cap", server=srv)
    order = [2, 0, 3, 1]
    pos = {old: new for new, old in enumerate(order)}
    tables2 = [tables[i] for i in order]
    joins2 = [dj.JoinSpec(pos[j.left], pos[j.right], j.col, j.selectivity)
              for j in joins]
    again, _ = dj.plan_joins(tables2, joins2, cost="cap", server=srv)
    assert not first.cache_hit and again.cache_hit
    assert float(again.cost).hex() == float(first.cost).hex()
    data = _pipeline_data(3)
    rows = [_rows(dj.execute(data, joins, first.tree)),
            _rows(dj.execute([data[i] for i in order], joins2,
                             again.tree))]
    plan, _ = dj.plan_joins(tables, joins, cost="max", device=CPU)
    rows.append(_rows(dj.execute(data, joins, plan.tree)))
    plan, _ = dj.plan_joins(tables, joins, cost="out", server=srv)
    rows.append(_rows(dj.execute(data, joins, plan.tree)))
    assert all(r == rows[0] for r in rows[1:])
