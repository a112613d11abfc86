"""The C_cap and sparse C_out cells (``plansvc.bigjoin-cap``,
``plansvc.sparse-outcap``): their mixes route every request to an exact
lane over many seeds and deal every seed the same work; a small run of
each on the CPU is correct, and its traced run reports what the CPU can
read; the (min,+) sweep's readers on made-up runs, and their None where
the program has no sweep kernel or no sweep fields."""
import collections
import math
import types

import pytest

from _planbench_util import run_small

from pbench import work
from pbench.registry import Bench

MIXES = ("bigjoin-cap", "sparse-outcap")
SMALL = {
    "plansvc.bigjoin-cap": {"classes": [{"cost": "cap", "weight": 1.0,
                                         "n": [8, 9]}], "block": 2},
    "plansvc.sparse-outcap": {"classes": [
        {"cost": "out", "weight": 0.5, "n": [7, 8]},
        {"cost": "cap", "weight": 0.5, "n": [7, 8]}], "clients": 4},
}


def _stream(mix_name, seed, count=None):
    bench = Bench()
    mix = bench.mix(mix_name)
    gen = bench.generator(mix["generator"])
    t = gen.make(mix, seed, 2.0)
    count = count or int(mix.get("block", len(gen._deck(mix))))
    return [next(t.more) for _ in range(count)]


@pytest.mark.parametrize("mix", MIXES)
def test_no_request_routes_to_an_inexact_lane(mix):
    """60 seeds through the plan service's own router: every request goes
    to an exact method, C_cap at n 12..19 to the fused batch lane."""
    from repro_torch.core.querygraph import QueryGraph
    from repro_torch.service.canon import topology_signature
    from repro_torch.service.router import Router
    router = Router()
    seen = collections.Counter()
    for seed in range(60):
        for r in _stream(mix, 7919 * seed + 2 ** 31 + 5):
            q = QueryGraph(r.n, r.edges)
            route = router.route(q, r.cost, None,
                                 signature=topology_signature(q))
            assert route.method in ("dpconv", "dpccp"), (seed, r, route)
            assert route.lane == "batch", (seed, r.cost, r.n, route)
            seen[r.cost, route.method] += 1
    want = {"bigjoin-cap": {("cap", "dpconv")},
            "sparse-outcap": {("cap", "dpconv"), ("out", "dpccp")}}[mix]
    assert set(seen) == want


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_the_same_work(mix):
    counts = set()
    for seed in (1, 2, 2 ** 33 + 1):
        counts.add(tuple(sorted(collections.Counter(
            (r.cost, r.n) for r in _stream(mix, seed)).items())))
    assert len(counts) == 1
    if mix == "bigjoin-cap":
        assert sorted(r.n for r in _stream(mix, 9, count=4)) == [16, 17,
                                                                   18, 19]
    else:
        s = _stream(mix, 3)
        assert collections.Counter(r.cost for r in s) == {"out": 8,
                                                          "cap": 8}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_run_is_correct(workload):
    rc, res, err = run_small(workload, overrides=SMALL[workload])
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {"plansvc.bigjoin-cap": "plans_per_s.large",
           "plansvc.sparse-outcap": "plans_per_s.svc"}[workload]
    assert set(res["metrics"]) == {e2e, "setup_s"}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_small_run_reads_the_sweep_counts(workload):
    """On the CPU the sweep runs its plain version: the live share reads,
    the kernel's roofline and share read None and are left out; every
    other per-layer metric that lists the cell reads."""
    rc, res, err = run_small(workload, overrides=SMALL[workload], trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    m = res["metrics"]
    kernel = {"minplus_roofline.cap", "minplus_roofline.svc",
              "minplus_share_pct.cap", "minplus_share_pct.svc"}
    for name in kernel:
        assert name not in m
    listed = {x["name"] for x in Bench().spec["per_layer"]
              if workload in x.get("workloads", ())}
    assert set(m) == listed - kernel
    if workload == "plansvc.bigjoin-cap":
        live = m["engine.sweep_live_pct.cap"]["value"]
        assert 0.0 < live <= 100.0
        assert "engine.graphed_call_pct.large" in m
    else:
        assert "engine.execute_ms_per_query.svc" in m


def test_bigjoin_cap_ends_before_set_up_where_the_host_answers():
    """A program whose router sends C_cap at n = 19 to the host pipeline
    (here a CPU server, whose gather sweep keeps the ceiling at 13) does
    not run this configuration: the run ends with exit code 4 before the
    prewarm, having measured nothing."""
    import time
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exc:
        run_small("plansvc.bigjoin-cap", overrides={})
    assert exc.value.code == 4
    assert time.perf_counter() - t0 < 30.0


@pytest.mark.parametrize("ceiling,off_card", [
    (19, []), (18, [("cap", 19)]), (13, [("cap", 19)])])
def test_closed_card_names_the_classes_the_host_would_answer(ceiling,
                                                              off_card):
    import torch
    from pbench import program
    bench = Bench()
    srv = program.make_server(bench.config("bigjoin-cap-clique"),
                              torch.device("cpu"))
    srv.router.config.fused_cap_max_n = ceiling
    mix = bench.mix("bigjoin-cap")
    assert mix["loop"] == "closed_card"
    assert bench.driver("closed_card").host_classes(
        srv, mix["classes"]) == off_card


# ------------------------------------------------------- made-up runs
def _reader(name):
    return Bench().reader(name)


def _rec(cost, n, B, sets=None, total=None):
    r = types.SimpleNamespace(cost=cost, n=n, B=B)
    if total is not None:
        r.sweep_sets, r.sweep_total = sets, total
    return r


def _run(recs, ops=()):
    kernel_s = sum(b - a for a, b, _, k in ops if k)
    dt = types.SimpleNamespace(ops=list(ops), kernel_s=kernel_s)
    return types.SimpleNamespace(devtrace=dt,
                                 dispatches=types.SimpleNamespace(
                                     records=list(recs)))


KNAME = "(anonymous namespace)::minplus_layer_kernel<false, false>(double*"


def test_sweep_work_counts_each_unordered_split_once():
    mod = _reader("minplus_roofline.cap")
    n = 6
    splits = sum(math.comb(n, k) * (2 ** (k - 1) - 1) for k in range(2, 7))
    assert splits == (3 ** n - 2 ** (n + 1) + 1) // 2
    assert mod.sweep_work(n, 3, "cap") == (2 * 3 * splits,
                                           3 * 64 * (8 + 1 + 8 + 8))
    assert mod.sweep_work(n, 1, "out_seeded") == (2 * splits,
                                                  64 * (8 + 2 + 8 + 8))
    assert mod.sweep_work(n, 4, "max") == (0.0, 0.0)
    ops, nbytes = mod.sweep_work(19, 1, "cap")
    assert mod.least_s(19, 1, "cap") == ops / work.F64_OPS_PER_S
    assert ops / work.F64_OPS_PER_S > nbytes / work.HBM_BYTES_PER_S


def test_sweep_readers_on_a_made_up_run():
    mod = _reader("minplus_roofline.cap")
    recs = [_rec("cap", 16, 1, 100, 400), _rec("max", 16, 1),
            _rec("out_seeded", 12, 4, 50, 100)]
    least = mod.least_s(16, 1, "cap") + mod.least_s(12, 4, "out_seeded")
    ops = [(0.0, 0.002, KNAME, True), (0.002, 0.010, "zeta", True),
           (0.010, 0.011, "Memcpy HtoD", False)]
    run = _run(recs, ops)
    for name in ("minplus_roofline.cap", "minplus_roofline.svc"):
        assert _reader(name).read(run) == pytest.approx(
            100.0 * least / 0.002)
    for name in ("minplus_share_pct.cap", "minplus_share_pct.svc"):
        assert _reader(name).read(run) == pytest.approx(20.0)
    # a max record carries no sweep fields: the live share reads None
    assert _reader("engine.sweep_live_pct.cap").read(run) is None
    run = _run([recs[0], _rec("max", 16, 1, 0, 0), recs[2]], ops)
    assert _reader("engine.sweep_live_pct.cap").read(run) == \
        pytest.approx(100.0 * 150 / 500)


def test_sweep_readers_read_none_on_a_program_without_them():
    """The parent's case: no sweep kernel in the trace, records without
    the sweep fields, or no records: every reader returns None."""
    recs = [_rec("cap", 16, 1)]
    ops = [(0.0, 0.002, "at::native::gather", True)]
    for run in (_run(recs, ops), _run([], ops), _run(recs, ()),
                types.SimpleNamespace(devtrace=None, dispatches=None)):
        for name in ("minplus_roofline.cap", "minplus_roofline.svc",
                     "minplus_share_pct.cap", "minplus_share_pct.svc",
                     "engine.sweep_live_pct.cap"):
            assert _reader(name).read(run) is None, name
