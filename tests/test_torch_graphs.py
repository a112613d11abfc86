"""CUDA graphs of the port's whole-solve programs (``core.lattice``).

A program built for one CUDA device with no solve mesh runs its parts
(the search round, the seeded probe, the tail) eagerly at their first
use, captures each as a CUDA graph at its second and replays it from
then on; every other program runs eagerly.
Here, on the CPU: the engagement rule, through the builders and the
engine; the launch counters' capture and replay bookkeeping; and the
graphed call's own control flow (static tensors, input copies, returned
copies) with a stand-in for the graph that runs the captured body at
each replay, against the eager program, bitwise.  On the card
(``cuda``-marked, skipped without one): graphed against eager, bitwise,
in optima, tables, trees, rounds and syncs, over three calls on
different inputs (eager parts, captures, replays); returned tensors
that no later call changes; the engine's counters and launch counts
under replay; and one ``ranked_conv`` launch per convolution layer of
every pass of a fused int32 solve.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine, lattice
from repro_torch.core.bitset import popcounts
from repro_torch.core.querygraph import (chain, clique, cycle,
                                         make_cardinalities, star)
from repro_torch.kernels import build


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


@pytest.fixture
def standin_graphs(monkeypatch):
    """The graphed path on the CPU: ``uses_graphs`` holds for every
    single-device program; a capture keeps the part's body and runs
    nothing, and a replay runs it, writing into the outputs of its first
    replay as a replay writes its pool."""
    monkeypatch.setattr(lattice, "uses_graphs",
                        lambda device, mesh: mesh is None
                        and device is not None)

    def capture(self, body):
        return [body, None, None]

    def replay(self, name):
        part = self._parts[name]
        new = part[0]()
        if part[1] is None:
            part[1] = new
        else:
            for o, v in zip(part[1] or (), new or ()):
                o.copy_(v)
        return part[1]

    monkeypatch.setattr(lattice._Graphs, "_capture", capture)
    monkeypatch.setattr(lattice._Graphs, "_replay", replay)


# ------------------------------------------------------------- inputs
MAKERS = (clique, chain, cycle, star)


def _queries(n: int, B: int, seed: int):
    qs = [MAKERS[(seed + b) % len(MAKERS)](n) for b in range(B)]
    cards = np.stack([np.asarray(make_cardinalities(q, seed=seed + 7 * b),
                                 np.float64) for b, q in enumerate(qs)])
    return qs, cards


def _args(cost: str, n: int, B: int, seed: int, device, seeds=None):
    """A program's inputs for ``B`` (a power of two) queries."""
    qs, cards = _queries(n, B, seed)
    dev = torch.device(device)
    adj = torch.as_tensor(np.stack([q.adjacency() for q in qs]),
                          dtype=torch.int32, device=dev)
    cards_pad, cand, hi0, _, _ = engine._pad_candidates(cards, n)
    if cost == "out" or cost == "out_seeded":
        args = (torch.as_tensor(cards_pad, device=dev), adj)
        if cost == "out_seeded":
            # the cold sweep's values of the sets of up to 3 relations
            dpv = lattice.build_out_program(n, True)(*args)[1]
            pc = torch.as_tensor(popcounts(n), device=dev)
            args += (dpv.contiguous(),
                     (pc <= 3).expand(B, -1).contiguous())
        return args
    lo0, hi0, _ = engine._seed_bracket(cand, hi0, seeds, B)
    args = (torch.as_tensor(cards_pad, device=dev),
            torch.as_tensor(cand, device=dev),
            torch.as_tensor(lo0, device=dev),
            torch.as_tensor(hi0, device=dev))
    if cost.startswith("cap"):
        args += (1.0,)
        if cost.startswith("cap_conn"):
            args += (adj,)
    return args


def _build(cost: str, n: int, tier: str, G: int, device=None):
    seeded = cost.endswith("_seeded")
    base = cost[:-len("_seeded")] if seeded else cost
    if base == "max":
        return lattice.build_max_program(n, 4, tier, True, G, seeded=seeded,
                                         device=device)
    if base in ("cap", "cap_conn"):
        return lattice.build_cap_program(n, 4, tier, True, G,
                                         connected=base == "cap_conn",
                                         seeded=seeded, device=device)
    return lattice.build_out_program(n, True, seeded=seeded, device=device)


def _seeds(n: int, B: int, seed: int, device) -> list:
    """Cached C_max optima for a seeded call: each row's true optimum,
    but the last row's one candidate too high (a stale seed)."""
    opt = _build("max", n, "f64", 1)(*_args("max", n, B, seed, device))[0]
    seeds = [float(v) for v in opt.cpu().numpy()]
    _, cards = _queries(n, B, seed)
    cand = engine.candidate_table(cards[-1], n)
    i = int(np.searchsorted(cand, seeds[-1]))
    seeds[-1] = float(cand[min(i + 1, len(cand) - 1)])
    return seeds


def _call_pair(cost, n, B, tier, G, device, seed):
    """Graphed and eager programs of one bucket, each called on two
    inputs in turn; the graphed call's first results are read again
    after its second call."""
    graphed = _build(cost, n, tier, G, device=device)
    eager = _build(cost, n, tier, G)
    assert graphed.graphed and not eager.graphed
    got, want = [], []
    for s in (seed, seed + 1, seed + 2):
        seeds = _seeds(n, B, s, device) if cost.endswith("_seeded") \
            else None
        args = _args(cost, n, B, s, device, seeds)
        got.append(graphed(*args))
        got[-1] = (got[-1], [x.cpu().clone() if isinstance(x, torch.Tensor)
                             else x for x in got[-1]])
        want.append(eager(*args))
    return got, want


def _assert_pair(got, want):
    for (live, first), w in zip(got, want):
        assert len(live) == len(w)
        for a, b in zip(first, w):
            if isinstance(b, torch.Tensor):
                a_np, b_np = a.numpy(), b.cpu().numpy()
                assert a_np.dtype == b_np.dtype
                assert np.array_equal(a_np, b_np)   # NaN-free: exact
            else:
                assert a == b                       # rounds, syncs
    # each call's tensors hold after the later calls: nothing the program
    # returns aliases its graphs' memory
    for (live, first), (later, _) in zip(got, got[1:]):
        for a, b, c in zip(live, first, later):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.cpu(), b)
                assert a.data_ptr() != c.data_ptr()


# ------------------------------------------------------------ the rule
def test_programs_are_graphed_on_one_cuda_device_only():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert lattice.uses_graphs(cuda, None)
    assert lattice.uses_graphs("cuda", None)
    assert not lattice.uses_graphs(cpu, None)
    assert not lattice.uses_graphs(None, None)
    assert not lattice.uses_graphs(cuda, (cuda, cuda))
    mesh = (cpu, cpu)
    for fn in (lattice.build_max_program(6, 4, "f64", True, device=cpu),
               lattice.build_max_program(6, 4, "f64", True),
               lattice.build_max_program(6, 4, "f64", True, shards=2,
                                         mesh=mesh, device=cuda),
               lattice.build_cap_program(6, 4, "f64", True, shards=2,
                                         mesh=mesh, device=cuda),
               lattice.build_out_program(6, True, shards=2, mesh=mesh,
                                         device=cuda),
               lattice.build_out_program(6, True, device=cpu)):
        assert fn.graphed is False


@pytest.mark.parametrize("cost", ["max", "cap", "out"])
def test_cpu_engine_calls_stay_eager(cost):
    """On the CPU the engine captures nothing and no call replays a
    graph: ``graph_calls`` and ``graph_captures`` stay 0 and every
    record says ``graphed`` False."""
    qs, cards = _queries(6, 3, seed=5)
    engine.reset_stats()
    engine.clear_executable_cache()
    mark = engine.dispatch_mark()
    call = {"max": lambda: engine.fused_dpconv_max(cards, 6, device="cpu"),
            "cap": lambda: engine.fused_ccap(cards, 6, device="cpu"),
            "out": lambda: engine.fused_out(qs, cards, 6, device="cpu")}
    call[cost]()
    call[cost]()
    recs = engine.dispatches_since(mark)
    st = engine.stats()
    assert st.dispatches == 2 and len(recs) == 2
    assert st.graph_calls == 0 and st.graph_captures == 0
    assert not any(r.graphed for r in recs)


def test_launch_counts_under_capture_and_replay():
    """A capture's launches are recorded apart, per thread, and counted
    by each replay: the counts are of kernels launched."""
    build.reset_launch_counts()
    build.count_launch("zeta_cluster")
    with build.recording() as rec:
        build.count_launch("zeta_cluster")
        build.count_launch("ranked_conv")
        build.count_launch("ranked_conv")
    assert rec == {"zeta_cluster": 1, "zeta_high": 0, "ranked_conv": 2,
                   "minplus_layer": 0, "connmask": 0}
    assert build.launch_counts() == {"zeta_cluster": 1, "zeta_high": 0,
                                     "ranked_conv": 0, "minplus_layer": 0,
                                     "connmask": 0}
    build.add_launches(rec)
    build.add_launches(rec)
    assert build.launch_counts() == {"zeta_cluster": 3, "zeta_high": 0,
                                     "ranked_conv": 4, "minplus_layer": 0,
                                     "connmask": 0}
    build.count_launch("zeta_high")           # recording is over
    assert build.launch_counts()["zeta_high"] == 1
    build.reset_launch_counts()


# the stand-in's cases: every program kind, both tiers' plain versions
STANDIN = [("max", "f64", 1), ("max", "f64", 3), ("max", "cuda", 1),
           ("max_seeded", "f64", 1), ("max_seeded", "cuda", 3),
           ("cap", "f64", 1), ("cap_conn", "cuda", 1),
           ("cap_seeded", "f64", 1), ("out", "f64", 1),
           ("out_seeded", "f64", 1)]


@pytest.mark.parametrize("cost,tier,G", STANDIN,
                         ids=[f"{c}-{t}-G{g}" for c, t, g in STANDIN])
def test_graphed_call_flow_matches_eager_on_cpu(standin_graphs, cost, tier,
                                                G):
    replays0, captures0 = lattice.graph_counts()
    got, want = _call_pair(cost, 7, 4, tier, G, "cpu", seed=11)
    _assert_pair(got, want)
    replays, captures = lattice.graph_counts()
    assert captures == captures0 + 1 and replays > replays0


def test_engine_counts_graphed_calls(standin_graphs, monkeypatch):
    """The engine's accounting of a graphed bucket: the build's first
    touch runs the tail eagerly, the first solve captures it, and every
    solve replays (``graph_calls``, ``DispatchRecord.graphed``)."""
    _, cards = _queries(6, 2, seed=4)
    engine.reset_stats()
    engine.clear_executable_cache()
    mark = engine.dispatch_mark()
    fs = [engine.fused_dpconv_max(cards, 6, device="cpu") for _ in range(3)]
    recs = engine.dispatches_since(mark)
    st = engine.stats()
    assert (st.dispatches, st.graph_calls, st.graph_captures) == (3, 3, 1)
    assert all(r.graphed for r in recs)
    monkeypatch.undo()                         # the eager engine
    engine.clear_executable_cache()
    ref = engine.fused_dpconv_max(cards, 6, device="cpu")
    for f in fs:
        assert np.array_equal(f.optima, ref.optima)
        assert (f.rounds, f.syncs) == (ref.rounds, ref.syncs)
        assert [repr(t) for t in f.trees] == [repr(t) for t in ref.trees]
    engine.clear_executable_cache()


def test_graphed_program_refuses_another_bucket(standin_graphs):
    fn = _build("max", 6, "f64", 1, device="cpu")
    fn(*_args("max", 6, 2, 1, "cpu"))
    with pytest.raises(ValueError, match="graphed program takes"):
        fn(*_args("max", 6, 4, 1, "cpu"))


# ------------------------------------------------------------ the card
CARD = ([("max", "f64", 1, n, 1) for n in (16, 17)]
        + [("max", "cuda", 1, n, B) for n in (12, 13, 14, 15)
           for B in (1, 4)]
        + [("max", "cuda", 3, 13, 4), ("max_seeded", "cuda", 1, 13, 4),
           ("max_seeded", "f64", 1, 12, 2),
           ("cap", "cuda", 1, 12, 2), ("cap_conn", "cuda", 1, 12, 2),
           ("cap_seeded", "cuda", 1, 12, 2),
           ("out", "f64", 1, 12, 2), ("out_seeded", "f64", 1, 12, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("cost,tier,G,n,B", CARD,
                         ids=[f"{c}-{t}-G{g}-n{n}-B{b}"
                              for c, t, g, n, b in CARD])
def test_graphed_matches_eager_on_card(cuda_device, cost, tier, G, n, B):
    got, want = _call_pair(cost, n, B, tier, G, cuda_device, seed=n + B)
    torch.cuda.synchronize()
    _assert_pair(got, want)


@pytest.mark.cuda
def test_engine_counts_graph_calls_and_launches_on_card(cuda_device):
    """The engine captures a bucket's graphs at its first solves (the
    tail at the first) and replays them at every call; a graphed call
    counts the kernel launches an eager call of the same program and
    inputs makes."""
    n, B = 13, 4
    _, cards = _queries(n, B, seed=3)
    engine.reset_stats()
    engine.clear_executable_cache()
    mark = engine.dispatch_mark()
    fs = [engine.fused_dpconv_max(cards, n, backend="cuda",
                                  device=cuda_device) for _ in range(2)]
    recs = engine.dispatches_since(mark)
    st = engine.stats()
    assert st.graph_captures == 1 and st.graph_calls == 2
    assert all(r.graphed for r in recs)
    assert np.array_equal(fs[0].optima, fs[1].optima)
    args = _args("max", n, B, 3, cuda_device)
    eager = _build("max", n, "cuda", 1)
    graphed = _build("max", n, "cuda", 1, device=cuda_device)
    for _ in range(3):                         # every part captured
        graphed(*args)
    eager(*args)                               # its initial buffers
    counts = []
    for fn in (eager, graphed):
        before = build.launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        after = build.launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
    assert counts[0] == counts[1] and counts[0]["zeta_cluster"] > 0
    assert out[-2:] == eager(*args)[-2:]       # rounds, syncs


@pytest.mark.cuda
def test_fused_int32_max_launches_ranked_conv_per_layer(cuda_device):
    """A fused int32 max solve at n = 13 launches the ranked-convolution
    kernel once per middle layer and once at the final layer of every
    pass (layers 5..13: four direct layers), eager, captured and
    replayed."""
    n = 13
    _, cards = _queries(n, 4, seed=13)
    engine.fused_dpconv_max(cards, n, backend="cuda", device=cuda_device)
    for _ in range(3):
        before = build.launch_counts()["ranked_conv"]
        fs = engine.fused_dpconv_max(cards, n, backend="cuda",
                                     device=cuda_device)
        torch.cuda.synchronize()
        assert fs.passes == fs.rounds + 1 > 1
        assert build.launch_counts()["ranked_conv"] - before == \
            (n - 4) * fs.passes
