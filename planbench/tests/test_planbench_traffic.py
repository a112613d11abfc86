"""The generator: the same seed gives the same stream, every seed the
same work, and no request it makes routes to an inexact lane."""
import collections

import numpy as np
import pytest

import _planbench_util  # noqa: F401  (import paths)
from pbench.registry import Bench

MIXES = ("fresh", "bigjoin")


def _stream(mix_name, seed, count=None, **over):
    """The first ``count`` requests (default: one block) of a stream."""
    bench = Bench()
    mix = dict(bench.mix(mix_name), **over)
    gen = bench.generator(mix["generator"])
    t = gen.make(mix, seed, 2.0)
    count = count or int(mix.get("block", len(gen._deck(mix))))
    return [next(t.more) for _ in range(count)]


def _key(r):
    return (r.i, r.n, r.edges, r.cost, r.ref, r.card.tobytes())


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_stream(mix):
    a = _stream(mix, 2 ** 31 + 5, count=12)
    b = _stream(mix, 2 ** 31 + 5, count=12)
    assert a and [_key(r) for r in a] == [_key(r) for r in b]
    c = _stream(mix, 2 ** 31 + 6, count=12)
    assert [_key(r) for r in a] != [_key(r) for r in c]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_the_same_work(mix):
    """Each block of a stream holds the same (cost, n) counts for every
    seed; only the order and the draws differ."""
    counts = set()
    for seed in (1, 2, 3, 2 ** 33 + 1):
        s = _stream(mix, seed)
        counts.add(tuple(sorted(collections.Counter(
            (r.cost, r.n) for r in s).items())))
    assert len(counts) == 1
    if mix == "bigjoin":           # a block of four holds each n once
        assert sorted(r.n for r in _stream(mix, 9, count=4)) == [16, 17,
                                                                   18, 19]


def test_cardinalities_follow_the_selectivity_model():
    from pbench import graphs
    rng = np.random.default_rng(0)
    n, edges = 9, graphs.make_edges("sparse", 9, rng)
    card = graphs.cardinalities(n, edges, np.random.default_rng(1))
    rng = np.random.default_rng(1)
    lb = rng.uniform(np.log(1e2), np.log(1e6), n)
    ls = rng.uniform(np.log(1e-4), np.log(1.0), len(edges))
    for S in (3, 77, 300, 511):
        want = sum(lb[i] for i in range(n) if S >> i & 1)
        want += sum(s for (u, v), s in zip(edges, ls)
                    if S >> u & 1 and S >> v & 1)
        assert card[S] == pytest.approx(np.exp(min(max(want, 0.0),
                                                   np.log(1e8))), rel=1e-12)
    full = (1 << n) - 1
    for S in range(1, full):        # submultiplicative on every split
        T = full ^ S
        assert card[full] <= card[S] * card[T] * (1 + 1e-12)


@pytest.mark.parametrize("mix", MIXES)
def test_no_request_routes_to_an_inexact_lane(mix):
    """50 seeds of each mix through the plan service's own router: every
    request is routed to an exact method (never approx or goo)."""
    from repro_torch.core.querygraph import QueryGraph
    from repro_torch.service.canon import topology_signature
    from repro_torch.service.router import Router
    router = Router()
    seen = collections.Counter()
    for seed in range(50):
        for r in _stream(mix, 7919 * seed + 3):
            q = QueryGraph(r.n, r.edges)
            route = router.route(q, r.cost, None,
                                 signature=topology_signature(q))
            assert route.method in ("dpconv", "dpsub", "dpccp"), (
                seed, r.cost, r.n, r.edges, route)
            seen[route.method, route.lane] += 1
    assert seen
