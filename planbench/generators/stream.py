"""The general request generator: every traffic mix is a parameter file
that this module reads (``traffic/<mix>.json``; ``README.md`` lists the
keys).

A stream is an endless sequence of fresh queries, each new to the plan
service, which the closed loops of ``drivers/`` hand out as their
clients ask for the next.  Every seed gets the same work in another
order: the queries come in blocks of ``block`` entries (default: one of
each deck entry), each block's (cost, topology, n) dealt from a deck
whose counts follow the mix's weights exactly (largest remainder), then
shuffled.  Graphs, cardinalities and the orders come from the seed.

Routing safety: a mix's classes state each cost's ``n`` range, so the
generator never builds a request that the plan service would route to
its inexact lanes (``approx``, ``goo``): the test suite checks this for
many seeds against the service's own router.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from pbench import graphs


@dataclasses.dataclass
class Request:
    """One generated request, in plain data.  ``ref`` names the reference
    solve that judges it."""
    i: int
    n: int
    edges: tuple
    card: np.ndarray
    cost: str
    ref: tuple


@dataclasses.dataclass
class Traffic:
    more: object                        # a generator of the requests
    # reference name -> (n, edges, card) of the query it stands for
    refs: dict = dataclasses.field(default_factory=dict)


def _deck(mix: dict) -> list:
    """The weighted (cost, topology, n) entries of the mix."""
    topos = list(mix["topologies"])
    out = []
    for cls in mix["classes"]:
        lo, hi = cls["n"]
        for topo in topos:
            if topo == "grid":
                ns = sorted({r * c for r, c in graphs.grid_shapes(lo, hi)})
            else:
                ns = list(range(max(lo, 3 if topo == "cycle" else 2),
                                hi + 1))
            if not ns:
                continue
            for n in ns:
                out.append(((cls["cost"], topo, n),
                            cls["weight"] / len(topos) / len(ns)))
    total = sum(w for _, w in out)
    return [(e, w / total) for e, w in out]


def deal(entries: list, count: int, rng: np.random.Generator) -> list:
    """``count`` entries in proportion to their weights (largest
    remainder, ties to the earlier entry), shuffled."""
    raw = [w * count for _, w in entries]
    k = [int(math.floor(x)) for x in raw]
    left = count - sum(k)
    order = sorted(range(len(raw)), key=lambda j: (-(raw[j] - k[j]), j))
    for j in order[:left]:
        k[j] += 1
    hand = [e for (e, _), c in zip(entries, k) for _ in range(c)]
    return [hand[int(j)] for j in rng.permutation(len(hand))]


def _query(entry: tuple, mix: dict, rng: np.random.Generator,
           regime: str) -> tuple:
    cost, topo, n = entry
    edges = graphs.make_edges(topo, n, rng)
    base, sel = mix["regimes"][regime]
    card = graphs.cardinalities(n, edges, rng, base_range=tuple(base),
                                selectivity_range=tuple(sel),
                                cap=float(mix.get("card_cap", 1e8)))
    return cost, n, edges, card


def _regimes(mix: dict, count: int, rng: np.random.Generator) -> list:
    names = sorted(mix["regimes"])
    return deal([(r, 1.0 / len(names)) for r in names], count, rng)


def make(mix: dict, seed: int, seconds: float) -> Traffic:
    """The stream of one run: an endless sequence of fresh requests in
    ``more`` (``seconds`` is the window's length, which this stream does
    not need)."""
    rng = np.random.default_rng(seed)
    deck = _deck(mix)
    traffic = Traffic(more=None)
    size = int(mix.get("block", len(deck)))

    def more():
        i = 0
        while True:
            block = deal(deck, size, rng)
            for entry, regime in zip(block, _regimes(mix, len(block), rng)):
                cost, n, edges, card = _query(entry, mix, rng, regime)
                ref = ("f", i)
                traffic.refs[ref] = (n, edges, card)
                yield Request(i=i, n=n, edges=edges, card=card, cost=cost,
                              ref=ref)
                i += 1
    traffic.more = more()
    return traffic
