"""LRU plan cache with hit/miss/eviction stats and relabeling-aware reuse
(a copy of ``repro.service.cache``; stdlib only).

Entries live in *canonical* label space (see ``service.canon``): the
cache key is ``(canonical query key, cost fn, method, params)`` and the
stored plan's join tree uses canonical relation labels.  A request that is
a relabeling of a cached query therefore hits, and the server replays the
plan by mapping the tree back through the request's inverse permutation —
the cost value needs no adjustment because the canonical cardinality table
is the exact byte-permutation of the request's.

The cache is a plain ``OrderedDict`` LRU: ``lookup`` refreshes recency,
``insert`` evicts the least-recently-used entry past ``capacity``.  A
plan for n relations is O(n) tree nodes + a float, so even a 100k-entry
cache is megabytes — capacity exists to bound canonicalization metadata,
not memory pressure.
"""
from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    relabel_hits: int = 0       # hits whose request labeling != canonical
    degraded_skips: int = 0     # degraded entries withheld from exact probes
    remote_inserts: int = 0     # entries published by another replica
    cross_hits: int = 0         # hits served from a remote-origin entry

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "relabel_hits": self.relabel_hits,
                "degraded_skips": self.degraded_skips,
                "remote_inserts": self.remote_inserts,
                "cross_hits": self.cross_hits,
                "hit_rate": round(self.hit_rate, 4)}


@dataclasses.dataclass
class CachedPlan:
    """A plan in canonical label space."""
    cost: float
    tree: object            # JoinTree with canonical labels (or None)
    meta: dict
    # the request->canonical permutation of the request that INSERTED the
    # entry; a later hit whose permutation differs was issued under a
    # different labeling — i.e. a reuse a naive exact-key cache would miss
    inserted_perm: tuple = ()
    # plan provenance: "exact" (bit-identical to the exact solve) or
    # "degraded" (certified best-effort — GOO lane, deadline- or
    # failure-driven).  A degraded entry must never be served to a
    # request able to wait for the exact solve (cache poisoning);
    # ``lookup`` withholds it unless the probe opts in.
    status: str = "exact"
    # which replica solved it: "local", or the publishing replica's id
    # for entries that arrived over the cluster's shared-cache tier —
    # a hit on a non-local entry is a cross-replica hit (one replica's
    # DPconv solve answering another replica's traffic)
    origin: str = "local"


class PlanCache:
    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: "collections.OrderedDict[tuple, CachedPlan]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def make_key(canon_key: str, cost: str, method: str,
                 params: tuple = ()) -> tuple:
        return (canon_key, cost, method, tuple(params))

    def lookup(self, key: tuple,
               request_perm: "tuple | None" = None,
               count_miss: bool = True,
               accept_degraded: bool = False) -> "CachedPlan | None":
        """``request_perm``: the requester's canonical permutation; a hit
        whose entry was inserted under a different permutation counts as
        a relabel hit (cross-labeling plan reuse).  ``count_miss=False``
        suppresses the miss counter for secondary probes (the server's
        degraded-route probe after a primary miss), so one request never
        records two misses.  ``accept_degraded=False`` (the default)
        treats a ``status == "degraded"`` entry as a miss: an
        exact-capable request misses through to a fresh exact solve
        (whose insert then replaces the degraded entry) instead of being
        served a poisoned best-effort plan; deadline-pressed probes opt
        in with ``accept_degraded=True``."""
        entry = self._entries.get(key)
        if entry is None:
            if count_miss:
                self.stats.misses += 1
            return None
        if entry.status == "degraded" and not accept_degraded:
            self.stats.degraded_skips += 1
            if count_miss:
                self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        if request_perm is not None and \
                tuple(request_perm) != tuple(entry.inserted_perm):
            self.stats.relabel_hits += 1
        if entry.origin != "local":
            self.stats.cross_hits += 1
        return entry

    def peek(self, key: tuple) -> "CachedPlan | None":
        """Inspect an entry without touching stats or LRU recency (the
        server uses it to keep a degraded insert from clobbering an
        exact entry)."""
        return self._entries.get(key)

    def insert(self, key: tuple, plan: CachedPlan) -> None:
        if plan.origin != "local":
            self.stats.remote_inserts += 1
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = plan
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def clear(self) -> None:
        self._entries.clear()
