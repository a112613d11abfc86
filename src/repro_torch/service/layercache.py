"""Layer-granular plan-fragment cache: cross-request incremental planning
(a copy of ``repro.service.layercache``; numpy only).

The plan cache (``service.cache``) reuses *whole* plans: the key is
the full canonical query, and anything short of an isomorphic repeat is a
cold solve.  This tier sits next to it and reuses the DP work itself, at
two granularities:

* **Search fragments** — the C_max optimum of a full canonical query,
  keyed by ``CanonicalForm.key`` alone (no cost/method/params).  DPconv's
  binary search (Alg. 3) and C_cap's pass 1 run the *same* search over
  the same candidate set, so a cached optimum warm-starts either lane:
  the engine collapses the search bracket to the cached value's position
  (``engine._seed_bracket``) and the fused while-loop exits in zero
  rounds.  This is deliberately coarser-keyed than the plan cache —
  a ``cost="cap"`` request warm-starts from a ``cost="max"`` solve the
  plan cache must miss.

* **Value fragments** — ``(2^r,)`` slices of a solved connected-C_out DP
  table, keyed by ``canon.subset_signature``: the canonical form of the
  sub-problem a relation subset *induces* (its edges, hyperedges, and
  the cardinality table over its power set).  ``dp[S]`` is a pure
  function of the induced sub-problem on ``S``, so a byte-exact key
  match transfers bitwise — a new query that shares a sub-structure with
  any previously solved query (the einsum replay lane's bread and
  butter: attention stacks differing by one tensor) seeds its lattice
  program with the solved prefix instead of starting cold
  (``lattice.minplus_connected_layers(seed_vals=, seed_ok=)``).

Fragments are stored in *fragment-canonical* label space and mapped
through each query's subset permutation on insert and probe, so
relabeled sub-structures hit.  Seeds are always a pure performance hint:
every consumer produces bit-identical tables, optima and trees with or
without them (the seeded values equal what the lattice would compute;
``tests/test_torch_layercache.py`` holds the port to that).

Both stores are plain LRU ``OrderedDict``s like the plan cache; stats
register on the server's ``MetricsRegistry`` as the ``layercache``
provider.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import zipfile

import numpy as np

from repro_torch.core.bitset import lattice_map, popcounts
from repro_torch.service.canon import subset_expand, subset_signature

# on-disk fragment-store format version (``save``/``load``): bump on any
# layout change — ``load`` ignores files whose version doesn't match
# (a stale store is a cold start, never a crash or a wrong seed)
STORE_VERSION = 1


@dataclasses.dataclass
class LayerCacheStats:
    search_hits: int = 0
    search_misses: int = 0
    search_inserts: int = 0
    value_hits: int = 0         # fragment probes that found a sub-table
    value_misses: int = 0       # fragment probes that found nothing
    value_inserts: int = 0
    seeded_solves: int = 0      # solves dispatched with >= 1 seed attached
    seeded_sets: int = 0        # lattice sets covered by value seeds
    evictions: int = 0
    admission_skips: int = 0    # inserts skipped for one-off topologies

    @property
    def search_hit_rate(self) -> float:
        t = self.search_hits + self.search_misses
        return self.search_hits / t if t else 0.0

    @property
    def value_hit_rate(self) -> float:
        t = self.value_hits + self.value_misses
        return self.value_hits / t if t else 0.0

    def as_dict(self) -> dict:
        return {"search_hits": self.search_hits,
                "search_misses": self.search_misses,
                "search_inserts": self.search_inserts,
                "search_hit_rate": round(self.search_hit_rate, 4),
                "value_hits": self.value_hits,
                "value_misses": self.value_misses,
                "value_inserts": self.value_inserts,
                "value_hit_rate": round(self.value_hit_rate, 4),
                "seeded_solves": self.seeded_solves,
                "seeded_sets": self.seeded_sets,
                "evictions": self.evictions,
                "admission_skips": self.admission_skips}


def _perm_masks(perm) -> np.ndarray:
    """(2^r,) int64 map: compact subset mask -> its image under ``perm``
    (bit ``i`` -> bit ``perm[i]``)."""
    return lattice_map([1 << int(p) for p in perm])


class LayerCache:
    """The layer-granular fragment tier next to ``PlanCache``.

    ``seed_for`` resolves a request's seed payload at admission (the
    5th batch-item slot ``service.batch.BatchedSolver`` understands);
    ``observe`` harvests fragments from a completed *exact* solve.
    """

    def __init__(self, search_capacity: int = 8192,
                 value_capacity: int = 512, max_n: int = 16,
                 admission_min_probes: int = 16,
                 admission_floor: float = 0.05):
        if search_capacity < 1 or value_capacity < 1:
            raise ValueError("capacities must be >= 1")
        self.search_capacity = search_capacity
        self.value_capacity = value_capacity
        self.max_n = max_n          # value fragments past this n are not
        #                             worth the 2^n probe/scatter work
        # fragment-admission heuristic: per-topology-signature hit
        # history.  A signature whose probes have seen fewer than
        # ``admission_floor`` hits after ``admission_min_probes`` probes
        # is a one-off shape (clique-heavy ad-hoc traffic): its solves
        # stop inserting, so they can't evict fragments that DO repay
        # (``admission_min_probes <= 0`` disables the gate).
        self.admission_min_probes = admission_min_probes
        self.admission_floor = admission_floor
        self._topo: dict = {}       # signature -> [probes, hits]
        self.stats = LayerCacheStats()
        self._search: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()
        self._values: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        # probe memo: a value probe pays n+1 subset canonicalizations,
        # and replay streams repeat canonical forms heavily — memoize
        # (form.key, lane) -> (generation, payload, stat deltas) and
        # replay while the stores are unchanged.  ``_gen`` bumps on any
        # insert of a NEW key and on every eviction, so a memoized miss
        # can never mask a fragment that arrived after it.
        self._gen = 0
        self._probe_memo: dict = {}
        # observe memo: harvesting an out solve pays the same n+1
        # subset canonicalizations as a value probe, and fragments are
        # a pure function of the canonical form — once a form has been
        # harvested and the stores haven't changed since (same ``_gen``:
        # no inserts, no evictions), re-harvesting can only rediscover
        # keys that are all still present, so it is skipped outright.
        self._observed: dict = {}

    def __len__(self) -> int:
        return len(self._search) + len(self._values)

    # ------------------------------------------------------------- probes
    def seed_for(self, form, cost: str) -> "dict | None":
        """The seed payload for a plan-cache miss on ``form``, or None.

        ``cost`` in ``("max", "cap")`` -> ``{"opt": float}``: the cached
        C_max optimum (cap pass 1 IS the max search when the router
        never sets slack, so the two lanes share one fragment).
        ``cost == "out"`` -> ``{"vals": (2^n,) f64, "ok": (2^n,) bool}``
        assembled from the value fragments of the full set and every
        leave-one-out subset.
        """
        lane = "search" if cost in ("max", "cap") else cost
        memo = self._probe_memo.get((form.key, lane))
        if memo is not None and memo[0] == self._gen:
            payload, deltas = memo[1], memo[2]
            for field, d in deltas:
                setattr(self.stats, field, getattr(self.stats, field) + d)
            self._topo_observe(form.signature, payload is not None)
            return payload
        before = dataclasses.asdict(self.stats)
        payload = self._probe(form, cost)
        deltas = tuple((f, v - before[f])
                       for f, v in dataclasses.asdict(self.stats).items()
                       if v != before[f])
        if len(self._probe_memo) > 8192:
            self._probe_memo.clear()
        self._probe_memo[(form.key, lane)] = (self._gen, payload, deltas)
        self._topo_observe(form.signature, payload is not None)
        return payload

    # ------------------------------------------------- admission heuristic
    def _topo_observe(self, signature: str, hit: bool) -> None:
        t = self._topo.get(signature)
        if t is None:
            t = self._topo[signature] = [0, 0]
        t[0] += 1
        if hit:
            t[1] += 1

    def _admit(self, signature: str) -> bool:
        """Should a solve of this topology signature insert fragments?
        Yes until the signature has a probe history; after
        ``admission_min_probes`` probes, only if its hit rate clears
        ``admission_floor`` — one-off shapes stop polluting the LRU."""
        if self.admission_min_probes <= 0:
            return True
        t = self._topo.get(signature)
        if t is None or t[0] < self.admission_min_probes:
            return True
        return t[1] / t[0] >= self.admission_floor

    def _probe(self, form, cost: str) -> "dict | None":
        if cost in ("max", "cap"):
            v = self._search.get(form.key)
            if v is None:
                self.stats.search_misses += 1
                return None
            self._search.move_to_end(form.key)
            self.stats.search_hits += 1
            self.stats.seeded_solves += 1
            return {"opt": float(v)}
        if cost != "out":
            return None
        n = form.q.n
        if n < 3 or n > self.max_n:
            return None
        full = (1 << n) - 1
        vals = np.zeros(1 << n, np.float64)
        ok = np.zeros(1 << n, bool)
        hits = 0
        for mask in [full] + [full ^ (1 << i) for i in range(n)]:
            if ok[mask]:
                # a larger hit fragment already covered this mask's
                # whole power set
                continue
            sf = subset_signature(form.q, form.card, mask)
            frag = self._values.get(sf.key)
            if frag is None:
                self.stats.value_misses += 1
                continue
            self._values.move_to_end(sf.key)
            self.stats.value_hits += 1
            hits += 1
            expand = subset_expand(sf.rels)
            sigma = _perm_masks(sf.perm)
            vals[expand] = frag[sigma]
            ok[expand] = True
        if not hits:
            return None
        # the lattice recurrence starts at layer 2; empty/singleton
        # slots carry base values the program owns
        ok[popcounts(n) < 2] = False
        self.stats.seeded_solves += 1
        self.stats.seeded_sets += int(ok.sum())
        return {"vals": vals, "ok": ok}

    # ------------------------------------------------------------ inserts
    def observe(self, form, cost: str, cost_v: float, meta: dict,
                params: tuple = (), dp=None) -> None:
        """Harvest fragments from one completed exact solve.

        * ``max``: ``cost_v`` is the C_max optimum — a search fragment.
        * ``cap``: ``meta["gamma"]`` is the pass-1 C_max optimum, a
          search fragment too — but only at ``gamma_slack == 1`` (a
          slacked gamma is not the optimum).
        * ``out``: ``dp`` is the solved ``(2^n,)`` connected-C_out value
          table in the query's canonical label space; the full set and
          every leave-one-out subset become value fragments.

        One-off topologies (probe history below the admission floor)
        are skipped entirely — see ``_admit``.
        """
        if not self._admit(form.signature):
            self.stats.admission_skips += 1
            return
        if cost == "max" and np.isfinite(cost_v):
            self._insert_search(form.key, float(cost_v))
            return
        if cost == "cap":
            gamma = meta.get("gamma")
            slack = dict(params).get("gamma_slack", 1.0)
            if gamma is not None and float(slack) == 1.0 \
                    and np.isfinite(gamma):
                self._insert_search(form.key, float(gamma))
            return
        if cost != "out" or dp is None:
            return
        n = form.q.n
        dp = np.asarray(dp, np.float64).reshape(-1)
        if n < 3 or n > self.max_n or dp.shape[0] != (1 << n):
            return
        if self._observed.get(form.key) == self._gen:
            return                      # already harvested, stores stable
        full = (1 << n) - 1
        for mask in [full] + [full ^ (1 << i) for i in range(n)]:
            sf = subset_signature(form.q, form.card, mask)
            if sf.key in self._values:
                self._values.move_to_end(sf.key)
                continue
            expand = subset_expand(sf.rels)
            sigma = _perm_masks(sf.perm)
            frag = np.empty(1 << sf.r, np.float64)
            # fragment-canonical labels: frag[sigma[t]] = dp[expand[t]]
            frag[sigma] = dp[expand]
            self._values[sf.key] = frag
            self.stats.value_inserts += 1
            self._gen += 1
            while len(self._values) > self.value_capacity:
                self._values.popitem(last=False)
                self.stats.evictions += 1
                self._gen += 1
        if len(self._observed) > 8192:
            self._observed.clear()
        self._observed[form.key] = self._gen

    def _insert_search(self, key: str, opt: float) -> None:
        if key in self._search:
            self._search.move_to_end(key)
        else:
            self.stats.search_inserts += 1
            self._gen += 1
        self._search[key] = opt
        while len(self._search) > self.search_capacity:
            self._search.popitem(last=False)
            self.stats.evictions += 1
            self._gen += 1

    def clear(self) -> None:
        self._search.clear()
        self._values.clear()
        self._probe_memo.clear()
        self._observed.clear()
        self._gen += 1

    # -------------------------------------------------------- persistence
    def save(self, path: str) -> int:
        """Write both stores to ``path`` (npz, ``STORE_VERSION``-stamped).

        Keys are hex sha256 strings — stored as fixed-width unicode
        arrays; value fragments are concatenated f64 with an offsets
        array (they have heterogeneous ``2^r`` lengths).  The write is
        atomic (tmp + ``os.replace``) so a crashed replica never leaves
        a truncated store for the next prewarm to trip on.  Returns the
        number of entries written."""
        skeys = np.array(list(self._search.keys()), dtype="U64")
        svals = np.array(list(self._search.values()), np.float64)
        vkeys = np.array(list(self._values.keys()), dtype="U64")
        frags = list(self._values.values())
        offsets = np.zeros(len(frags) + 1, np.int64)
        for i, f in enumerate(frags):
            offsets[i + 1] = offsets[i] + f.shape[0]
        vdata = (np.concatenate(frags) if frags
                 else np.zeros(0, np.float64))
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez_compressed(
                fh, version=np.int64(STORE_VERSION),
                search_keys=skeys, search_vals=svals,
                value_keys=vkeys, value_data=vdata,
                value_offsets=offsets)
        os.replace(tmp, path)
        return len(skeys) + len(vkeys)

    def load(self, path: str) -> int:
        """Restore entries saved by ``save``; returns how many loaded.

        Strictly best-effort: a missing file, a version mismatch, or a
        corrupt archive loads nothing (returns 0) — the store is a
        performance hint, so a cold start is always acceptable.  Entries
        load in saved (LRU) order and respect the current capacities."""
        try:
            with np.load(path) as z:
                if int(z["version"]) != STORE_VERSION:
                    return 0
                skeys = [str(k) for k in z["search_keys"]]
                svals = np.asarray(z["search_vals"], np.float64)
                vkeys = [str(k) for k in z["value_keys"]]
                vdata = np.asarray(z["value_data"], np.float64)
                offsets = np.asarray(z["value_offsets"], np.int64)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            # a truncated write surfaces as BadZipFile, not OSError
            return 0
        if len(skeys) != svals.shape[0] \
                or offsets.shape[0] != len(vkeys) + 1:
            return 0
        loaded = 0
        for k, v in zip(skeys, svals):
            if k not in self._search:
                loaded += 1
            self._search[k] = float(v)
            self._search.move_to_end(k)
        while len(self._search) > self.search_capacity:
            self._search.popitem(last=False)
        for i, k in enumerate(vkeys):
            frag = vdata[offsets[i]:offsets[i + 1]].copy()
            if k not in self._values:
                loaded += 1
            self._values[k] = frag
            self._values.move_to_end(k)
        while len(self._values) > self.value_capacity:
            self._values.popitem(last=False)
        self._gen += 1                  # invalidate probe/observe memos
        return loaded
