"""Join tree extraction — Alg. 2 of the paper.

DPconv keeps no OPT table; the optimal bushy tree is reconstructed from the
DP table afterwards: for each set S find a split T with
``DP[S] = c(S) ⊗ DP[T] ⊗ DP[S\\T]`` and recurse.  Worst case O(2^n n).

A copy of ``repro.core.jointree`` (numpy only): the port never imports
``repro``, whose ``core`` package turns on JAX at import.  Keep the two
in step; ``tests/test_torch_*.py`` hold them equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitset import popcount_int


@dataclasses.dataclass(frozen=True)
class JoinTree:
    """Bushy binary join tree over relation bitmasks."""

    mask: int
    left: "JoinTree | None" = None
    right: "JoinTree | None" = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def leaves(self) -> list:
        if self.is_leaf:
            return [self.mask]
        return self.left.leaves() + self.right.leaves()

    def internal_masks(self) -> list:
        """Masks of all internal (join) nodes, root included."""
        if self.is_leaf:
            return []
        return (self.left.internal_masks() + self.right.internal_masks()
                + [self.mask])

    def cost_out(self, card: np.ndarray) -> float:
        """C_out (Eq. 3): sum of intermediate join cardinalities."""
        return float(sum(card[m] for m in self.internal_masks()))

    def cost_max(self, card: np.ndarray) -> float:
        """C_max (Eq. 4): largest intermediate join cardinality."""
        ms = self.internal_masks()
        return float(max(card[m] for m in ms)) if ms else 0.0

    def cost_smj(self, card: np.ndarray) -> float:
        """Sort-merge-join cost (Eq. 9)."""
        if self.is_leaf:
            return 0.0
        cl, cr = card[self.left.mask], card[self.right.mask]
        return (cl * np.log2(max(cl, 2.0)) + cr * np.log2(max(cr, 2.0))
                + self.left.cost_smj(card) + self.right.cost_smj(card))

    def validate(self) -> bool:
        """Leaves are singletons and partition the root mask."""
        ls = self.leaves()
        ok = all(popcount_int(m) == 1 for m in ls)
        acc = 0
        for m in ls:
            if acc & m:
                return False
            acc |= m
        return ok and acc == self.mask

    def __repr__(self) -> str:  # compact s-expr
        if self.is_leaf:
            return f"R{self.mask.bit_length() - 1}"
        return f"({self.left!r} ⋈ {self.right!r})"


def _submask_iter(s: int):
    t = (s - 1) & s
    while t:
        yield t
        t = (t - 1) & s


# Count of host-side recursive extractions (Alg. 2 with per-node submask
# search).  The fused engine snapshots this around its tree assembly to
# prove its "zero per-solve host recursions" invariant
# (engine.stats().host_extractions) — ``tree_from_split_arrays`` does
# not count, it only replays device-found splits.
_RECURSIVE_EXTRACTIONS = 0


def recursive_extractions() -> int:
    return _RECURSIVE_EXTRACTIONS


def _count_recursive_extraction() -> None:
    global _RECURSIVE_EXTRACTIONS
    _RECURSIVE_EXTRACTIONS += 1


def tree_from_split_arrays(nodes: np.ndarray,
                           lidx: np.ndarray) -> JoinTree:
    """Assemble a JoinTree from the on-device extraction scan's split
    arrays (``lattice.extract_scan``): ``nodes[r]`` is slot r's set mask
    (0 = unused slot), ``lidx[r]`` its left-child slot (0 = leaf).

    A single reverse linear pass — children always live at higher slot
    indices than their parent — so the host does no submask search and
    no recursion: Alg. 2 already ran on device.
    """
    M = len(nodes)
    built: list = [None] * M
    for r in range(M - 1, -1, -1):
        m = int(nodes[r])
        if m == 0:
            continue
        li = int(lidx[r])
        built[r] = JoinTree(m) if li == 0 else \
            JoinTree(m, built[li], built[li + 1])
    return built[0]


def extract_tree_feasibility(dp: np.ndarray, card: np.ndarray,
                             n: int) -> JoinTree:
    """Alg. 2 for the C_max feasibility table (dp ∈ {0,1})."""
    _count_recursive_extraction()

    def build(s: int) -> JoinTree:
        if popcount_int(s) == 1:
            return JoinTree(s)
        for t in _submask_iter(s):
            if dp[t] > 0.5 and dp[s & ~t] > 0.5:
                return JoinTree(s, build(t), build(s & ~t))
        raise RuntimeError(f"no feasible split for {s:b} — corrupt DP table")
    full = (1 << n) - 1
    assert dp[full] > 0.5, "full set infeasible — wrong gamma"
    return build(full)


def extract_tree_out(dp: np.ndarray, card: np.ndarray, n: int,
                     tol: float = 1e-6) -> JoinTree:
    """Alg. 2 for a C_out value table: DP[S] = c(S) + DP[T] + DP[S\\T]."""
    _count_recursive_extraction()

    def build(s: int) -> JoinTree:
        if popcount_int(s) == 1:
            return JoinTree(s)
        target = dp[s] - card[s]
        best_t, best_err = None, np.inf
        for t in _submask_iter(s):
            err = abs(dp[t] + dp[s & ~t] - target)
            if err < best_err:
                best_t, best_err = t, err
        if best_t is None or best_err > tol * max(1.0, abs(target)):
            raise RuntimeError(f"no split matches DP[{s:b}]")
        return JoinTree(s, build(best_t), build(s & ~best_t))
    return build((1 << n) - 1)


def extract_tree_max(dp: np.ndarray, card: np.ndarray, n: int) -> JoinTree:
    """Alg. 2 for a C_max value table: DP[S] = max(c(S), DP[T], DP[S\\T])."""
    _count_recursive_extraction()

    def build(s: int) -> JoinTree:
        if popcount_int(s) == 1:
            return JoinTree(s)
        for t in _submask_iter(s):
            if max(card[s], dp[t], dp[s & ~t]) == dp[s]:
                return JoinTree(s, build(t), build(s & ~t))
        raise RuntimeError(f"no split matches DP[{s:b}]")
    return build((1 << n) - 1)
