"""Data parallelism over a process group: the port's counterpart of the
reference's FSDP over the data axes, where GSPMD shards the train state
by ``models.sharding``'s rules and inserts the collectives.

At rest every rank holds only its shard of the float32 masters, both
AdamW moments and the ef-sim residual: each leaf is split along the
dimension ``sharding.param_placements`` gives (the one the rules map to
the data axes), into equal contiguous blocks in rank order; a leaf the
rules replicate stays whole on every rank.  In a step
(``train.steps.make_train_step(dp=...)``):

  1. each rank all-gathers the compute-dtype copy of the masters that
     the step differentiates (``gather_leaf``);
  2. it runs its rows of every microbatch, dividing its loss sums by the
     microbatch's valid tokens over all ranks (``all_reduce``);
  3. it reduce-scatters the gradients in float32 (``reduce_grads``;
     replicated leaves are all-reduced);
  4. it applies AdamW to its shards, clipped by the global norm over
     every shard (``global_norm``).

The collectives are explicit, over the port's parameter dicts, not
FSDP2's ``fully_shard``: the step takes gradients with respect to fresh
leaves it makes each step, not an ``nn.Module``'s parameters.
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` work on dim 0,
so a leaf split along dim d is gathered into (D, ...) and the rank axis
moved to d, and its gradient is laid out as (D, ...) before the
reduce-scatter.  At D = 1 every collective is a copy, and the step
computes what the single-process step computes, bitwise.

``collective_times()`` reads the time of the gathers, reduce-scatters
and all-reduces timed since it was last read (CUDA events around each on
a card, the host clock on the CPU), in two sums: ``collective_s`` adds,
for each collective, the least time any rank spent in it, and
``collective_rank0_s`` adds rank 0's times.  A blocking collective ends
on every rank at once, so a rank that arrives early also times its wait
for the last one; the last to arrive waits for no one, and its time is
the transfer's (with the launch).  The MoE load-balance all-reduces
inside the forward and backward are not timed, nor is a checkpoint's
gather.

A fresh state is built sharded (``keep_blocks`` for ``init_params``):
every leaf is drawn whole, one at a time, and only this rank's block is
kept, so a rank never holds more than its blocks and one whole leaf, and
the blocks are those of the one-process draw.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves, tree_map


def block_of(a: torch.Tensor, d: "int | None", rank: int,
             world: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``a`` along ``d``, of ``world`` equal
    contiguous blocks in rank order (``a`` itself for ``d=None``)."""
    if d is None:
        return a
    n = a.shape[d] // world
    return a.narrow(d, rank * n, n)


def keep_blocks(params, placements, rank: int, world: int):
    """``init_params``'s ``keep`` for one rank: for each leaf of
    ``params`` (shapes, as on ``"meta"``), a function taking the whole
    leaf, of that shape, to a copy of the rank's block of it."""
    def one(a, d):
        shape = tuple(a.shape)

        def keep(whole):
            if tuple(whole.shape) != shape:
                raise ValueError(f"a leaf of {tuple(whole.shape)} was "
                                 f"drawn where {shape} was planned")
            return whole if d is None else block_of(
                whole, d, rank, world).clone()
        return keep
    return tree_map(one, params, placements)


def _seconds(timed) -> float:
    if isinstance(timed, float):
        return timed
    start, end = timed
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


class DataParallel:
    """The data-parallel layout of one rank: its process group, its
    device and where each parameter leaf is split (a tree of ``int``
    dimensions, ``None`` for a replicated leaf, shaped like the
    parameter tree)."""

    def __init__(self, group, placements, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.placements = placements
        self.device = torch.device(device)
        self._times: list = []      # per timed collective

    # ------------------------------------------------------------ timing
    @contextlib.contextmanager
    def _timed(self):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._times.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._times.append(time.perf_counter() - t0)

    def collective_times(self) -> dict:
        """The collectives timed since the last call, as
        ``{"collective_s", "collective_rank0_s"}`` (see the module
        docstring).  Every rank must call it: it gathers each rank's
        times (waiting for the card's timed ones to finish)."""
        mine = [_seconds(t) for t in self._times]
        self._times = []
        if not mine:
            return {"collective_s": 0.0, "collective_rank0_s": 0.0}
        t = torch.tensor(mine, dtype=torch.float64, device=self.device)
        every = torch.empty(self.world * len(mine), dtype=torch.float64,
                            device=self.device)
        dist.all_gather_into_tensor(every, t, group=self.group)
        every = every.view(self.world, len(mine))
        return {"collective_s": float(every.min(0).values.sum()),
                "collective_rank0_s": float(every[0].sum())}

    # ------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place; returns ``t``."""
        with self._timed():
            dist.all_reduce(t, group=self.group)
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def gather_leaf(self, a: torch.Tensor, d: "int | None") -> torch.Tensor:
        """The whole leaf from every rank's block of it along ``d``."""
        if d is None:
            return a
        shape = tuple(a.shape)
        out = torch.empty((self.world * shape[0],) + shape[1:],
                          dtype=a.dtype, device=a.device)
        with self._timed():
            dist.all_gather_into_tensor(out, a.contiguous(),
                                        group=self.group)
        whole = list(shape)
        whole[d] *= self.world
        return out.view((self.world,) + shape).movedim(0, d).reshape(whole)

    def _reduce_scatter(self, g: torch.Tensor, d: int) -> torch.Tensor:
        shape = tuple(g.shape)
        n = shape[d] // self.world
        x = g.reshape(shape[:d] + (self.world, n) + shape[d + 1:])
        out = torch.empty(shape[:d] + (n,) + shape[d + 1:], dtype=g.dtype,
                          device=g.device)
        x = x.movedim(d, 0).reshape((self.world * out.shape[0],)
                                    + out.shape[1:])
        with self._timed():
            dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def reduce_grads(self, grads):
        """Whole-leaf gradients (each rank's rows) -> this rank's float32
        block of their sum over the ranks; replicated leaves whole."""
        def one(g, d):
            g = g.float()
            if d is None:
                return self.all_reduce(g)
            return self._reduce_scatter(g, d)
        return tree_map(one, grads, self.placements)

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient from every rank's blocks: each
        rank sums its blocks' squares in tree order (rank 0 adds the
        replicated leaves), and the partial sums are all-reduced."""
        mine = [g for g, d in zip(tree_leaves(grads),
                                  tree_leaves(self.placements))
                if d is not None or self.rank == 0]

        def reduce(sq):
            sq = torch.as_tensor(sq, dtype=torch.float32, device=self.device)
            return self.all_reduce(sq)
        return global_norm(mine, all_reduce=reduce)

    # ------------------------------------------------------------- state
    def _state_placements(self, state) -> dict:
        out = {"params": self.placements,
               "opt": {"mu": self.placements, "nu": self.placements,
                       "step": None}}
        if "residual" in state:
            out["residual"] = self.placements
        return out

    def shard_state(self, state) -> dict:
        """This rank's blocks of a whole train state, copied to its
        device (the whole state may sit on the CPU, as a checkpoint
        loads)."""
        def one(a, d):
            return block_of(a, d, self.rank, self.world).to(
                self.device, copy=True)
        return tree_map(one, state, self._state_placements(state))

    def gather_state(self, state):
        """The whole train state on the CPU at rank 0 (``None`` at the
        other ranks), gathered leaf by leaf."""
        def one(a, d):
            whole = self.gather_leaf(a, d)
            return whole.cpu() if self.rank == 0 else None
        full = tree_map(one, state, self._state_placements(state))
        self._times = []            # a checkpoint's gathers are not timed
        return full if self.rank == 0 else None
