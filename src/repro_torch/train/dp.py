"""Data parallelism over a process group: the port's counterpart of the
reference's FSDP over the data axes, where GSPMD shards the train state
by ``models.sharding``'s rules and inserts the collectives.

At rest every rank holds only its shard of the float32 masters, both
AdamW moments and the ef-sim residual: each leaf is split along the two
dimensions ``sharding.param_placements`` gives (the one the rules map to
the data axes and the one they map to 'model'), into equal contiguous
blocks in rank order, the data block taken within the model block; a
leaf the rules replicate stays whole.  The data-axis collectives run on
the mesh's 'data' group: the ranks of one model index (``train.tp``
runs the 'model' axis).  In a step
(``train.steps.make_train_step(dp=...)``):

  1. each rank all-gathers over 'data' the compute-dtype copy of its
     model blocks of the masters that the step differentiates
     (``gather_leaf``);
  2. it runs its rows of every microbatch, dividing its loss sums by the
     microbatch's valid tokens over all ranks (``all_reduce``);
  3. it reduce-scatters the gradients in float32 (``reduce_grads``;
     replicated leaves are all-reduced);
  4. it applies AdamW to its shards, clipped by the global norm over
     every shard of every rank (``global_norm``).

The collectives are explicit, over the port's parameter dicts, not
FSDP2's ``fully_shard``: the step takes gradients with respect to fresh
leaves it makes each step, not an ``nn.Module``'s parameters.
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` work on dim 0,
so a leaf split along dim d is gathered into (D, ...) and the rank axis
moved to d, and its gradient is laid out as (D, ...) before the
reduce-scatter.  At D = 1 every collective is a copy, and the step
computes what the single-process step computes, bitwise.

``Collectives.log``, a ``CollectiveLog`` (``None``, the default, records
nothing and costs one attribute test; the dry-run sets one on a
rank's groups), records every collective a rank
runs: its kind, the bytes of its result and its group's size, read in
the layout of the reference's ``launch/hlo_parse.py:parse_collectives``
(``stats()``), so that ``link_traffic_bytes`` reads it (the dry-run's
counterpart of the post-SPMD HLO inventory).

``collective_times()`` reads the time of the gathers, reduce-scatters
and all-reduces timed since it was last read (CUDA events around each on
a card, the host clock on the CPU), in two sums: ``collective_s`` adds,
for each collective, the least time any rank of the mesh spent in it,
and ``collective_rank0_s`` adds rank 0's times.  A blocking collective ends
on every rank at once, so a rank that arrives early also times its wait
for the last one; the last to arrive waits for no one, and its time is
the transfer's (with the launch).  The MoE load-balance all-reduces
inside the forward and backward are not timed, nor is a checkpoint's
gather.

A fresh state is built sharded (``keep_blocks`` for ``init_params``):
every leaf is drawn whole, one at a time, and only this rank's block on
both axes is kept, so a rank never holds more than its blocks and one
whole leaf, and the blocks are those of the one-process draw.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import global_norm
from repro_torch.tree import subtree, tree_items, tree_leaves, tree_map


def block_of(a: torch.Tensor, d: "int | None", rank: int,
             world: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``a`` along ``d``, of ``world`` equal
    contiguous blocks in rank order (``a`` itself for ``d=None``)."""
    if d is None:
        return a
    n = a.shape[d] // world
    return a.narrow(d, rank * n, n)


def block_at(a: torch.Tensor, place: tuple, coord: tuple,
           shape: tuple) -> torch.Tensor:
    """The block of ``a`` at mesh coordinates ``coord`` = (d, m) of a
    ('data', 'model') mesh of ``shape``: block m along the model
    dimension ``place[1]``, and block d of that along the data
    dimension ``place[0]``."""
    return block_of(block_of(a, place[1], coord[1], shape[1]), place[0],
                    coord[0], shape[0])


def keep_blocks(params, placements, coord: tuple, shape: tuple):
    """``init_params``'s ``keep`` for the rank at ``coord`` of a mesh of
    ``shape``: for each leaf of ``params`` (shapes, as on ``"meta"``), a
    function taking the whole leaf, of that shape, to a copy of the
    rank's block of it."""
    def one(a, place):
        want = tuple(a.shape)

        def keep(whole):
            if tuple(whole.shape) != want:
                raise ValueError(f"a leaf of {tuple(whole.shape)} was "
                                 f"drawn where {want} was planned")
            part = block_at(whole, place, coord, shape)
            return whole if part is whole else part.clone()
        return keep
    return tree_map(one, params, placements)


def leaves_like(like, tree) -> list:
    """The nodes of ``tree`` at the paths of ``like``'s leaves, in tree
    order (``tree`` may hold tuples, as a tree of placements does)."""
    return [subtree(tree, path) for path, _ in tree_items(like)]


def _seconds(timed) -> float:
    if isinstance(timed, float):
        return timed
    start, end = timed
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


class CollectiveLog:
    """A record of collectives, one ``(kind, result bytes, group size)``
    entry each; kinds are the HLO names ("all-gather", "reduce-scatter",
    "all-reduce")."""

    def __init__(self):
        self.entries: list = []

    def add(self, kind: str, result: torch.Tensor, group_size: int) -> None:
        self.entries.append((kind, result.numel() * result.element_size(),
                             group_size))

    def stats(self) -> dict:
        """``{kind: {"count", "bytes"}, "_avg_group": mean group size}``,
        the layout of the reference's ``parse_collectives``."""
        out: dict = {}
        for kind, nbytes, _ in self.entries:
            s = out.setdefault(kind, {"count": 0, "bytes": 0})
            s["count"] += 1
            s["bytes"] += nbytes
        sizes = [k for _, _, k in self.entries]
        out["_avg_group"] = sum(sizes) / len(sizes) if sizes else 0
        return out


class Collectives:
    """A rank's process group over one mesh axis, and the timing of the
    collectives it runs there (and their record, with ``log``)."""

    log: "CollectiveLog | None" = None      # set per instance

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.device = torch.device(device)
        self._times: list = []      # per timed collective

    def _note(self, kind: str, result: torch.Tensor, world=None) -> None:
        if self.log is not None:
            self.log.add(kind, result, self.world if world is None
                         else world)

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the group, in place; returns it."""
        with self._timed():
            dist.all_reduce(t, op=op, group=self.group)
        self._note("all-reduce", t)
        return t

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

    def _gather(self, a: torch.Tensor, d: int) -> torch.Tensor:
        """The whole of ``a`` from every rank's block of it along ``d``:
        gathered into (world·n, ...) on dim 0, the rank axis moved to
        ``d``."""
        shape = tuple(a.shape)
        out = torch.empty((self.world * shape[0],) + shape[1:],
                          dtype=a.dtype, device=a.device)
        with self._timed():
            dist.all_gather_into_tensor(out, a.contiguous(),
                                        group=self.group)
        self._note("all-gather", out)
        whole = list(shape)
        whole[d] *= self.world
        return out.view((self.world,) + shape).movedim(0, d).reshape(whole)

    def _reduce_scatter(self, g: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's block along ``d`` of the sum of every rank's
        ``g``, laid out as (world·n, ...) for the reduce-scatter.  The
        layout is copied out contiguous: where the leading dimension is
        1 the reshape is a strided view, which NCCL would read as if it
        were contiguous (gloo copies it)."""
        shape = tuple(g.shape)
        n = shape[d] // self.world
        x = g.reshape(shape[:d] + (self.world, n) + shape[d + 1:])
        out = torch.empty(shape[:d] + (n,) + shape[d + 1:], dtype=g.dtype,
                          device=g.device)
        x = x.movedim(d, 0).reshape((self.world * out.shape[0],)
                                    + out.shape[1:]).contiguous()
        with self._timed():
            dist.reduce_scatter_tensor(out, x, group=self.group)
        self._note("reduce-scatter", out)
        return out

    def collective_times(self) -> dict:
        """The collectives timed since the last call, as
        ``{"collective_s", "collective_rank0_s", "own_s"}`` (see the
        module docstring; ``own_s`` is this rank's own sum).  Every rank
        of the mesh must call it: it gathers each rank's times (waiting
        for the card's timed ones to finish); every rank has timed the
        same collectives."""
        mine = [_seconds(t) for t in self._times]
        self._times = []
        if not mine:
            return {"collective_s": 0.0, "collective_rank0_s": 0.0,
                    "own_s": 0.0}
        world = dist.get_world_size()
        t = torch.tensor(mine, dtype=torch.float64, device=self.device)
        every = torch.empty(world * len(mine), dtype=torch.float64,
                            device=self.device)
        dist.all_gather_into_tensor(every, t)
        every = every.view(world, len(mine))
        return {"collective_s": float(every.min(0).values.sum()),
                "collective_rank0_s": float(every[0].sum()),
                "own_s": sum(mine)}


class DataParallel(Collectives):
    """The data-parallel layout of one rank: its 'data' process group,
    its device, where each parameter leaf is split (a tree of (data dim,
    model dim) pairs, ``None`` for a replicated axis, shaped like the
    parameter tree) and the rank's ``train.tp.TensorParallel`` (``None``
    for a mesh without a 'model' axis), whose blocks it keeps at rest."""

    def __init__(self, group, placements, device, tp=None):
        super().__init__(group, device)
        self.placements = placements
        self.tp = tp
        self.coord = (self.rank, 0 if tp is None else tp.rank)
        self.shape = (self.world, 1 if tp is None else tp.world)

    # ------------------------------------------------------- collectives
    def barrier(self) -> None:
        dist.barrier()

    def gather_leaf(self, a: torch.Tensor, d: "int | None") -> torch.Tensor:
        """The leaf's model block from every data rank's block of it
        along ``d``."""
        return a if d is None else self._gather(a, d)

    def reduce_grads(self, grads):
        """Model-block gradients (each rank's rows) -> this rank's
        float32 block of their sum over the data ranks; leaves replicated
        over 'data' all-reduced."""
        def one(g, place):
            g = g.float()
            if place[0] is None:
                return self.all_reduce(g)
            return self._reduce_scatter(g, place[0])
        return tree_map(one, grads, self.placements)

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient from every rank's blocks: each
        rank sums its blocks' squares in tree order (a leaf replicated
        over an axis counts at index 0 of that axis only), and the
        partial sums are all-reduced over the mesh."""
        mine = [g for g, (dd, md) in zip(tree_leaves(grads),
                                         leaves_like(grads, self.placements))
                if (dd is not None or self.coord[0] == 0)
                and (md is not None or self.coord[1] == 0)]

        def reduce(sq):
            sq = torch.as_tensor(sq, dtype=torch.float32, device=self.device)
            with self._timed():
                dist.all_reduce(sq)
            self._note("all-reduce", sq, dist.get_world_size())
            return sq
        return global_norm(mine, all_reduce=reduce)

    # ------------------------------------------------------------- state
    def _state_placements(self, state) -> dict:
        out = {"params": self.placements,
               "opt": {"mu": self.placements, "nu": self.placements,
                       "step": (None, None)}}
        if "residual" in state:
            out["residual"] = self.placements
        return out

    def shard_state(self, state) -> dict:
        """This rank's blocks of a whole train state, copied to its
        device (the whole state may sit on the CPU, as a checkpoint
        loads)."""
        def one(a, place):
            return block_at(a, place, self.coord, self.shape).to(
                self.device, copy=True)
        return tree_map(one, state, self._state_placements(state))

    def gather_state(self, state):
        """The whole train state on the CPU at rank 0 of the mesh
        (``None`` at the other ranks), gathered leaf by leaf over 'data'
        and then over 'model'; every rank takes part."""
        return self.gather_tree(state, self._state_placements(state))

    def gather_tree(self, tree, placements=None):
        """``gather_state`` for any tree of this rank's blocks whose
        leaves lie as ``placements`` says (the parameters' by default):
        copies, which later steps leave as they are; the gathers are not
        timed."""
        tp = self.tp

        def one(a, place):
            whole = self.gather_leaf(a, place[0])
            if tp is not None:
                whole = tp.gather_leaf(whole, place, ("whole", None))
            return (whole.to("cpu", copy=True) if dist.get_rank() == 0
                    else None)
        full = tree_map(one, tree, placements or self.placements)
        self._times = []
        if tp is not None:
            tp._times = []
        return full if dist.get_rank() == 0 else None
