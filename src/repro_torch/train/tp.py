"""Tensor parallelism over the mesh's 'model' axis: the port's counterpart
of what GSPMD makes of ``models.sharding``'s 'model' rules in the
reference's train step.

Each rank of a 'model' group holds the same rows of the batch and its
1/T of the layers' math (``sharding.tp_plan``): its query heads (and KV
heads when they divide), its ``d_ff`` columns of ``wg``/``wu`` and rows
of ``wd``, its experts, its block of the vocabulary.  A leaf whose split
at rest does not fall on that cut is gathered whole over 'model' before
use (``sharding.model_compute``, ``gathered_leaves``).  The SSM's leaves
are such leaves: its sub-layer runs whole on every model rank.

**Layer boundaries.**  Between sub-layers the residual stream keeps the
reference's layout (``launch/specs.py:act_sharding_for``): ``d_model``
split over 'model' when it divides.  A split sub-layer then starts with
an all-gather of the stream (a reduce-scatter of its gradient) and ends
with a reduce-scatter of its partial sums (an all-gather of their
gradient); one that runs whole starts with the same all-gather (its
gradient is whole on every rank, so the backward takes the rank's slice)
and ends by taking its slice.  Where ``d_model`` does not divide, the
stream is whole on every rank and the pair is Megatron's:
copy-to-parallel (identity forward, all-reduce backward) and
reduce-from-parallel (all-reduce forward, identity backward).  Partial
sums are added in float32 and rounded to the compute dtype once.  The
remat policies recompute these collectives with the rest of a repeat.

**The loss.**  The embedding looks up the tokens of the rank's
vocabulary block (zeros elsewhere) and reduce-scatters into the
boundary layout; the cross-entropy all-reduces, per chunk of tokens and
in float32, the max of the logits, then their sum of exponentials
together with the label's logit from the rank that owns it
(``vocab_ce``).  Its backward is ``torch.logsumexp``'s, so at T = 1 the
step is that of one process, bitwise.

**Gradients.**  Each model rank differentiates the same loss.  A leaf
the rank holds a block of at compute time has a whole gradient for that
block.  A leaf it holds whole has, in a split sub-layer, a part of the
gradient (the norms fed by split activations, the router, KV columns
read by some ranks' heads), which ``reduce_grads`` sums over 'model'
(a reduce-scatter onto the rank's block at rest, or an all-reduce);
in a sub-layer that runs whole, the whole gradient, of which the rank
keeps its block.  The MoE load-balance loss is computed alike on every
model rank of a split MoE, so its gradient is scaled by 1/T there.

At T = 1 the same code runs and every collective is a copy.
``collective_times()`` reads the 'model' collectives as
``train.dp.DataParallel`` reads the 'data' ones.

**Serving** (``train.steps.make_prefill_step``/``make_decode_step`` with
this handle) runs forward only and holds no optimizer, so a rank's
compute leaves are made once, at load (``serve_leaf``): gathered over
'data' and, where their split at rest is storage-only, over 'model', and
the rank's part kept.  KV columns (KV heads that do not divide T) are
kept whole: a decode whose cache splits its sequence over 'model' writes
every KV head of the new entry (``narrow_kv`` gives the prefill its
columns).  The prefill runs the training forward (the boundary layout).
A decode step has S = 1 and no boundary layout: the residual stream is
whole on every rank, the embedding is looked up in the rank's
vocabulary block and summed (``embed_rows``), a split sub-layer's
output (attention's ``wo``, the MLP's ``wd``, the local experts) is
all-reduced in float32 and rounded once (``reduce``), and the
vocabulary blocks of the logits are gathered (``gather_vocab``).  The
cache lies as ``sharding.cache_placements`` says (``transformer.
init_cache`` returns it with its placements); where its sequence axis
is split, ``models.attention`` combines the ranks' partial softmaxes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function

from repro_torch.models import sharding as shd
from repro_torch.models.transformer import init_params
from repro_torch.train.dp import Collectives, DataParallel, block_of
from repro_torch.tree import tree_map


# ------------------------------------------------------------ activations
class _Gather(Function):
    """All-gather along the last dim; backward reduce-scatters (``sum``)
    or takes the rank's slice."""

    @staticmethod
    def forward(ctx, x, tp, sum_back):
        ctx.tp, ctx.sum_back = tp, sum_back
        return tp._gather_last(x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return (tp._scatter_last(g) if ctx.sum_back
                else tp._slice_last(g)), None, None


class _Scatter(Function):
    """Reduce-scatters (``sum``) or slices along the last dim; backward
    all-gathers."""

    @staticmethod
    def forward(ctx, y, tp, sum_fwd):
        ctx.tp = tp
        return tp._scatter_last(y) if sum_fwd else tp._slice_last(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._gather_last(g), None, None


class _Copy(Function):
    """Copy-to-parallel: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum(g), None


class _Reduce(Function):
    """Reduce-from-parallel: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, y, tp):
        return tp._sum(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


class _VocabCE(Function):
    """(logsumexp, label logit) of logits split over the vocabulary."""

    @staticmethod
    def forward(ctx, logits, idx, owned, tp):
        # torch.logsumexp's arithmetic, with the max and the sum taken
        # over every rank's block
        m = torch.amax(logits, dim=-1, keepdim=True)
        tp.all_reduce(m, op=dist.ReduceOp.MAX)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = torch.exp(logits - m).sum(-1)
        ll = torch.gather(logits, 1, idx[:, None])[:, 0]
        both = tp.all_reduce(torch.stack([s, torch.where(owned, ll, 0)]))
        lse = both[0].log().add_(m[:, 0])
        ctx.save_for_backward(logits, idx, owned, lse)
        return lse, both[1].clone()

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        logits, idx, owned, lse = ctx.saved_tensors
        grad = g_lse[:, None] * (logits - lse[:, None]).exp()
        grad.scatter_add_(1, idx[:, None],
                          torch.where(owned, g_ll, 0)[:, None])
        return grad, None, None, None


class TensorParallel(Collectives):
    """The 'model' layout of one rank: its group, its device, the plan
    of which sub-layers split (``sharding.tp_plan``), and per parameter
    leaf its placement at rest (``sharding.param_placements``: (data
    dim, model dim) pairs) and its compute (``sharding.model_compute``).
    It holds the mesh (``mesh``) and the rank's ``DataParallel`` over the
    mesh's data axes (``data``), by which a decode cache is laid out."""

    def __init__(self, mesh, cfg, placements, compute, device):
        super().__init__(mesh.get_group("model"), device)
        self.mesh = mesh
        self.plan = shd.tp_plan(cfg, self.world)
        self.hd = cfg.hd
        self.heads = (cfg.n_heads, cfg.n_kv_heads)
        self.placements = placements
        self.compute = compute
        self.data = DataParallel(data_group(mesh), placements, device,
                                 tp=self)

    # ------------------------------------------------------- collectives
    def _gather_last(self, x):
        return self._gather(x, x.ndim - 1)

    # partial sums over 'model' are added in float32 and rounded to the
    # compute dtype once, as one card's products add every head and
    # d_ff column in float32 and round once (added in bf16, the ring's
    # roundings put a (1, 4) mesh's first bf16 gradient norm 2.2e-3
    # from one card's at qwen3-0.6b's width)
    def _scatter_last(self, y):
        return self._reduce_scatter(y.float(), y.ndim - 1).to(y.dtype)

    def _sum(self, y):
        return self.all_reduce(y.float().clone()).to(y.dtype)

    def _slice_last(self, y):
        return block_of(y, y.ndim - 1, self.rank, self.world).contiguous()

    # ------------------------------------------------ sub-layer boundaries
    def enter(self, x, split: bool):
        """The whole activations a sub-layer reads, from the boundary
        layout; ``split`` says whether its math is split over 'model'."""
        if self.plan["layout"]:
            return _Gather.apply(x, self, split)
        return _Copy.apply(x, self) if split else x

    def leave(self, y, split: bool):
        """A sub-layer's output (partial sums when ``split``, else whole)
        into the boundary layout."""
        if self.plan["layout"]:
            return _Scatter.apply(y, self, split)
        return _Reduce.apply(y, self) if split else y

    def local(self, x):
        """The rank's part of whole activations that need no gradient
        (the sinusoidal positions) in the boundary layout."""
        return self._slice_last(x) if self.plan["layout"] else x

    def embed(self, table, tokens):
        """Rows of ``tokens`` from the rank's block of the embedding
        (whole table when the vocabulary is not split), in the boundary
        layout."""
        if not self.plan["vocab"]:
            return self.leave(table[tokens], False)
        n = table.shape[0]
        ids = tokens - self.rank * n
        owned = (ids >= 0) & (ids < n)
        x = torch.where(owned[..., None], table[ids.clamp(0, n - 1)], 0)
        return self.leave(x, True)

    def vocab_ce(self, logits, labels):
        """(logsumexp, label logit) per row of float32 ``logits`` of the
        rank's vocabulary block, over the whole vocabulary."""
        n = logits.shape[-1]
        ids = labels - self.rank * n
        owned = (ids >= 0) & (ids < n)
        return _VocabCE.apply(logits, ids.clamp(0, n - 1), owned, self)

    def scale_grad(self, x, s: float):
        return _ScaleGrad.apply(x, s)

    def experts(self, n_local: int) -> int:
        """The first expert of the rank's block of ``n_local``."""
        return self.rank * n_local if self.plan["moe"] else 0

    # ------------------------------------------------------------ leaves
    def gather_leaf(self, a, place, comp):
        """The leaf the rank computes with, from its block at rest over
        'model' (already gathered over 'data'): the block itself, or the
        whole leaf gathered along its model dimension."""
        if not shd.is_gathered(place, comp):
            return a
        return self._gather(a, place[1])

    def kv_columns(self) -> tuple:
        """The first and last + 1 KV columns the rank's query heads read,
        where the KV heads are not split."""
        H, K = self.heads
        hl, g = H // self.world, H // K
        lo = self.rank * hl // g
        hi = ((self.rank + 1) * hl - 1) // g + 1
        return lo * self.hd, hi * self.hd

    def view(self, c, place, comp):
        """The part of a compute leaf ``c`` (``gather_leaf``'s) that the
        model reads: a block of a leaf gathered or whole along another
        dimension than its split at rest, or KV columns."""
        kind, d = comp
        if kind == "kv":
            lo, hi = self.kv_columns()
            return c.narrow(d, lo, hi - lo)
        if kind == "block" and place[1] != d:
            return block_of(c, d, self.rank, self.world)
        return c

    # ----------------------------------------------------------- serving
    def serving_leaves(self, blocks):
        """The rank's serving leaves from its blocks at rest on both axes
        (``serve_leaf`` of each leaf gathered over 'data' by ``data``,
        the mesh's ``DataParallel``): made once, at load."""
        dp = self.data
        return tree_map(lambda a, place, comp: self.serve_leaf(
            self.gather_leaf(dp.gather_leaf(a, place[0]), place, comp),
            place, comp), blocks, dp.placements, self.compute)

    def serve_leaf(self, c, place, comp):
        """Serving's leaf from a compute leaf ``c`` (``gather_leaf``'s):
        the part the model reads (``view``), copied out of a gathered
        whole leaf so that the whole is freed; KV columns stay whole."""
        if comp[0] == "kv":
            return c
        v = self.view(c, place, comp)
        return c if v is c else v.contiguous()

    def narrow_kv(self, params):
        """Views of serving's leaves as the prefill reads them: the KV
        columns of the rank's query heads."""
        if not (self.plan["attn"] and not self.plan["kv"]):
            return params
        lo, hi = self.kv_columns()
        return tree_map(lambda c, comp: c.narrow(comp[1], lo, hi - lo)
                        if comp[0] == "kv" else c, params, self.compute)

    def reduce(self, y, split: bool):
        """A decode sub-layer's output, whole on every rank: the ranks'
        partial sums added (in float32, rounded once) where ``split``."""
        return self._sum(y) if split else y

    def embed_rows(self, table, tokens):
        """Whole embedding rows of ``tokens`` on every rank, from the
        rank's vocabulary block (the decode's lookup)."""
        if not self.plan["vocab"]:
            return table[tokens]
        n = table.shape[0]
        ids = tokens - self.rank * n
        owned = (ids >= 0) & (ids < n)
        return self._sum(torch.where(owned[..., None],
                                     table[ids.clamp(0, n - 1)], 0))

    def gather_vocab(self, logits):
        """Whole logits from each rank's vocabulary block (last dim)."""
        return self._gather_last(logits) if self.plan["vocab"] else logits

    def gather_heads(self, q):
        """A decode step's query heads (B, 1, H/T, hd) of every rank, as
        (B, 1, H, hd)."""
        return self._gather(q, 2)

    def reduce_grads(self, grads):
        """Gradients of the compute leaves -> float32 gradients of the
        rank's blocks at rest over 'model' (still whole over 'data')."""
        def one(g, place, comp):
            g, d = g.float(), place[1]
            if comp == ("block", d):
                return g
            if comp[0] == "whole":
                return g if d is None else block_of(
                    g, d, self.rank, self.world).contiguous()
            if d is None:
                return self.all_reduce(g)
            return self._reduce_scatter(g, d)
        return tree_map(one, grads, self.placements, self.compute)


def data_group(mesh):
    """The process group over a ``DeviceMesh``'s data axes ('pod' and
    'data', flattened into one where both are there) at this rank."""
    axes = shd.data_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def mesh_layout(cfg, mesh, device) -> tuple:
    """This rank's ``(DataParallel, TensorParallel)`` on a ('data',
    'model') ``DeviceMesh`` (or ('pod', 'data', 'model'), whose data
    axes act as one): the placements and compute of ``cfg``'s parameter
    leaves on it, the data group and the model group.  The
    ``TensorParallel`` also lists the gathered leaves (``gathered``)."""
    shapes = init_params(cfg, device="meta")
    places = shd.param_placements(mesh, shapes)
    compute = shd.model_compute(cfg, mesh, shapes)
    tp = TensorParallel(mesh, cfg, places, compute, device)
    tp.gathered = shd.gathered_leaves(shapes, places, compute)
    return tp.data, tp
