"""Meta-tensor stand-ins and placements for every dry-run cell
(counterpart of ``repro.launch.specs``).

``build_cell(cfg, shape, mesh)`` returns ``(step_fn, args, placements)``
for the rank of ``mesh`` (a ``DeviceMesh`` over a process group of the
mesh's size: the fake backend's, in the dry-run) that this process is:
its arguments are tensors on the ``meta`` device at that rank's local
shapes (the reference's ``ShapeDtypeStruct``s of the whole arrays with
their shardings), built from the real init functions on ``meta``
(``init_params``, ``init_opt_state``, ``init_cache``), so the dry-run
runs what training and serving would run, and allocates nothing.

  * train: the rank's blocks at rest of the float32 masters and both
    moments (``sharding.param_placements`` on both axes) and its rows of
    the batch (the batch is whole on every rank where the data axes do
    not divide a microbatch, as the reference's ``batch_spec`` falls
    back), stepped by ``make_train_step`` with the mesh's
    ``train.dp.DataParallel`` and ``train.tp.TensorParallel``;
  * prefill and decode: the rank's parameter blocks at rest, as the
    reference's cells take them, and its rows of tokens (and, for
    decode, its block of the cache, ``init_cache(tp=...)``).  The step
    is a ``ServeCell``: ``load`` makes the serving leaves once (the
    gathers over 'data' and 'model'; serving holds no optimizer, so
    they are not repeated per step) and ``step`` is
    ``make_prefill_step``/``make_decode_step`` with the 'model' handle.

``act_sharding_for`` is the layer-boundary layout that ``train.tp`` keeps
(its plan's ``layout``), as a spec.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train import steps as steps_mod
from repro_torch.tree import subtree, tree_items, tree_map


def accum_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Gradient-accumulation (microbatching) schedule: keeps per-chip
    activation memory bounded for the large configs."""
    tokens = shape.seq_len * shape.global_batch
    big = cfg.d_model >= 4096 or cfg.param_count() > 2e10
    if shape.kind != "train":
        return 1
    if big:
        return 8
    if tokens > 2 ** 21:
        return 4
    return 1


def act_sharding_for(cfg: ModelConfig, mesh, batch: int) -> tuple:
    """Layer-boundary activation layout: batch on the data axes, embed on
    'model' where ``train.tp`` keeps it split (its plan's ``layout``)."""
    da = shd.data_axes(mesh)
    dp = math.prod(shd._sizes(mesh)[a] for a in da)
    tp = shd._sizes(mesh).get("model", 1)
    b_ax = (da if len(da) > 1 else da[0]) if batch % dp == 0 else None
    d_ax = "model" if tp > 1 and shd.tp_plan(cfg, tp)["layout"] else None
    return (b_ax, None, d_ax)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _blocks(tree, placements, mesh):
    """Meta tensors of this rank's blocks of ``tree``'s leaves."""
    return tree_map(lambda a, place: _meta(
        shd.block_shape(a.shape, place, mesh), a.dtype), tree, placements)


def cache_bytes_at_rest(cfg: ModelConfig, mesh, batch: int,
                        max_seq: int) -> int:
    """The bytes of a rank's block of the decode cache as
    ``sharding.cache_placements`` places it (the reference's argument
    bytes; the SSM's leaves split as ``cache_specs`` says)."""
    whole = tfm.init_cache(cfg, batch, max_seq, device="meta")
    places = shd.cache_placements(mesh, whole, batch)
    return sum(math.prod(shd.block_shape(a.shape, subtree(places, path),
                                         mesh)) * a.element_size()
               for path, a in tree_items(whole))


class ServeCell:
    """A serve step on a rank's parameter blocks at rest: ``load`` makes
    its serving leaves (``train.tp.TensorParallel.serving_leaves``),
    ``step`` runs on them; calling it does both."""

    def __init__(self, step, tp):
        self.step, self.load = step, tp.serving_leaves

    def __call__(self, params, *rest):
        return self.step(self.load(params), *rest)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               opt_cfg: OptConfig | None = None,
               accum: int | None = None,
               loss_chunk: int = 512,
               opts: dict | None = None, log=None):
    """-> (fn, args tuple of meta tensors, placements tuple).

    opts: {"attn_scheme": ..., "remat": ...} — the §Perf knobs.  A
    placement is a ``(data dim, model dim)`` pair per leaf (``None``
    where an axis replicates it).  ``log`` (a ``train.dp.CollectiveLog``)
    records every collective the rank's 'data' and 'model' groups run."""
    from repro_torch.train.tp import mesh_layout
    opt_cfg = opt_cfg or OptConfig()
    opts = opts or {}
    attn_scheme = opts.get("attn_scheme", "simple")
    remat = opts.get("remat", "full")
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.cdtype
    dp, tp = mesh_layout(cfg, mesh, "meta")
    dp.log = tp.log = log
    whole = tfm.init_params(cfg, device="meta")
    params = _blocks(whole, dp.placements, mesh)

    def rows(batch: int) -> tuple:
        """This rank's rows of ``batch`` and their placement's dim."""
        return (batch // dp.world, 0) if batch % dp.world == 0 else (
            batch, None)

    if shape.kind == "train":
        accum = accum or accum_for(cfg, shape)
        mb, d = rows(B // accum)
        state = {"params": params, "opt": init_opt_state(params)}
        batch = {"tokens": _meta((accum * mb, S), torch.int64),
                 "labels": _meta((accum * mb, S), torch.int64)}
        bplace = {"tokens": (d, None), "labels": (d, None)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((accum * mb, cfg.n_frames,
                                     cfg.d_model), dt)
            bplace["frames"] = (d, None)
        fn = steps_mod.make_train_step(
            cfg, opt_cfg, accum=accum, loss_chunk=loss_chunk,
            attn_scheme=attn_scheme, remat=remat, dp=dp, tp=tp)
        return (fn, (state, batch),
                (dp._state_placements(state), bplace))

    b, d = rows(B)
    if shape.kind == "prefill":
        fn = ServeCell(steps_mod.make_prefill_step(
            cfg, attn_scheme=attn_scheme, tp=tp), tp)
        args = (params, _meta((b, S), torch.int64))
        places = (dp.placements, (d, None))
        if cfg.family == "encdec":
            args += (_meta((b, cfg.n_frames, cfg.d_model), dt),)
            places += ((d, None),)
        return fn, args, places

    # decode: one new token against a KV cache of seq_len
    cache = tfm.init_cache(cfg, B, S, device="meta", tp=tp)
    fn = ServeCell(steps_mod.make_decode_step(cfg, tp=tp), tp)
    tok = _meta((b,), torch.int64)
    return (fn, (params, cache, tok, tok.clone()),
            (dp.placements, cache.places, (d,), (d,)))
