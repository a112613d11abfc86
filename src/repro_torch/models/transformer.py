"""Model assembly for every architecture family (counterpart of
``repro.models.transformer``): dense, moe, ssm, hybrid, encdec and vlm.

Layer-plan segmentation: the layer stack is grouped into *segments* of
identical repeating patterns, e.g. gemma3's 5-local:1-global becomes
``[(4 repeats, [L,L,L,L,L,G]), (1 repeat, [L,L])]``.  Every slot's
window, theta and kind is static, so sliding-window attention visits
only in-window kv blocks and local decode caches are ring buffers of
window length.

Parameters are nested dicts of tensors with the reference's paths and
shapes: ``(d_in, d_out)`` matrices, and a leading ``(repeats,)`` axis on
the leaves of each segment slot.  The reference's ``lax.scan`` over
repeats is a Python loop over that axis.  ``LM`` holds such a tree as an
``nn.Module``.  ``unroll`` is accepted and changes nothing (there is no
compiled loop); ``act_sharding`` must be ``None``.

``remat`` is the reference's policy for one repeat of a segment (its
scan body), applied when gradients are recorded: ``True``/``"full"``
recomputes the repeat in the backward pass
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` saves the
outputs of the non-batched matrix products (``aten.mm``/``addmm``) and
recomputes the rest (selective checkpointing, the counterpart of
``dots_with_no_batch_dims_saveable``), anything else saves everything.
Under ``torch.no_grad`` (the serving paths) nothing is wrapped.

Decode caches mirror the segment structure as in the reference, and
``decode_step`` updates them in place (the reference returns a new
pytree); it returns the cache it was given.

Under tensor parallelism over 'model' (a ``train.tp.TensorParallel``
handle, ``tp``) ``init_cache`` builds a rank's block of the cache and
``decode_step`` runs a rank's part of the step (see ``train.tp``'s
"Serving"): heads, ``d_ff`` and experts split as in training, the
residual stream whole, split outputs all-reduced per token.  The cache
lies as ``sharding.cache_specs`` says (batch on the data axes; KV heads
on 'model' when they divide, else the sequence axis, and then the ranks
combine their partial softmaxes, ``attention._attend_one``), except the
SSM's ``state`` and ``conv``: the SSM runs whole on every model rank, as
in training, so they stay whole over 'model' (``cache_specs`` splits the
state's heads and the conv channels, which mix x, B and C and do not
fall on the heads).  Without ``tp`` every result is what it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import sharding as shd
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (BlockGenerator, ModelConfig,
                                       dense_init, full, normal, rms_norm,
                                       sinusoidal_at, sinusoidal_positions)
from repro_torch.tree import tree_map, tree_map_with_path


# ------------------------------------------------------------- layer plan
@dataclasses.dataclass(frozen=True)
class Slot:
    kind: str                  # "attn" | "ssm"
    window: int = 0            # 0 = global
    theta: float = 1e4
    moe: bool = False
    shared_attn: bool = False  # hybrid: apply shared block after this slot
    cross: bool = False        # enc-dec decoder slot


def layer_plan(cfg: ModelConfig) -> list:
    """Returns [(repeats, [Slot, ...]), ...] covering cfg.n_layers."""
    if cfg.family in ("ssm", "hybrid"):
        period = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        if period:
            slots = [Slot("ssm")] * (period - 1) + \
                [Slot("ssm", shared_attn=True)]
            full_, rem = divmod(cfg.n_layers, period)
            plan = [(full_, slots)]
            if rem:
                plan.append((1, [Slot("ssm")] * rem))
            return plan
        return [(cfg.n_layers, [Slot("ssm")])]

    if cfg.window_size > 0 and cfg.global_every > 0:
        period = cfg.global_every
        local = Slot("attn", window=cfg.window_size,
                     theta=cfg.rope_theta_local, moe=bool(cfg.n_experts))
        glob = Slot("attn", window=0, theta=cfg.rope_theta,
                    moe=bool(cfg.n_experts))
        slots = [local] * (period - 1) + [glob]
        full_, rem = divmod(cfg.n_layers, period)
        plan = [(full_, slots)]
        if rem:
            plan.append((1, [local] * rem))
        return plan

    slot = Slot("attn", window=cfg.window_size, theta=cfg.rope_theta,
                moe=bool(cfg.n_experts), cross=(cfg.family == "encdec"))
    return [(cfg.n_layers, [slot])]


def enc_plan(cfg: ModelConfig) -> list:
    return [(cfg.n_enc_layers, [Slot("attn", window=0,
                                     theta=cfg.rope_theta)])]


# ------------------------------------------------------------------- init
def _init_slot(cfg: ModelConfig, slot: Slot, gen: torch.Generator,
               repeats: int) -> dict:
    D, lead = cfg.d_model, (repeats,)
    if slot.kind == "ssm":
        return {"ln": full(lead, (D,), 0.0, gen),
                "ssm": ssm_mod.init_ssm(cfg, gen, lead)}
    p = {"ln1": full(lead, (D,), 0.0, gen),
         "attn": attn_mod.init_attention(cfg, gen, lead=lead),
         "ln2": full(lead, (D,), 0.0, gen)}
    if slot.cross:
        p["ln_x"] = full(lead, (D,), 0.0, gen)
        p["cross"] = attn_mod.init_attention(cfg, gen, lead=lead)
    if slot.moe:
        p["mlp"] = mlp_mod.init_moe(cfg, gen, lead)
    else:
        p["mlp"] = mlp_mod.init_mlp(cfg, gen, lead)
    return p


def _init_segment(cfg: ModelConfig, repeats: int, slots: list,
                  gen: torch.Generator) -> dict:
    return {f"slot{si}": _init_slot(cfg, slot, gen, repeats)
            for si, slot in enumerate(slots)}


class _MetaGenerator:
    """Stands in for a generator on the meta device, which has none."""
    device = torch.device("meta")


def _in_draw_order(tree):
    """The leaves of a tree in its insertion order: the order in which
    ``init_params`` draws them."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _in_draw_order(v)
    else:
        yield tree


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                keep=None) -> dict:
    """Random float32 parameters drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (CUDA unless given).  The values differ
    from the reference's ``jax.random`` draws; the shapes and paths are
    the same (``convert.lm_params_from_reference`` carries the
    reference's values over).  On ``device="meta"`` it builds the shapes
    alone, allocating and drawing nothing (the reference's
    ``jax.eval_shape``).

    ``keep``, a tree shaped like the parameters (as one built on
    ``"meta"``), holds for each leaf a function from the whole leaf to
    the part of it to build: the leaves are then drawn one at a time and
    only those parts are held (``common.BlockGenerator``), equal to the
    parts of the whole draw."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = _MetaGenerator()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if keep is not None:
            gen = BlockGenerator(gen, _in_draw_order(keep))
    V, D = cfg.padded_vocab, cfg.d_model
    params: dict[str, Any] = {
        "embed": normal(gen, (V, D)) * 0.02,
        "final_norm": full((), (D,), 0.0, gen),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, D, V)
    params["segments"] = [_init_segment(cfg, r, slots, gen)
                          for r, slots in layer_plan(cfg)]
    if cfg.family == "hybrid":
        params["shared_block"] = {
            "ln1": full((), (D,), 0.0, gen),
            "attn": attn_mod.init_attention(cfg, gen),
            "ln2": full((), (D,), 0.0, gen),
            "mlp": mlp_mod.init_mlp(cfg, gen),
        }
    if cfg.family == "encdec":
        params["encoder"] = {
            "segments": [_init_segment(cfg, r, slots, gen)
                         for r, slots in enc_plan(cfg)],
            "final_norm": full((), (D,), 0.0, gen),
        }
    if isinstance(gen, BlockGenerator):
        gen.check_done()
    return params


# ------------------------------------------------------- the nn.Module view
class _Tree(nn.Module):
    """One node of a parameter tree: tensor leaves are parameters, dicts
    and lists are submodules, under the tree's own keys."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, list)
        items = enumerate(tree) if self._is_list else tree.items()
        self._keys = []
        for key, val in items:
            name = str(key)
            self._keys.append(name)
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))
            else:
                self.add_module(name, _Tree(val))

    def tree(self):
        vals = [getattr(self, k) for k in self._keys]
        vals = [v.tree() if isinstance(v, _Tree) else v for v in vals]
        return vals if self._is_list else dict(zip(self._keys, vals))


class LM(nn.Module):
    """A model's parameters as an ``nn.Module`` (``.to(device)``,
    ``state_dict``).  The ``state_dict`` keys are the reference's pytree
    paths under ``tree.`` (``tree.segments.0.slot0.attn.wq``), every leaf
    with the reference's shape.  ``params()`` gives the nested dict that
    the functions of this module take; they also take the ``LM``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    def params(self) -> dict:
        return self.tree.tree()


def _as_tree(params):
    return params.params() if isinstance(params, LM) else params


def _layer(tree, r: int):
    """Repeat ``r`` of a stacked segment subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------- forward
def _split(tp, kind: str) -> bool:
    """Whether a sub-layer of ``kind`` splits its math over 'model'."""
    return tp is not None and tp.plan[kind]


def enter(tp, x, split: bool):
    """``tp.enter`` (``train.tp``); without ``tp``, a view of ``x``.  A
    view so that the gradients of a sub-layer's reads of ``x`` add up
    before they meet the residual's, as they do behind ``tp.enter``: the
    sums then round alike, and one rank of a (1, 1) mesh computes what
    one process does, bitwise."""
    return x.view_as(x) if tp is None else tp.enter(x, split)


def leave(tp, y, split: bool):
    """``tp.leave``, or ``y`` itself without ``tp``."""
    return y if tp is None else tp.leave(y, split)


def _apply_slot(sp: dict, slot: Slot, x, positions, cfg, shared,
                enc_out=None, enc_pos=None, attn_scheme: str = "simple",
                dp_group=None, tp=None):
    """One sub-layer application (training/prefill path).  Under tensor
    parallelism ``x`` is in the boundary layout, and each sub-layer reads
    it whole and adds its output back (``train.tp``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if slot.kind == "ssm":
        h = ssm_mod.ssm_forward(sp["ssm"],
                                rms_norm(enter(tp, x, False), sp["ln"]), cfg)
        x = x + leave(tp, h, False)
    else:
        a = _split(tp, "attn")
        h, _ = attn_mod.attn_forward(
            sp["attn"], rms_norm(enter(tp, x, a), sp["ln1"]), positions,
            cfg, window=slot.window, theta=slot.theta, scheme=attn_scheme)
        x = x + leave(tp, h, a)
        if slot.cross and enc_out is not None:
            hx, _ = attn_mod.attn_forward(
                sp["cross"], rms_norm(enter(tp, x, a), sp["ln_x"]),
                positions, cfg, window=0, enc_out=enc_out, enc_pos=enc_pos)
            x = x + leave(tp, hx, a)
        if slot.moe:
            m = _split(tp, "moe")
            h, aux = mlp_mod.moe_forward(
                sp["mlp"], rms_norm(enter(tp, x, m), sp["ln2"]), cfg,
                group=dp_group, tp=tp)
        else:
            m = _split(tp, "mlp")
            h = mlp_mod.mlp_forward(sp["mlp"],
                                    rms_norm(enter(tp, x, m), sp["ln2"]))
        x = x + leave(tp, h, m)
    if slot.shared_attn and shared is not None:
        a, m = _split(tp, "attn"), _split(tp, "mlp")
        h, _ = attn_mod.attn_forward(
            shared["attn"], rms_norm(enter(tp, x, a), shared["ln1"]),
            positions, cfg, window=0, theta=cfg.rope_theta,
            scheme=attn_scheme)
        x = x + leave(tp, h, a)
        h = mlp_mod.mlp_forward(shared["mlp"],
                                rms_norm(enter(tp, x, m), shared["ln2"]))
        x = x + leave(tp, h, m)
    return x, aux


def _unstack(tree, repeats: int) -> list:
    """The ``repeats`` subtrees of a stacked segment, as views.  One
    ``unbind`` per leaf: its backward stacks the per-repeat gradients
    once, where indexing each repeat would add a leaf-sized gradient per
    repeat."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, repeats) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(repeats)]
    return list(tree.unbind(0))


def _dots_policy(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(body, remat):
    """``body`` under the reference's remat policy (see the module
    docstring)."""
    if not torch.is_grad_enabled() or remat not in (True, "full", "dots"):
        return body
    kw = {"context_fn": _save_dots} if remat == "dots" else {}
    return lambda *args: checkpoint(body, *args, use_reentrant=False,
                                    preserve_rng_state=False, **kw)


def _run_stack(segments_params: list, plan: list, x, positions, cfg,
               shared=None, enc_out=None, enc_pos=None,
               remat: bool = True, act_sharding=None,
               unroll: bool = False, attn_scheme: str = "simple",
               dp_group=None, tp=None):
    """The layer stack, one repeat of a segment at a time under
    ``remat``; ``unroll`` changes nothing (no compiled loop).
    ``dp_group`` sums the MoE load-balance statistics over data-parallel
    ranks (``mlp.moe_forward``).  With ``tp`` (``train.tp``) ``x`` and
    the output are in the layer-boundary layout, under every remat
    policy (a repeat's collectives are recomputed with it)."""
    if act_sharding is not None:
        raise ValueError("act_sharding has no counterpart in the port; "
                         "pass None")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_p, (repeats, slots) in zip(segments_params, plan):
        def body(h, layer_p, slots=slots):
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            for si, slot in enumerate(slots):
                h, a = _apply_slot(layer_p[f"slot{si}"], slot, h,
                                   positions, cfg, shared, enc_out,
                                   enc_pos, attn_scheme=attn_scheme,
                                   dp_group=dp_group, tp=tp)
                aux = aux + a
            return h, aux
        step = _remat(body, remat)
        for layer_p in _unstack(seg_p, repeats):
            x, aux = step(x, layer_p)
            aux_total = aux_total + aux
    return x, aux_total


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           tp=None):
    """Whisper-style encoder over stub frame embeddings (B, T, D).  With
    ``tp`` the stack runs in the boundary layout, and the output is whole
    (the cross-attention reads it)."""
    params = _as_tree(params)
    B, T, D = frames.shape
    pos_tab = torch.as_tensor(sinusoidal_positions(T, D),
                              device=frames.device).to(frames.dtype)
    x = frames + pos_tab[None]
    if tp is not None:
        x = tp.local(x)
    positions = torch.arange(T, device=frames.device)[None].expand(B, T)
    x, _ = _run_stack(params["encoder"]["segments"], enc_plan(cfg), x,
                      positions, cfg, tp=tp)
    x = enter(tp, x, _split(tp, "attn"))
    return rms_norm(x, params["encoder"]["final_norm"]), positions


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor | None = None, remat: bool = True,
            return_hidden: bool = False, act_sharding=None,
            unroll: bool = False, attn_scheme: str = "simple",
            dp_group=None, tp=None):
    """Training / prefill forward.  tokens: (B, S) integer.
    Returns (logits (B, S, V) — or the final hidden (B, S, D) with
    ``return_hidden`` — and the aux loss scalar).  With ``dp_group`` the
    rows are one data-parallel rank's part of the batch, and the aux is
    that of the whole batch (``mlp.moe_forward``).  With ``tp``
    (``train.tp.TensorParallel``) ``params`` are the rank's compute
    leaves: the embedding is looked up in the rank's vocabulary block,
    the stack runs in the boundary layout, the final hidden is whole and
    the logits are those of the rank's vocabulary block."""
    params = _as_tree(params)
    B, S = tokens.shape
    dt = cfg.cdtype
    if tp is None:
        x = params["embed"].to(dt)[tokens]
    else:
        x = tp.embed(params["embed"].to(dt), tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    enc_out = enc_pos = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("encdec needs stub frame embeddings")
        enc_out, enc_pos = encode(params, cfg, frames.to(dt), tp=tp)
        pos_tab = torch.as_tensor(sinusoidal_positions(S, cfg.d_model),
                                  device=x.device).to(dt)
        x = x + (pos_tab if tp is None else tp.local(pos_tab))[None]
    x, aux = _run_stack(params["segments"], layer_plan(cfg), x, positions,
                        cfg, shared=params.get("shared_block"),
                        enc_out=enc_out, enc_pos=enc_pos, remat=remat,
                        act_sharding=act_sharding, unroll=unroll,
                        attn_scheme=attn_scheme, dp_group=dp_group, tp=tp)
    x = rms_norm(enter(tp, x, _split(tp, "vocab")), params["final_norm"])
    if return_hidden:
        return x, aux
    return x @ unembed_matrix(params, cfg), aux


def unembed_matrix(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(D, V) in the compute dtype: the transposed embedding when tied.
    From a rank's compute leaves (``train.tp``), its vocabulary block."""
    params = _as_tree(params)
    return (params["embed"].t() if cfg.tie_embeddings
            else params["unembed"]).to(cfg.cdtype)


# ----------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               enc_len: int | None = None, device=None, tp=None) -> dict:
    """KV/SSM cache tree mirroring the segment structure, on ``device``
    (CUDA unless given).

    ``cfg.kv_cache_dtype == "int8"`` stores self-attention caches as int8
    with per-entry float32 scales.

    With ``tp`` (``train.tp.TensorParallel`` of a mesh, ``batch`` the
    whole batch) a ``BlockCache``: the rank's block of each leaf, as
    ``sharding.cache_placements`` places it on ``tp.mesh`` (the SSM's
    leaves whole over 'model'; see the module docstring), with those
    placements, which ``decode_step`` reads."""
    if tp is None:
        return _cache_tree(cfg, batch, max_seq, enc_len,
                           resolve_device(device))
    whole = _cache_tree(cfg, batch, max_seq, enc_len, torch.device("meta"))
    places = cache_layout(tp.mesh, whole, batch)
    dev = resolve_device(device)
    return BlockCache(tree_map(lambda a, place: torch.zeros(
        shd.block_shape(a.shape, place, tp.mesh), dtype=a.dtype,
        device=dev), whole, places), places)


class BlockCache(dict):
    """A rank's block of a decode cache (``init_cache(tp=...)``): the
    cache tree, and in ``places`` where each of its leaves lies on the
    mesh (``cache_layout``)."""

    def __init__(self, tree: dict, places: dict):
        super().__init__(tree)
        self.places = places


def cache_layout(mesh, cache, batch: int) -> dict:
    """Where each leaf of a whole decode cache lies under tensor
    parallelism: ``sharding.cache_placements``, with the SSM's ``state``
    and ``conv`` whole over 'model'."""
    def one(path, place):
        if path[-1] in ("state", "conv"):
            return place[0], None
        return place
    return tree_map_with_path(
        one, shd.cache_placements(mesh, cache, batch),
        is_leaf=lambda x: isinstance(x, tuple))


def _cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                enc_len: int | None, dev: torch.device) -> dict:
    dt = cfg.cdtype
    quant = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if quant else dt
    K, hd = cfg.n_kv_heads, cfg.hd

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: dict[str, Any] = {"segments": []}
    for repeats, slots in layer_plan(cfg):
        seg = {}
        for si, slot in enumerate(slots):
            if slot.kind == "ssm":
                c = ssm_mod.ssm_init_cache(cfg, batch, dt, dev, (repeats,))
            else:
                C = min(slot.window, max_seq) if slot.window else max_seq
                c = {"k": zeros((repeats, batch, C, K, hd), kv_dt),
                     "v": zeros((repeats, batch, C, K, hd), kv_dt)}
                if quant:
                    c["k_scale"] = zeros((repeats, batch, C, K),
                                         torch.float32)
                    c["v_scale"] = zeros((repeats, batch, C, K),
                                         torch.float32)
                if slot.cross:
                    T = enc_len or cfg.n_frames
                    c["ck"] = zeros((repeats, batch, T, K, hd), dt)
                    c["cv"] = zeros((repeats, batch, T, K, hd), dt)
            if slot.shared_attn:
                c["shared_k"] = zeros((repeats, batch, max_seq, K, hd), kv_dt)
                c["shared_v"] = zeros((repeats, batch, max_seq, K, hd), kv_dt)
                if quant:
                    c["shared_k_scale"] = zeros((repeats, batch, max_seq, K),
                                                torch.float32)
                    c["shared_v_scale"] = zeros((repeats, batch, max_seq, K),
                                                torch.float32)
            seg[f"slot{si}"] = c
        cache["segments"].append(seg)
    return cache


def _seq_group(tp, places: dict | None, name: str):
    """The group whose ranks hold consecutive blocks of the sequence axis
    (dim 2 of (R, B, C, K, hd)) of cache leaf ``name``, or ``None``."""
    if tp is None:
        return None
    dd, md = places[name]
    return tp if md == 2 else tp.data if dd == 2 else None


def _reduce(tp, y, split: bool):
    """``tp.reduce``, or ``y`` itself without ``tp``."""
    return y if tp is None else tp.reduce(y, split)


def _decode_slot(sp: dict, cache_slot: dict, slot: Slot, x, pos, cfg,
                 shared, tp=None, places=None):
    """One sub-layer's decode; ``cache_slot`` holds views of one repeat
    of the cache and is updated in place.  With ``tp``, ``places`` holds
    the slot's cache placements (dims of the stacked leaves)."""
    if slot.kind == "ssm":
        h, c = ssm_mod.ssm_decode(sp["ssm"], cache_slot,
                                  rms_norm(x, sp["ln"]), cfg)
        x = x + h
        cache_slot["conv"].copy_(c["conv"])
        cache_slot["state"].copy_(c["state"])
    else:
        a = _split(tp, "attn")
        h = attn_mod.attn_decode(
            sp["attn"], cache_slot["k"], cache_slot["v"],
            rms_norm(x, sp["ln1"]), pos, cfg, window=slot.window,
            theta=slot.theta, k_scale=cache_slot.get("k_scale"),
            v_scale=cache_slot.get("v_scale"), tp=tp,
            seq=_seq_group(tp, places, "k"))[0]
        x = x + _reduce(tp, h, a)
        if slot.cross:
            x = x + _reduce(tp, attn_mod.cross_attn_decode(
                sp["cross"], cache_slot["ck"], cache_slot["cv"],
                rms_norm(x, sp["ln_x"]), cfg, tp=tp,
                seq=_seq_group(tp, places, "ck")), a)
        if slot.moe:
            # decode: dense per-token expert mix (B tokens, no capacity)
            m = _split(tp, "moe")
            h, _ = _moe_decode(sp["mlp"], rms_norm(x, sp["ln2"]), cfg,
                               tp=tp)
        else:
            m = _split(tp, "mlp")
            h = mlp_mod.mlp_forward(sp["mlp"], rms_norm(x, sp["ln2"]))
        x = x + _reduce(tp, h, m)
    if slot.shared_attn and shared is not None:
        h = attn_mod.attn_decode(
            shared["attn"], cache_slot["shared_k"], cache_slot["shared_v"],
            rms_norm(x, shared["ln1"]), pos, cfg, window=0,
            theta=cfg.rope_theta,
            k_scale=cache_slot.get("shared_k_scale"),
            v_scale=cache_slot.get("shared_v_scale"), tp=tp,
            seq=_seq_group(tp, places, "shared_k"))[0]
        x = x + _reduce(tp, h, _split(tp, "attn"))
        x = x + _reduce(tp, mlp_mod.mlp_forward(
            shared["mlp"], rms_norm(x, shared["ln2"])), _split(tp, "mlp"))
    return x


def _moe_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """Single-token MoE decode by one-hot activation dispatch: every
    expert runs over the (B, D) tokens and the outputs are mixed with the
    routed gates (zero for experts a token was not routed to).  Exact for
    decode: no capacity, no drops.  With ``tp`` whose plan splits the
    experts, ``p`` holds the rank's block of them (and of the shared
    experts' ``d_ff``): it mixes its experts only, and the result is its
    part of the sum over ranks."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    El = p["wg"].shape[-3]
    dt = x.dtype
    logits = (x @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1, sorted=True)   # (B,1,k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    # combine weights per expert: (B, E), zero for unrouted experts
    comb = torch.zeros((B, E), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, eidx[:, 0, :], gate[:, 0, :])
    if El != E:                             # the rank's experts
        comb = comb.narrow(1, tp.experts(El), El)
    xe = x[:, 0, :]                                          # (B, D)
    h = torch.nn.functional.silu(
        torch.einsum("bd,edf->ebf", xe, p["wg"].to(dt))) * \
        torch.einsum("bd,edf->ebf", xe, p["wu"].to(dt))
    ye = torch.einsum("ebf,efd->ebd", h, p["wd"].to(dt))
    y = torch.einsum("ebd,be->bd", ye, comb.to(dt))[:, None, :]
    if cfg.n_shared_experts:
        y = y + mlp_mod.mlp_forward(p["shared"], x)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def build_cross_cache(params: dict, cfg: ModelConfig,
                      enc_out: torch.Tensor, cache: dict, tp=None) -> dict:
    """Fill the decoder cross-attention k/v from the encoder output
    (serving prefill for enc-dec models), in place; returns ``cache``.
    With ``tp``, ``params`` are the rank's serving leaves, ``enc_out``
    whole, and the rank fills its block of the cache: its KV heads, or
    its block of the encoder positions."""
    params = _as_tree(params)
    hd = cfg.hd
    dt = enc_out.dtype
    places = None if tp is None else cache.places["segments"]
    for gi, (seg_p, seg_c, (repeats, slots)) in enumerate(zip(
            params["segments"], cache["segments"], layer_plan(cfg))):
        for si, slot in enumerate(slots):
            if not slot.cross:
                continue
            seq = None if tp is None else _seq_group(
                tp, places[gi][f"slot{si}"], "ck")
            for r in range(repeats):
                cp = _layer(seg_p[f"slot{si}"]["cross"], r)
                K = cp["wk"].shape[-1] // hd
                k = enc_out @ cp["wk"].to(dt)
                v = enc_out @ cp["wv"].to(dt)
                if cfg.qkv_bias:
                    k = k + cp["bk"].to(dt)
                    v = v + cp["bv"].to(dt)
                k = k.reshape(k.shape[:-1] + (K, hd))
                v = v.reshape(v.shape[:-1] + (K, hd))
                if cfg.qk_norm:
                    k = rms_norm(k, cp["k_norm"])
                c = seg_c[f"slot{si}"]
                ck, cv = c["ck"][r], c["cv"][r]
                if seq is not None:
                    n = ck.shape[1]
                    k, v = (t.narrow(1, seq.rank * n, n) for t in (k, v))
                ck.copy_(k)
                cv.copy_(v)
    return cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, tp=None):
    """token: (B,) integer; pos: (B,) integer.  Returns (logits (B, V),
    cache), the cache updated in place.  With ``tp``, ``params`` are the
    rank's serving leaves (``train.tp.TensorParallel.serve_leaf``), the
    cache its ``BlockCache`` (``init_cache(tp=tp)``) and the rows its
    rows; the logits are whole over the vocabulary on every rank."""
    params = _as_tree(params)
    dt = cfg.cdtype
    if tp is None:
        x = params["embed"].to(dt)[token][:, None, :]       # (B,1,D)
    else:
        x = tp.embed_rows(params["embed"].to(dt), token)[:, None, :]
    if cfg.family == "encdec":
        x = x + sinusoidal_at(pos, cfg.d_model).to(dt)[:, None, :]
    shared = params.get("shared_block")
    places = None if tp is None else cache.places["segments"]
    for gi, (seg_p, seg_c, (repeats, slots)) in enumerate(zip(
            params["segments"], cache["segments"], layer_plan(cfg))):
        for r in range(repeats):
            layer_p, layer_c = _layer(seg_p, r), _layer(seg_c, r)
            for si, slot in enumerate(slots):
                x = _decode_slot(layer_p[f"slot{si}"], layer_c[f"slot{si}"],
                                 slot, x, pos, cfg, shared, tp=tp,
                                 places=None if tp is None
                                 else places[gi][f"slot{si}"])
    x = rms_norm(x, params["final_norm"])
    logits = (x @ unembed_matrix(params, cfg))[:, 0, :]
    if tp is not None:
        logits = tp.gather_vocab(logits)
    return logits, cache
