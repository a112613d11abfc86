"""Path-based sharding rules (counterpart of ``repro.models.sharding``):
FSDP over ('pod', 'data'), TP/EP over 'model'.

Every parameter leaf is matched by path against RULES, yielding logical
axes per dimension; logical axes map to mesh axes with a divisibility
fallback to replication.  The same machinery shards optimizer state
(mirrors params), KV/SSM caches and step inputs.

A spec is a plain tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of axis names — ``tuple(PartitionSpec)`` of the
reference's spec.  A mesh is anything with axis names and sizes: an
object with ``axis_names`` and a ``shape`` mapping (as a JAX mesh has),
or a ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` and a
``shape`` tuple).  So the rules need no process group.

``param_placements`` (and ``cache_placements`` for a decode cache)
turns the specs into what the trainer and the server shard by:
for each leaf, the dimension the data axes split and the dimension
'model' splits (``train.dp`` keeps a rank's block on both axes).
``tp_plan`` and ``model_compute`` say how each leaf computes under
tensor parallelism over 'model' (``train.tp``): a leaf stays split at
compute time only where the math of its sub-layer splits along that cut
(query heads, KV heads, ``d_ff``, experts, the vocabulary); any other
split over 'model' is storage-only, and the leaf is gathered whole over
'model' before use.
"""
from __future__ import annotations

import math
import re
from collections.abc import Mapping

from repro_torch.tree import subtree, tree_items, tree_map_with_path


# (path regex, logical axes per trailing dim — leading (repeats,) axes of
# stacked segment leaves are padded with None automatically)
RULES = [
    (r"embed$", ("tp", "fsdp")),
    (r"unembed$", ("fsdp", "tp")),
    (r"(wq|wk|wv)$", ("fsdp", "tp")),
    (r"wo$", ("tp", "fsdp")),
    (r"(bq|bk|bv)$", ("tp",)),
    (r"router$", ("fsdp", None)),
    # dense mlp (2D; 3D expert tensors are special-cased to EP in
    # _logical_for_leaf)
    (r"(wg|wu)$", ("fsdp", "tp")),
    (r"wd$", ("tp", "fsdp")),
    (r"in_proj$", ("fsdp", "tp")),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"out_proj$", ("tp", "fsdp")),
    (r"(A_log|dt_bias|D)$", (None,)),
    (r"(ln\w*|norm|final_norm|q_norm|k_norm)$", (None,)),
]

LOGICAL_TO_MESH = {
    "fsdp": ("pod", "data"),
    "dp": ("pod", "data"),
    "tp": ("model",),
    "ep": ("model",),
}


def _sizes(mesh) -> dict:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.shape
    if not isinstance(shape, Mapping):
        shape = dict(zip(names, shape))
    return {a: int(shape[a]) for a in names}


def _mesh_axes_for(mesh, logical):
    if logical is None:
        return None
    sizes = _sizes(mesh)
    axes = tuple(a for a in LOGICAL_TO_MESH[logical] if a in sizes)
    return axes if axes else None


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def spec_for(mesh, shape, logical_axes) -> tuple:
    """Logical axes -> spec with divisibility fallback."""
    ndim = len(shape)
    # pad leading dims (stacked repeats) with None
    logical = (None,) * (ndim - len(logical_axes)) + tuple(logical_axes)
    out = []
    for dim, lg in zip(shape, logical):
        axes = _mesh_axes_for(mesh, lg)
        if axes is None or dim % _axis_size(mesh, axes) != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def _path_str(path) -> str:
    """A leaf's path in the port's trees (dict keys and list indices, as
    ``tree.tree_items`` gives them), joined by '/'."""
    return "/".join(str(p) for p in path)


def _logical_for_leaf(path_s: str, ndim: int):
    leaf_name = path_s.rsplit("/", 1)[-1]
    # MoE expert tensors: trailing 3 dims are (E, d_in, d_out).  Leading
    # stacked-repeat axes may make ndim 4 — spec_for pads those with None.
    if leaf_name in ("wg", "wu", "wd") and ndim >= 3:
        if leaf_name == "wd":
            return ("ep", None, "fsdp")
        return ("ep", "fsdp", None)
    for pat, axes in RULES:
        if re.search(pat, leaf_name):
            return axes
    return tuple([None] * min(ndim, 1))


def param_specs(mesh, params) -> dict:
    """Spec tree for a param (or optimizer-state) tree: one tuple per
    leaf.  Leaves need only ``shape`` and ``ndim`` (meta tensors do)."""
    def one(path, leaf):
        logical = _logical_for_leaf(_path_str(path), leaf.ndim)
        return spec_for(mesh, tuple(leaf.shape), logical)
    return tree_map_with_path(one, params)


def param_placements(mesh, params) -> dict:
    """Where each leaf of a param (or optimizer-state) tree lives: a
    ``(data dim, model dim)`` pair per leaf, the dimension the data axes
    ('pod', 'data') split and the one 'model' splits, ``None`` where they
    replicate it (the counterpart of ``param_shardings`` for the port's
    trainer).  A rank at mesh coordinates (d, m) holds block m of the
    leaf along the model dimension, and block d of that along the data
    dimension, in rank order.  At an axis of size 1 the dimension is
    still given (its one block is the whole leaf)."""
    return _placements(mesh, param_specs(mesh, params))


def _placements(mesh, specs) -> dict:
    data = set(data_axes(mesh))

    def one(path, spec):
        dd = md = None
        for i, s in enumerate(spec):
            axes = set(s if isinstance(s, tuple) else (s,))
            if data & axes:
                dd = i
            if "model" in axes:
                md = i
        return dd, md                       # the rules split one of each
    return tree_map_with_path(one, specs,
                              is_leaf=lambda x: isinstance(x, tuple))


def cache_placements(mesh, cache, batch: int) -> dict:
    """``param_placements`` of a decode cache tree: a ``(data dim, model
    dim)`` pair per leaf from ``cache_specs``."""
    return _placements(mesh, cache_specs(mesh, cache, batch))


def block_shape(shape, place: tuple, mesh) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` placed at
    ``place`` on ``mesh``: the data dimension divided by the data axes'
    size, the model dimension by 'model''s."""
    sizes = _sizes(mesh)
    out = list(shape)
    if place[0] is not None:
        out[place[0]] //= _axis_size(mesh, data_axes(mesh))
    if place[1] is not None:
        out[place[1]] //= sizes["model"]
    return tuple(out)


def tp_plan(cfg, tp: int) -> dict:
    """Which sub-layers split their math over a 'model' axis of ``tp``
    ranks (the others run whole on every model rank):

      * ``attn``: query heads (``n_heads % tp == 0``, and a rank's query
        heads fall on whole KV groups or within one);
      * ``kv``: KV heads as well (``n_kv_heads % tp == 0``); else each
        rank takes the KV columns its query heads read;
      * ``mlp``: the dense MLP's ``d_ff``;
      * ``moe``: the experts (and the shared experts' ``d_ff``);
      * ``vocab``: the embedding rows and the loss's vocabulary;
      * ``layout``: the layer-boundary activations keep ``d_model`` split
        (``launch/specs.py:act_sharding_for`` of the reference) when it
        divides, else whole.
    """
    H, K = cfg.n_heads, cfg.n_kv_heads
    hl = H // tp if H and H % tp == 0 else 0
    g = H // K if K else 0
    attn = bool(hl) and (hl % g == 0 or g % hl == 0)
    moe = bool(cfg.n_experts) and cfg.n_experts % tp == 0 and (
        not cfg.n_shared_experts or cfg.d_ff % tp == 0)
    return {"attn": attn, "kv": attn and K % tp == 0,
            "mlp": bool(cfg.d_ff) and cfg.d_ff % tp == 0, "moe": moe,
            "vocab": cfg.padded_vocab % tp == 0,
            "layout": cfg.d_model % tp == 0}


def _compute_for(path_s: str, ndim: int, plan: dict, moe_slot: bool):
    """One leaf's compute under ``plan``: ``(kind, dim)`` with kind
    "block" (the rank's 1/T block along ``dim``), "kv" (the KV columns of
    the rank's query heads along ``dim``), "partial" (whole; each model
    rank's gradient is a part of the sum) or "whole" (whole; each rank's
    gradient is the whole gradient)."""
    parts = path_s.split("/")
    name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")

    def block(split, dim):
        return ("block", dim % ndim) if split else ("whole", None)

    def partial(split):
        return ("partial" if split else "whole"), None

    if name in ("embed", "unembed"):
        return block(plan["vocab"], 0 if name == "embed" else -1)
    if path_s == "final_norm":
        return partial(plan["vocab"])
    if path_s == "encoder/final_norm" or name in ("ln1", "ln_x"):
        return partial(plan["attn"])
    if parent in ("attn", "cross"):
        if name in ("wq", "bq", "wo"):
            return block(plan["attn"], -2 if name == "wo" else -1)
        if name in ("wk", "wv", "bk", "bv"):
            if plan["attn"] and not plan["kv"]:
                return "kv", ndim - 1
            return block(plan["attn"], -1)
        return partial(plan["attn"])            # q_norm, k_norm
    if name == "ln2":
        return partial(plan["moe" if moe_slot else "mlp"])
    if parent == "mlp" and name == "router":
        return partial(plan["moe"])
    if name in ("wg", "wu", "wd") and parent in ("mlp", "shared"):
        if parent == "mlp" and moe_slot:            # (R, E, d_in, d_out)
            return block(plan["moe"], -3)
        split = plan["moe"] if parent == "shared" else plan["mlp"]
        return block(split, -2 if name == "wd" else -1)
    return "whole", None                            # ssm, its norm


def model_compute(cfg, mesh, params) -> dict:
    """How each leaf of a param tree computes over the mesh's 'model'
    axis (``_compute_for``), as a tree of ``(kind, dim)`` pairs."""
    plan = tp_plan(cfg, _sizes(mesh).get("model", 1))
    paths = {_path_str(p) for p, _ in tree_items(params)}

    def one(path, leaf):
        ps = _path_str(path)
        slot = (ps.rsplit("/mlp/", 1)[0] if "/mlp/" in ps
                else ps.rsplit("/", 1)[0])
        return _compute_for(ps, leaf.ndim, plan,
                            f"{slot}/mlp/router" in paths)
    return tree_map_with_path(one, params)


def is_gathered(place: tuple, comp: tuple) -> bool:
    """Whether a leaf placed at ``place`` that computes as ``comp`` is
    split over 'model' at rest but not in its math (storage-only)."""
    return place[1] is not None and comp != ("block", place[1])


def gathered_leaves(params, placements, compute) -> list:
    """The paths of the leaves of ``params`` whose split over 'model' is
    storage-only: stored split, gathered whole over 'model' before use."""
    return [_path_str(path) for path, _ in tree_items(params)
            if is_gathered(subtree(placements, path),
                           subtree(compute, path))]


# ------------------------------------------------------------ activations
def data_axes(mesh) -> tuple:
    sizes = _sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> tuple:
    da = data_axes(mesh)
    if batch % _axis_size(mesh, da) == 0:
        return (da if len(da) > 1 else da[0],) + (None,) * extra_dims
    return (None,) * (1 + extra_dims)


def cache_specs(mesh, cache, batch: int) -> dict:
    """Specs for a decode cache tree.

    kv leaves: (R, B, C, K, hd); ssm state: (R, B, H, N, P);
    conv: (R, B, W, Ch).  Batch on data axes when divisible, else the
    sequence/cache axis; heads on 'model' when divisible.
    """
    da = data_axes(mesh)
    dp = _axis_size(mesh, da)
    da_spec = da if len(da) > 1 else da[0]
    tp = _sizes(mesh).get("model", 1)

    def one(path, leaf):
        name = _path_str(path).rsplit("/", 1)[-1]
        s = [None] * leaf.ndim
        if name.endswith("_scale"):
            # int8 KV per-entry scales: (R, B, C, K) — follow the cache
            R, B, C, K = leaf.shape
            if B % dp == 0:
                s[1] = da_spec
            elif C % dp == 0:
                s[2] = da_spec
            if K % tp == 0 and tp > 1:
                s[3] = "model"
        elif name in ("k", "v", "ck", "cv", "shared_k", "shared_v"):
            R, B, C, K, hd = leaf.shape
            if B % dp == 0:
                s[1] = da_spec
            elif C % dp == 0:
                s[2] = da_spec               # sequence-sharded KV
            if K % tp == 0 and tp > 1:
                s[3] = "model"
            elif s[2] is None and C % tp == 0 and tp > 1:
                s[2] = "model"
        elif name == "state":
            R, B, H, N, Pp = leaf.shape
            if B % dp == 0:
                s[1] = da_spec
            if H % tp == 0 and tp > 1:
                s[2] = "model"
        elif name == "conv":
            R, B, W, Ch = leaf.shape
            if B % dp == 0:
                s[1] = da_spec
            if Ch % tp == 0 and tp > 1:
                s[3] = "model"
        return tuple(s)
    return tree_map_with_path(one, cache)
