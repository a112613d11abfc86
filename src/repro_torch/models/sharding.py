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

``param_placements`` turns the specs into what the data-parallel
trainer (``train.dp``) shards by: the dimension of each leaf that the
data axes split.  Tensor parallelism over 'model' is not ported yet
(ROADMAP queue 1, item 7d): a leaf that a 'model' axis above 1 would
split raises there.
"""
from __future__ import annotations

import math
import re
from collections.abc import Mapping

from repro_torch.tree import tree_map_with_path


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
    """Where each leaf of a param (or optimizer-state) tree lives over the
    data axes ('pod', 'data'): the dimension they split, or ``None`` where
    they replicate the leaf (the counterpart of ``param_shardings`` for
    the data-parallel trainer).  A 'model' axis above 1 that would split
    a leaf raises: tensor parallelism is not ported yet."""
    data = set(data_axes(mesh))
    model = _sizes(mesh).get("model", 1)

    def one(path, spec):
        dims = []
        for i, s in enumerate(spec):
            axes = s if isinstance(s, tuple) else (s,)
            if "model" in axes and model > 1:
                raise NotImplementedError(
                    f"{_path_str(path)}: split over 'model' ({model}); "
                    "tensor parallelism is ROADMAP queue 1, item 7d")
            if data & set(axes):
                dims.append(i)
        return dims[0] if dims else None     # the rules split one at most
    return tree_map_with_path(one, param_specs(mesh, params),
                              is_leaf=lambda x: isinstance(x, tuple))


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
