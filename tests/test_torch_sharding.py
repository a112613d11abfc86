"""The port's sharding rules and LM meshes (``repro_torch.models.sharding``,
``repro_torch.launch.mesh``) against ``repro``'s.

  * ``param_specs`` of the port equals ``tuple(spec)`` of the
    reference's, leaf by leaf (same paths, same shapes), for the ten
    configs reduced and at their published widths, on the reference's
    (1, 1), (16, 16) and (2, 16, 16) meshes as JAX ``AbstractMesh``es
    (no devices needed; the port's rules take any object with axis names
    and sizes).  The port's trees are meta tensors
    (``init_params(device="meta")``), the reference's
    ``jax.eval_shape``'s;
  * ``cache_specs`` the same at published width: batch 8 with a 1024
    cache, batch 1 (the sequence-sharded branch) and int8 caches (the
    ``_scale`` leaves); ``batch_spec`` and ``data_axes``;
  * the reference's ``test_param_sharding_rules_shapes`` contract, and
    ``param_placements`` (what the trainer shards by, on both axes) on
    (1, 2), (2, 2) and (1, 8) meshes against the reference's specs;
    ``model_compute`` (how each leaf computes over 'model');
  * the reference's ``test_production_mesh_shapes`` contract on the
    port's H100 shapes, and the rules on a ``DeviceMesh``, in a
    subprocess on the fake process-group backend.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import sharding as ref_shd
from repro.models import transformer as ref_T
from repro_torch.configs import get_config, reduced
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.tree import tree_items, tree_map_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "OMP_NUM_THREADS": "2"}
ALL_ARCHS = sorted(REF_ARCHS)
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _cfgs(arch, width):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    if width == "reduced":
        rcfg, cfg = ref_reduced(rcfg), reduced(cfg)
    return rcfg, cfg


def _ref_items(tree) -> dict:
    """'a/b/0/c' -> leaf of a reference pytree (specs stay whole)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {ref_shd._path_str(p): v for p, v in flat}


def _port_items(tree) -> dict:
    out = {}
    tree_map_with_path(lambda p, v: out.__setitem__(shd._path_str(p), v),
                       tree, is_leaf=lambda x: isinstance(x, tuple))
    return out


def _same_specs(port_specs, ref_specs, port_tree, ref_tree):
    got, want = _port_items(port_specs), _ref_items(ref_specs)
    assert got.keys() == want.keys()
    shapes = {k: tuple(v.shape) for k, v in _port_items(port_tree).items()}
    ref_shapes = {k: tuple(v.shape) for k, v in _ref_items(ref_tree).items()}
    assert shapes == ref_shapes
    for k in want:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("width", ["reduced", "published"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, width):
    rcfg, cfg = _cfgs(arch, width)
    ref_params = jax.eval_shape(lambda: ref_T.init_params(rcfg, seed=0))
    params = T.init_params(cfg, device="meta")
    assert all(a.device.type == "meta" for _, a in tree_items(params))
    for name in MESHES:
        mesh = _mesh(name)
        _same_specs(shd.param_specs(mesh, params),
                    ref_shd.param_specs(mesh, ref_params), params,
                    ref_params)


@pytest.mark.parametrize("case", ["b8", "b1", "b8-int8"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch, case):
    rcfg, cfg = _cfgs(arch, "published")
    batch = 1 if case == "b1" else 8
    if case.endswith("int8"):
        rcfg = dataclasses.replace(rcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ref_cache = jax.eval_shape(lambda: ref_T.init_cache(rcfg, batch, 1024))
    cache = T.init_cache(cfg, batch, 1024, device="meta")
    for name in MESHES:
        mesh = _mesh(name)
        _same_specs(shd.cache_specs(mesh, cache, batch),
                    ref_shd.cache_specs(mesh, ref_cache, batch), cache,
                    ref_cache)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batch_spec_and_data_axes_match_reference(name):
    mesh = _mesh(name)
    assert shd.data_axes(mesh) == ref_shd.data_axes(mesh)
    for batch in (1, 2, 8, 16, 32, 48, 256):
        for extra in (0, 1, 2):
            assert shd.batch_spec(mesh, batch, extra) == tuple(
                ref_shd.batch_spec(mesh, batch, extra)), (batch, extra)


def test_param_sharding_rules_shapes():
    """The reference's contract (``tests/test_dryrun_sharding.py``) on the
    port: every leaf gets a spec of matching rank."""
    mesh = _mesh("1x1")
    cfg = reduced(get_config("olmoe-1b-7b"))
    params = T.init_params(cfg, seed=0, device="meta")
    flat = list(_port_items(shd.param_specs(mesh, params)).items())
    pflat = list(_port_items(params).items())
    assert len(flat) == len(pflat)
    for (pa, spec), (pb, leaf) in zip(flat, pflat):
        assert pa == pb
        assert len(spec) <= leaf.ndim + 1


TP_MESHES = ((1, 2), (2, 2), (1, 8))


def test_param_placements_follow_the_rules():
    """Each leaf's (data dim, model dim) pair on the (1, 2), (2, 2) and
    (1, 8) ('data', 'model') meshes: where the reference's
    ``param_specs`` puts 'data' and 'model', leaf for leaf, for the ten
    configs reduced and at their published widths."""
    for arch in ALL_ARCHS:
        for width in ("reduced", "published"):
            rcfg, cfg = _cfgs(arch, width)
            ref_params = jax.eval_shape(
                lambda: ref_T.init_params(rcfg, seed=0))
            params = T.init_params(cfg, device="meta")
            for shape in TP_MESHES:
                mesh = AbstractMesh(shape, ("data", "model"))
                want = _ref_items(ref_shd.param_specs(mesh, ref_params))
                got = _port_items(shd.param_placements(mesh, params))
                assert got.keys() == want.keys()
                for k, spec in want.items():
                    dims = [[i for i, s in enumerate(spec) if s == a]
                            for a in ("data", "model")]
                    assert got[k] == tuple(d[0] if d else None
                                           for d in dims), \
                        (arch, width, shape, k, got[k], spec)
                assert got["embed"][1] == 0, (arch, shape, got["embed"])
    params = T.init_params(reduced(get_config("olmoe-1b-7b")), device="meta")
    places = _port_items(shd.param_placements(
        AbstractMesh((2, 2), ("data", "model")), params))
    assert places["embed"] == (1, 0)
    assert places["final_norm"] == (None, None)
    assert places["segments/0/slot0/mlp/wd"] == (3, 1)      # (R, E, F, D)
    assert places["segments/0/slot0/attn/wq"] == (1, 2)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_compute_splits_only_on_the_math(arch, tp):
    """``model_compute`` on a (1, tp) mesh, reduced configs: a leaf's
    compute block divides its dimension; a leaf whose block at rest is
    its compute block is not gathered; KV columns only where the query
    heads split and the KV heads do not; the SSM always runs whole."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, device="meta")
    mesh = AbstractMesh((1, tp), ("data", "model"))
    plan = shd.tp_plan(cfg, tp)
    places = _port_items(shd.param_placements(mesh, params))
    comp = _port_items(shd.model_compute(cfg, mesh, params))
    shapes = {k: tuple(v.shape) for k, v in _port_items(params).items()}
    gathered = set(shd.gathered_leaves(
        params, shd.param_placements(mesh, params),
        shd.model_compute(cfg, mesh, params)))
    for k, (kind, d) in comp.items():
        assert kind in ("block", "kv", "partial", "whole"), (k, kind)
        if kind == "block":
            assert shapes[k][d] % tp == 0, (k, shapes[k], d)
        if kind == "kv":
            assert plan["attn"] and not plan["kv"], k
        if "/ssm/" in k:
            assert kind == "whole", k
        at_rest = places[k][1] is not None
        assert (k in gathered) == (at_rest and (kind, d) != ("block",
                                                               places[k][1]))
    if arch == "qwen3-0.6b" and tp == 4:
        assert {k.rsplit("/", 1)[-1] for k in gathered} >= {"wk", "wv"}
        assert comp["segments/0/slot0/attn/wk"][0] == "kv"


def test_production_mesh_shapes():
    """The reference's mesh contract on the port's H100 shapes (256 and
    512 cards, 'model' within an 8-card node), on the fake backend; and
    the rules on that ``DeviceMesh`` equal those on a mesh of the same
    axes."""
    code = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from types import SimpleNamespace\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.models import sharding as shd\n"
        "from repro_torch.models.transformer import init_params\n"
        "params = init_params(get_config('qwen3-0.6b'), device='meta')\n"
        "for world, multi in ((256, False), (512, True)):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                            world_size=world)\n"
        "    m = make_production_mesh(multi_pod=multi, device_type='cpu')\n"
        "    names = m.mesh_dim_names\n"
        "    shape = dict(zip(names, m.shape))\n"
        "    assert m.size() == world, m\n"
        "    if multi:\n"
        "        assert names == ('pod', 'data', 'model'), names\n"
        "        assert shape['pod'] == 2, shape\n"
        "    else:\n"
        "        assert names == ('data', 'model'), names\n"
        "    assert shape['data'] == 32 and shape['model'] == 8, shape\n"
        "    same = SimpleNamespace(axis_names=names, shape=shape)\n"
        "    assert shd.param_specs(m, params) == \\\n"
        "        shd.param_specs(same, params)\n"
        "    assert shd.data_axes(m) == names[:-1]\n"
        "    dist.destroy_process_group()\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_meta_init_matches_the_cpu_init_shapes():
    cfg = reduced(get_config("zamba2-1.2b"))
    meta = dict(tree_items(T.init_params(cfg, device="meta")))
    cpu = dict(tree_items(T.init_params(cfg, seed=0, device="cpu")))
    assert meta.keys() == cpu.keys()
    for k, v in cpu.items():
        assert meta[k].device.type == "meta"
        assert (tuple(meta[k].shape), meta[k].dtype) == (tuple(v.shape),
                                                         v.dtype), k
    assert np.isfinite(sum(float(v.sum()) for v in cpu.values()))
