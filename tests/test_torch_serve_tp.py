"""Serving over ('data', 'model') meshes (``launch.serve.serve_on_mesh``,
``make_prefill_step``/``make_decode_step`` with a ``train.tp`` handle) on
the CPU: spawned gloo ranks against one process, and the one-process
port against ``repro``'s ``make_decode_step``.

  * Reduced configs at (1, 2): qwen3-0.6b (the KV heads split),
    gemma3-1b (one KV head: the cache's sequence axis is split over
    'model', and its 64-entry rings wrap over 72 positions),
    olmoe-1b-7b (experts over 'model'), whisper-large-v3 (the cross
    cache), mamba2-130m (the SSM whole on every rank) and zamba2-1.2b
    (the SSM and the shared attention's cache); qwen3-0.6b at (2, 2)
    and at (1, 4) with 21 positions (2 KV heads over 4 ranks, a cache
    axis that 4 does not divide: the cache whole on every rank, each
    rank reading its query heads' KV columns); whisper at (1, 4) (the
    cross cache's 24 encoder positions split over 'model').  Each: the
    prompt through the decode path and 8 greedy tokens, in float32; the
    greedy tokens equal one process's, and the decode logits of every
    position and ``make_prefill_step``'s within ``RTOL`` of a position's
    largest |logit| (1.5e-6 is the largest gap seen).
  * gemma3-1b with an int8 KV cache at (1, 2): the same within
    ``INT8_RTOL``.  The new entry's k and v are quantized from
    activations that differ from one process's in their last bits, so
    an entry now and then rounds to the neighbouring int8 level (one
    level is 1/127 of a head's largest value); 2.4e-3 is seen.
  * (1, 1) through ``serve_on_mesh``'s spawned rank: bitwise one
    process.
  * The one-process port's ``make_decode_step`` on numpy-seeded weights
    carried over by ``convert`` against the reference's, and the (1, 2)
    mesh against the reference on the port's draw.
  * A mesh on ``cuda`` with fewer cards than ranks raises; on cards
    (``cuda``): (1, 2) on two cards against one card.
"""
import dataclasses
import multiprocessing
import os
import pickle
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve_args, serve_on_mesh, serve_rank
from repro_torch.models import transformer as T
from repro_torch.train import steps

RTOL, INT8_RTOL = 1e-5, 1e-2
B, GEN = 4, 8
# id -> (arch, mesh, prompt length, config changes)
CASES = {
    "qwen3-1x2": ("qwen3-0.6b", (1, 2), 12, {}),
    "gemma3-1x2": ("gemma3-1b", (1, 2), 64, {}),
    "olmoe-1x2": ("olmoe-1b-7b", (1, 2), 12, {}),
    "whisper-1x2": ("whisper-large-v3", (1, 2), 12, {}),
    "mamba2-1x2": ("mamba2-130m", (1, 2), 12, {}),
    "zamba2-1x2": ("zamba2-1.2b", (1, 2), 12, {}),
    "qwen3-2x2": ("qwen3-0.6b", (2, 2), 12, {}),
    "qwen3-1x4": ("qwen3-0.6b", (1, 4), 13, {}),
    "whisper-1x4": ("whisper-large-v3", (1, 4), 12, {}),
    "gemma3-int8-1x2": ("gemma3-1b", (1, 2), 64,
                        {"kv_cache_dtype": "int8"}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(arch, changes=None):
    return dataclasses.replace(reduced(get_config(arch)), **(changes or {}))


def _rel_err(got, want) -> float:
    """Largest error of any position relative to that position's largest
    |logit| of ``want``."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(dim=-1) + 1e-6
    return float(((got - want).abs().amax(dim=-1) / scale).max())


def _serve(cfg, mesh, prompt, device="cpu", **kw):
    return serve_on_mesh(cfg, mesh, batch=B, prompt_len=prompt, gen=GEN,
                         device=device, **kw)


def _mesh_worker(rank, shape, tmp, cases):
    """One rank of a ``shape`` mesh of gloo processes: ``serve_rank`` of
    each case (as ``serve_on_mesh``'s workers run it, in one process
    group); rank 0 writes each record."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                            rank=rank, world_size=shape[0] * shape[1])
    mesh = make_host_mesh(*shape)
    for case in cases:
        arch, _, prompt, changes = CASES[case]
        rec = {}
        serve_rank(serve_args(_cfg(arch, changes), batch=B,
                              prompt_len=prompt, gen=GEN),
                   torch.device("cpu"), rec, mesh=mesh)
        if rank == 0:
            with open(os.path.join(tmp, case + ".pkl"), "wb") as f:
                pickle.dump(rec, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes():
    """Per case: the mesh's record (each mesh shape's cases in one group
    of spawned ranks, the groups at once) and one process's."""
    tmp = tempfile.mkdtemp(prefix="serve_tp-")
    ctx = multiprocessing.get_context("spawn")
    groups: dict = {}
    for case, (_, shape, _, _) in CASES.items():
        groups.setdefault(shape, []).append(case)
    procs = []
    for shape, cases in groups.items():
        sub = os.path.join(tmp, "x".join(map(str, shape)))
        os.makedirs(sub)
        procs += [ctx.Process(target=_mesh_worker,
                              args=(r, shape, sub, cases))
                  for r in range(shape[0] * shape[1])]
    for p in procs:
        p.start()
    one = {}
    try:
        for arch, _, prompt, changes in CASES.values():
            key = (arch, prompt, tuple(sorted(changes.items())))
            if key not in one:
                one[key] = _serve(_cfg(arch, changes), None, prompt)
    finally:
        for p in procs:
            p.join(timeout=600)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = {}
    for case, (arch, shape, prompt, changes) in CASES.items():
        sub = os.path.join(tmp, "x".join(map(str, shape)))
        with open(os.path.join(sub, case + ".pkl"), "rb") as f:
            got[case] = (pickle.load(f), one[(arch, prompt, tuple(
                sorted(changes.items())))])
    shutil.rmtree(tmp, ignore_errors=True)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_one_process(case, meshes):
    arch, mesh, prompt, changes = CASES[case]
    got, one = meshes[case]
    assert got["mesh"] == mesh
    assert torch.equal(got["tokens"], one["tokens"])
    tol = INT8_RTOL if changes.get("kv_cache_dtype") == "int8" else RTOL
    assert got["logits"].shape == one["logits"].shape == (
        B, prompt + GEN, got["cfg"].padded_vocab)
    assert _rel_err(got["logits"], one["logits"]) <= tol
    assert _rel_err(got["prefill_logits"], one["prefill_logits"]) <= RTOL
    ranks, whole = got["ranks"], one["ranks"][0]
    assert [r["coord"] for r in ranks] == [
        (d, m) for d in range(mesh[0]) for m in range(mesh[1])]
    assert all(not any(r["launches"].values()) for r in ranks)
    assert got["model_collective_s"] > 0
    n = mesh[0] * mesh[1]
    cache = ranks[0]["cache_bytes"]
    if arch in ("mamba2-130m", "zamba2-1.2b"):
        # the SSM's state and conv stay whole over 'model'
        assert ranks[0]["cache_at_rest_bytes"] < cache
        assert cache > whole["cache_bytes"] // mesh[0] // 2
    elif case == "qwen3-1x4":
        # 21 cache entries over 4 ranks, 2 KV heads: the cache whole
        assert cache == whole["cache_bytes"]
    elif "int8" in case:
        # the int8 entries split; cache_specs keeps their scales whole
        # where the KV heads do not divide
        assert whole["cache_bytes"] // n < cache < whole["cache_bytes"]
        assert ranks[0]["cache_at_rest_bytes"] == cache
    else:
        assert cache * n == whole["cache_bytes"], case
        assert ranks[0]["cache_at_rest_bytes"] == cache
    assert all(r["params_at_rest_bytes"] < whole["params_at_rest_bytes"]
               for r in ranks)
    plan = got["plan"]
    if arch == "olmoe-1b-7b":
        assert plan["moe"]
    if arch == "gemma3-1b" or case.endswith("1x4"):
        assert plan["attn"] and not plan["kv"]


def test_mesh_1x1_is_one_process_bitwise(meshes):
    """Through ``serve_on_mesh``'s own spawn."""
    one = meshes["qwen3-1x2"][1]
    got = _serve(_cfg("qwen3-0.6b"), (1, 1), 12)
    for k in ("tokens", "logits", "prefill_logits"):
        assert torch.equal(got[k], one[k]), k


def test_mesh_on_cuda_with_too_few_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        _serve(_cfg("qwen3-0.6b"), (1, 2), 12, device="cuda")


def _numpy_params(cfg, seed):
    """Weights drawn with numpy, at the port's paths and shapes."""
    rng = np.random.default_rng(seed)
    shapes = T.init_params(cfg, device="meta")

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        return (0.05 * rng.normal(size=tuple(tree.shape))).astype(
            np.float32)
    return draw(shapes)


def _ref_decode(arch, params_np, tok):
    """The reference's ``make_decode_step`` teacher-forced over ``tok``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models import transformer as RT
    from repro.train import steps as ref_steps
    rcfg = ref_reduced(ref_get_config(arch))
    params = jax.tree.map(jnp.asarray, params_np)
    step = jax.jit(ref_steps.make_decode_step(rcfg))
    cache = RT.init_cache(rcfg, tok.shape[0], max_seq=tok.shape[1])
    out = []
    for i in range(tok.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(tok[:, i]),
                         jnp.full((tok.shape[0],), i, jnp.int32))
        out.append(np.asarray(lg))
    return torch.as_tensor(np.stack(out, axis=1))


def test_decode_matches_reference(meshes):
    arch = "qwen3-0.6b"
    cfg = _cfg(arch)
    # the one-process port on numpy-seeded weights carried over
    params_np = _numpy_params(cfg, 7)
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 16))
    model = convert.lm_params_from_reference(cfg, params_np, device="cpu")
    step = steps.make_decode_step(cfg)
    cache = T.init_cache(cfg, B, 16, device="cpu")
    got = torch.stack([step(model, cache, torch.as_tensor(tok[:, i]),
                            torch.full((B,), i))[0] for i in range(16)], 1)
    assert _rel_err(got, _ref_decode(arch, params_np, tok)) <= RTOL
    # the (1, 2) mesh on the port's draw (seed 0)
    mesh = meshes["qwen3-1x2"][0]
    draw = T.init_params(cfg, seed=0, device="cpu")

    def as_np(tree):
        if isinstance(tree, dict):
            return {k: as_np(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_np(v) for v in tree]
        return tree.numpy()
    want = _ref_decode(arch, as_np(draw), mesh["tokens"].numpy())
    assert _rel_err(mesh["logits"], want) <= RTOL


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


@pytest.mark.cuda
def test_mesh_on_two_cards_matches_one_card(two_cards):
    cfg = _cfg("qwen3-0.6b")
    one = _serve(cfg, None, 12, device="cuda:0")
    got = _serve(cfg, (1, 2), 12, device="cuda")
    assert torch.equal(got["tokens"], one["tokens"])
    assert _rel_err(got["logits"], one["logits"]) <= RTOL
    assert _rel_err(got["prefill_logits"], one["prefill_logits"]) <= RTOL
