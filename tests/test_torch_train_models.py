"""The port's training gradients for every architecture, against
``repro``.

Each of the ten reduced configs in float32, B = 2, S = 40 (the padding
paths of the attention blocks, the SSM chunks and the loss chunks:
``loss_chunk = 32`` over 80 tokens), from the reference's weights
(``convert.train_state_from_reference``):

  * ``make_loss_fn``'s loss, ce and aux and every gradient leaf, against
    ``jax.value_and_grad`` of the reference's loss: within ``RTOL =
    1e-4`` of the leaf's largest |grad| (float32; the two frameworks sum
    in other orders through a few layers and their backward passes;
    about 1e-5 is seen).  A leaf whose reference gradient is below
    ``ZERO = 1e-6`` of the largest |grad| of the tree is zero in exact
    arithmetic (the cross-attention key bias of the enc-dec decoder:
    without rope, a bias shared by every key shifts a query's scores
    alike, and softmax ignores it); there both packages' values are held
    below ``ZERO`` of the tree's largest |grad|;
  * ``remat`` ``"full"``, ``"dots"`` and ``False`` give the same loss and
    gradients, bitwise (recomputation replays the same operations);
  * the reference's ``tests/test_models.py::test_train_step_smoke`` on
    the port;
  * bf16 compute against float32 on the same weights and batch, the
    measurements behind smoke phase 18 (b)'s gates ``GATE`` (the loss)
    and ``GNORM_GATE`` (the first step's gradient norm).
The trajectories of five train steps are in
``tests/test_torch_train_track.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig, global_norm
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_leaves, tree_map

ALL_ARCHS = sorted(REF_ARCHS)
RTOL, ZERO = 1e-4, 1e-6
GATE = 5e-3      # chip_smoke.py's TRAIN_BF16_RTOL
GNORM_GATE = 2e-2   # chip_smoke.py's TRAIN_BF16_GNORM_RTOL
B, S, CHUNK = 2, 40, 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return ref_reduced(ref_get_config(arch)), reduced(get_config(arch))


def _batch_np(cfg, seed=0, b=B, s=S) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _port_batch(batch_np) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    rcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, ref_steps.init_train_state(
        rcfg, ref_adamw.OptConfig(), seed=0))


def _port_params(arch) -> dict:
    _, cfg = _cfgs(arch)
    return convert.train_state_from_reference(cfg, _ref_state(arch),
                                              device="cpu")["params"]


def _port_loss_and_grads(arch, remat="full"):
    _, cfg = _cfgs(arch)
    params = tree_map(lambda a: a.requires_grad_(), _port_params(arch))
    b = _port_batch(_batch_np(cfg))
    loss, met = steps.make_loss_fn(cfg, loss_chunk=CHUNK, remat=remat)(
        params, b["tokens"], b["labels"], b.get("frames"))
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in met.items()},
            tree_map(lambda a: a.grad, params))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    batch = _batch_np(cfg)
    loss_fn = ref_steps.make_loss_fn(rcfg, loss_chunk=CHUNK)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, _ref_state(arch)["params"]),
        jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
        None if "frames" not in batch else jnp.asarray(batch["frames"]))
    loss, met, grads = _port_loss_and_grads(arch)
    for got, want in ((loss, rloss), (met["ce"], rmet["ce"]),
                      (met["aux"], rmet["aux"])):
        assert abs(float(got) - float(want)) <= RTOL * max(
            1.0, abs(float(want)))
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(rgrads)[0]}
    got = {"".join(f"[{k!r}]" for k in p): g.numpy()
           for p, g in tree_items(grads)}
    assert got.keys() == want.keys()
    top = max(float(np.abs(g).max()) for g in want.values())
    zero_leaves = []
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        if scale < ZERO * top:
            zero_leaves.append(k)
            assert float(np.abs(got[k]).max()) < ZERO * top, k
        else:
            assert err <= RTOL * scale, (k, err, scale)
    assert all("['cross']['bk']" in k for k in zero_leaves), zero_leaves
    assert bool(zero_leaves) == (cfg.family == "encdec" and cfg.qkv_bias)


@pytest.mark.parametrize("remat", ["dots", False], ids=["dots", "none"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "mamba2-130m", "zamba2-1.2b",
                                  "whisper-large-v3"])
def test_remat_policies_agree(arch, remat):
    loss, met, grads = _port_loss_and_grads(arch, remat="full")
    loss2, met2, grads2 = _port_loss_and_grads(arch, remat=remat)
    assert torch.equal(loss, loss2)
    assert torch.equal(met["aux"], met2["aux"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(grads), tree_leaves(grads2)))


def test_remat_recomputes_in_the_backward_pass():
    """The backward pass replays each layer's forward under ``"full"``
    (up to the last operation whose output the backward needs: the MLP's
    down projection is not replayed), only its unsaved products (the
    batched attention einsums) under ``"dots"``, and nothing without
    remat: its counted FLOPs order that way."""
    _, cfg = _cfgs("qwen3-0.6b")
    b = _port_batch(_batch_np(cfg))
    flops = {}
    for remat in ("full", "dots", False):
        params = tree_map(lambda a: a.requires_grad_(),
                          _port_params("qwen3-0.6b"))
        with FlopCounterMode(display=False) as fwd:
            x, _ = T.forward(params, cfg, b["tokens"], remat=remat,
                             return_hidden=True)
        with FlopCounterMode(display=False) as bwd:
            x.float().square().sum().backward()
        flops[remat] = (fwd.get_total_flops(), bwd.get_total_flops())
    (f_full, b_full), (f_dots, b_dots), (f_none, b_none) = (
        flops["full"], flops["dots"], flops[False])
    assert f_full == f_dots == f_none
    down = 2 * B * S * cfg.d_ff * cfg.d_model * cfg.n_layers
    assert b_full == b_none + f_full - down, flops
    assert b_none < b_dots < b_full, flops


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_smoke(arch):
    _, cfg = _cfgs(arch)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = steps.init_train_state(cfg, opt, seed=0, device="cpu")
    before = [a.clone() for a in tree_leaves(state["params"])]
    step = steps.make_train_step(cfg, opt, loss_chunk=64)
    state, metrics = step(state, _port_batch(_batch_np(cfg, s=32)))
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    # params actually changed
    assert max(float((a - b).abs().max()) for a, b in
               zip(before, tree_leaves(state["params"]))) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_bf16_loss_gap(arch):
    """The loss in bf16 compute against float32 on the same weights and
    batch (B = 4, S = 128): about 2e-5 relative for the dense configs,
    1e-4 for the SSM ones and 1.07e-3 for olmoe (bf16 moves tokens
    between experts).  Smoke phase 18 (b) holds qwen2-0.5b at its
    published width to ``GATE``, five times the largest of these gaps;
    every gap stays below half of it."""
    _, cfg = _cfgs(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
    lab = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
    frames = (torch.tensor(rng.normal(size=(4, cfg.n_frames, cfg.d_model)),
                           dtype=torch.float32)
              if cfg.family == "encdec" else None)
    loss = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dt)
        with torch.no_grad():
            loss[dt] = float(steps.make_loss_fn(c, loss_chunk=256)(
                steps.cast_tree(params, c.cdtype), tok, lab, frames)[0])
    gap = abs(loss["bfloat16"] - loss["float32"]) / loss["float32"]
    assert gap < GATE / 2, (arch, loss)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_bf16_grad_norm_gap(arch):
    """The first step's gradient norm (before the clip) in bf16 compute
    against float32 on the same weights and batch (B = 4, S = 128, accum
    2, as the trainer takes a step): 4.3e-4 to 1.28e-3 relative for the
    dense, SSM and hybrid configs, 6.5e-3 and 7.8e-3 for the MoE ones
    (bf16 moves tokens between experts).  Smoke phase 18 (b) holds
    qwen2-0.5b at its published width to ``GNORM_GATE``, about fifteen
    times the dense configs' largest gap (a model with six times their
    layers and a 300 times wider vocabulary); every gap stays below half
    of it."""
    _, cfg = _cfgs(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(
            rng.normal(size=(4, cfg.n_frames, cfg.d_model)),
            dtype=torch.float32)
    norm = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dt)
        _, _, grads = steps.make_grad_step(c, OptConfig(), accum=2,
                                           loss_chunk=256)(params, batch)
        norm[dt] = float(global_norm(grads))
    gap = abs(norm["bfloat16"] - norm["float32"]) / norm["float32"]
    assert gap < GNORM_GATE / 2, (arch, norm)
