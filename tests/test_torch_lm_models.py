"""The port's LM models (``repro_torch.models.transformer``), serve steps
(``train.steps``) and serving CLI (``launch.serve``) against ``repro``.

Every one of the ten reduced configs, float32, B = 2, S = 40 (not a block
multiple: the padding path), with the reference's weights carried over
by ``convert.lm_params_from_reference``:

  * the port's ``forward`` against the reference's ``forward``, and the
    port's decode sequence against the reference's ``decode_step``,
    teacher-forced on the same tokens: within ``RTOL = 1e-4`` of the
    largest |logit| of each position (float32 keeps about 7 digits; the
    two frameworks sum in other orders over a few layers; about 1e-6 is
    expected);
  * the port's decode against the port's forward within 2e-3, the
    reference's own contract (``tests/test_decode_equiv.py``; MoE with
    ``capacity_factor = 16``, so that the forward drops nothing), and
    int8 KV caches within 5e-2.

The reference's ``tests/test_models.py`` contracts run on the port, and
the CLI runs on the CPU when asked for it and raises without a card
otherwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import mlp as ref_mlp
from repro.models import transformer as RT
from repro.train import steps as ref_steps
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch import serve
from repro_torch.models import mlp
from repro_torch.models import transformer as T
from repro_torch.train import steps

ALL_ARCHS = sorted(REF_ARCHS)
RTOL = 1e-4
B, S = 2, 40
MOE_NO_DROP = {"olmoe-1b-7b", "llama4-scout-17b-a16e"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfgs(arch, **changes):
    if arch in MOE_NO_DROP:
        changes.setdefault("capacity_factor", 16.0)
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes),
            dataclasses.replace(reduced(get_config(arch)), **changes))


def _inputs(cfg, seed=0, steps_=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, steps_)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
    return tok, frames


def _rel_err(got, want) -> float:
    """Largest error of any position, relative to that position's
    largest |logit|; ``got``/``want``: (B, S, V) or (B, V)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-6
    return float((np.abs(got - want) / scale).max())


@functools.lru_cache(maxsize=None)
def _ref_params(arch, changes=()):
    """The reference's weights for one reduced config, as numpy."""
    rcfg, _ = _cfgs(arch, **dict(changes))
    return jax.tree.map(np.asarray, RT.init_params(rcfg, seed=0))


@functools.lru_cache(maxsize=None)
def _reference(arch, changes=()):
    """The reference's inputs, forward logits and teacher-forced decode
    logits (B, S, V) for one reduced config."""
    rcfg, _ = _cfgs(arch, **dict(changes))
    params = jax.tree.map(jnp.asarray, _ref_params(arch, changes))
    tok, frames = _inputs(rcfg)
    fr = None if frames is None else jnp.asarray(frames)
    fwd = jax.jit(lambda p, t, f: RT.forward(p, rcfg, t, frames=f,
                                             remat=False)[0])(
        params, jnp.asarray(tok), fr)
    cache = RT.init_cache(rcfg, B, max_seq=S)
    if rcfg.family == "encdec":
        enc_out, _ = RT.encode(params, rcfg, fr)
        cache = RT.build_cross_cache(params, rcfg, enc_out, cache)
    step = jax.jit(lambda c, t, p: RT.decode_step(params, rcfg, c, t, p))
    dec = []
    for i in range(S):
        lg, cache = step(cache, jnp.asarray(tok[:, i]),
                         jnp.full((B,), i, jnp.int32))
        dec.append(np.asarray(lg))
    return tok, frames, np.asarray(fwd), np.stack(dec, axis=1)


def _port_model(arch, changes=(), device="cpu"):
    _, cfg = _cfgs(arch, **dict(changes))
    params_np = _ref_params(arch, changes)
    return cfg, convert.lm_params_from_reference(cfg, params_np,
                                                 device=device)


def _port_decode(model, cfg, tok, frames, device="cpu"):
    cache = T.init_cache(cfg, B, max_seq=tok.shape[1], device=device)
    if cfg.family == "encdec":
        enc_out, _ = T.encode(model, cfg,
                              torch.tensor(frames, device=device))
        T.build_cross_cache(model, cfg, enc_out, cache)
    out = []
    with torch.no_grad():
        for i in range(tok.shape[1]):
            lg, cache = T.decode_step(
                model, cfg, cache, torch.tensor(tok[:, i], device=device),
                torch.full((B,), i, device=device))
            out.append(lg.cpu().numpy())
    return np.stack(out, axis=1)


def _port_forward(model, cfg, tok, frames, device="cpu", **kw):
    with torch.no_grad():
        lg, aux = T.forward(
            model, cfg, torch.tensor(tok, device=device),
            frames=None if frames is None else torch.tensor(frames,
                                                            device=device),
            **kw)
    return lg.cpu().numpy(), aux


# ------------------------------------------------- parity per architecture
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_paths_and_shapes_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda: RT.init_params(rcfg, seed=0))
    got = T.init_params(cfg, seed=0, device="cpu")
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [(jax.tree_util.keystr(p), tuple(a.shape)) for p, a in g_leaves] \
        == [(jax.tree_util.keystr(p), tuple(a.shape)) for p, a in w_leaves]
    assert all(a.dtype == torch.float32 for _, a in g_leaves)
    model = T.LM(cfg, got)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(a.shape)) for _, a in w_leaves)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_reference(arch):
    tok, frames, fwd, _ = _reference(arch)
    cfg, model = _port_model(arch)
    got, aux = _port_forward(model, cfg, tok, frames, remat=False)
    assert _rel_err(got, fwd) <= RTOL
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_reference(arch):
    tok, frames, _, dec = _reference(arch)
    cfg, model = _port_model(arch)
    assert _rel_err(_port_decode(model, cfg, tok, frames), dec) <= RTOL


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_equals_forward(arch):
    """The reference's gold contract on the port: teacher-forced decode
    (KV/SSM caches, ring buffers, rope at positions) reproduces the
    forward's logits within 2e-3."""
    tok, frames, _, _ = _reference(arch)
    cfg, model = _port_model(arch)
    fwd, _ = _port_forward(model, cfg, tok, frames, remat=False)
    assert _rel_err(_port_decode(model, cfg, tok, frames), fwd) < 2e-3


def test_ring_buffers_wrap_against_reference():
    """gemma3 reduced with a window of 16: the local layers' rings wrap
    twice in 40 steps; decode against the reference's decode and the
    port's forward."""
    changes = (("window_size", 16),)
    tok, frames, fwd_ref, dec_ref = _reference("gemma3-1b", changes)
    cfg, model = _port_model("gemma3-1b", changes)
    cache = T.init_cache(cfg, B, max_seq=S, device="cpu")
    assert cache["segments"][0]["slot0"]["k"].shape[2] == 16
    dec = _port_decode(model, cfg, tok, frames)
    assert _rel_err(dec, dec_ref) <= RTOL
    fwd, _ = _port_forward(model, cfg, tok, frames)
    assert _rel_err(fwd, fwd_ref) <= RTOL
    assert _rel_err(dec, fwd) < 2e-3


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_int8_kv_cache_decode(arch):
    """int8 KV caches: the port's decode against the port's forward
    within 5e-2 (the reference's serving tolerance) and against the
    reference's int8 decode within 1e-2: where float32 rounding moves a
    value across a half-way point, one int8 entry moves by one level
    (1/127 of its row's largest value)."""
    changes = (("kv_cache_dtype", "int8"),)
    rcfg, cfg = _cfgs(arch, **dict(changes))
    tok, frames, _, dec_ref = _reference(arch, changes)
    _, model = _port_model(arch, changes)
    cache = T.init_cache(cfg, B, max_seq=S, device="cpu")
    leaves = jax.tree_util.tree_leaves(cache)
    assert any(a.dtype == torch.int8 for a in leaves)
    dec = _port_decode(model, cfg, tok, frames)
    fwd, _ = _port_forward(model, cfg, tok, frames)
    assert _rel_err(dec, fwd) < 5e-2
    assert _rel_err(dec, dec_ref) < 1e-2


def test_mid_stream_cache_from_reference():
    """The reference decodes the first 20 tokens; its cache crosses over
    (``convert.lm_cache_from_reference``) and the port decodes the rest,
    against the reference's logits from there on."""
    arch = "zamba2-1.2b"            # ssm state, conv history, shared kv
    rcfg, cfg = _cfgs(arch)
    tok, frames, _, dec_ref = _reference(arch)
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    cache = RT.init_cache(rcfg, B, max_seq=S)
    rstep = jax.jit(lambda c, t, p: RT.decode_step(params, rcfg, c, t, p))
    for i in range(20):
        _, cache = rstep(cache, jnp.asarray(tok[:, i]),
                         jnp.full((B,), i, jnp.int32))
    pc = convert.lm_cache_from_reference(jax.tree.map(np.asarray, cache),
                                         device="cpu")
    _, model = _port_model(arch)
    out = []
    with torch.no_grad():
        for i in range(20, S):
            lg, pc = T.decode_step(model, cfg, pc, torch.tensor(tok[:, i]),
                                   torch.full((B,), i))
            out.append(lg.numpy())
    assert _rel_err(np.stack(out, axis=1), dec_ref[:, 20:]) <= RTOL


@pytest.mark.parametrize("kw", [{"remat": True}, {"unroll": True},
                                {"attn_scheme": "zigzag"}],
                         ids=["remat", "unroll", "zigzag"])
def test_forward_options_change_nothing(kw):
    """``remat`` and ``unroll`` are accepted and change no number, as the
    reference's tests assert of its own; at S = 40 one query block
    covers the sequence, so ``zigzag`` takes the simple schedule."""
    tok, frames, _, _ = _reference("gemma3-1b")
    cfg, model = _port_model("gemma3-1b")
    a, _ = _port_forward(model, cfg, tok, frames, remat=False)
    b, _ = _port_forward(model, cfg, tok, frames, **kw)
    assert np.array_equal(a, b)


def test_act_sharding_is_refused():
    tok, frames, _, _ = _reference("qwen2-0.5b")
    cfg, model = _port_model("qwen2-0.5b")
    with pytest.raises(ValueError, match="act_sharding"):
        T.forward(model, cfg, torch.tensor(tok), act_sharding=object())


def test_decode_past_max_seq_reference_drops_port_raises():
    """A position at or past a global cache's length: the reference's
    scatter drops the write without a word and attends over the stale
    cache (finite logits, cache unchanged); the port's indexing raises
    on the CPU instead of decoding from a stale cache."""
    rcfg, cfg = _cfgs("qwen3-0.6b")
    params = jax.tree.map(jnp.asarray, _ref_params("qwen3-0.6b"))
    cache = RT.init_cache(rcfg, B, max_seq=4)
    tok = jnp.array([3, 5], jnp.int32)
    for i in range(4):
        _, cache = RT.decode_step(params, rcfg, cache, tok,
                                  jnp.full((B,), i, jnp.int32))
    lg, after = RT.decode_step(params, rcfg, cache, tok,
                               jnp.full((B,), 4, jnp.int32))
    assert np.isfinite(np.asarray(lg)).all()
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(cache), jax.tree.leaves(after)))
    _, model = _port_model("qwen3-0.6b")
    pc = T.init_cache(cfg, B, max_seq=4, device="cpu")
    for i in range(4):
        T.decode_step(model, cfg, pc, torch.tensor([3, 5]),
                      torch.full((B,), i))
    with pytest.raises(IndexError):
        T.decode_step(model, cfg, pc, torch.tensor([3, 5]),
                      torch.full((B,), 4))


# --------------------------------------------------------------- the steps
def test_serve_steps_bf16_match_reference():
    """bfloat16 compute through both packages' ``make_prefill_step`` and
    ``make_decode_step`` (float32 masters cast at use): within 5e-2 of
    the largest |logit| (bf16 keeps 8 bits; the two frameworks round at
    other places).  The port's decode step casts once per parameter
    tree: two trees give two casts, one tree one."""
    changes = (("dtype", "bfloat16"),)
    rcfg, cfg = _cfgs("gemma3-1b", **dict(changes))
    tok, _ = _inputs(rcfg)
    params = jax.tree.map(jnp.asarray, _ref_params("gemma3-1b", changes))
    want = np.asarray(jax.jit(ref_steps.make_prefill_step(rcfg))(
        params, jnp.asarray(tok)), np.float32)
    _, model = _port_model("gemma3-1b", changes)
    got = steps.make_prefill_step(cfg)(model, torch.tensor(tok))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), want) < 5e-2

    rstep = jax.jit(ref_steps.make_decode_step(rcfg))
    rcache = RT.init_cache(rcfg, B, max_seq=S)
    step = steps.make_decode_step(cfg)
    cache = T.init_cache(cfg, B, max_seq=S, device="cpu")
    for i in range(S):
        rl, rcache = rstep(params, rcache, jnp.asarray(tok[:, i]),
                           jnp.full((B,), i, jnp.int32))
        lg, cache = step(model, cache, torch.tensor(tok[:, i]),
                         torch.full((B,), i))
        assert _rel_err(lg.float().numpy(), np.asarray(rl, np.float32)) \
            < 5e-2
    assert cache["segments"][0]["slot0"]["k"].dtype == torch.bfloat16


def test_cast_tree_keeps_matching_leaves():
    tree = {"a": torch.ones(2), "b": [torch.ones(2, dtype=torch.int32)]}
    out = steps.cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int32
    assert steps.cast_tree(tree, torch.float32)["a"] is tree["a"]


# ------------------------------------- the reference's test_models.py ones
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_smoke(arch):
    _, cfg = _cfgs(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    tok, frames = _inputs(cfg, steps_=32)
    logits, aux = _port_forward(params, cfg, tok, frames, remat=False)
    assert logits.shape == (B, 32, cfg.padded_vocab)
    assert np.isfinite(logits).all()
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_smoke(arch):
    _, cfg = _cfgs(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    cache = T.init_cache(cfg, B, max_seq=16, device="cpu")
    if cfg.family == "encdec":
        _, frames = _inputs(cfg)
        enc_out, _ = T.encode(params, cfg, torch.tensor(frames))
        T.build_cross_cache(params, cfg, enc_out, cache)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), a.dtype), cache)
    lg, cache2 = T.decode_step(params, cfg, cache,
                               torch.zeros((B,), dtype=torch.int64),
                               torch.zeros((B,), dtype=torch.int64))
    assert lg.shape == (B, cfg.padded_vocab)
    assert torch.isfinite(lg).all()
    # cache structure preserved (updated in place)
    assert cache2 is cache
    assert jax.tree.map(lambda a: (tuple(a.shape), a.dtype),
                        cache2) == shapes


def test_shape_applicability_table():
    """The documented skip set: long_500k only for sub-quadratic archs."""
    expect_skip = {"olmoe-1b-7b", "qwen2-0.5b", "qwen3-0.6b",
                   "chameleon-34b", "whisper-large-v3"}
    for arch, cfg in ARCHS.items():
        ok, reason = shape_applicable(cfg, SHAPES["long_500k"])
        assert ok == (arch not in expect_skip), (arch, ok, reason)
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert shape_applicable(cfg, SHAPES[s])[0]


def test_param_count_sane():
    """Analytic parameter counts in the advertised ballpark; gemma3-1b's
    is the published width's 999,751,680."""
    full = {
        "qwen2-0.5b": (3e8, 8e8),
        "qwen3-0.6b": (4e8, 9e8),
        "gemma3-1b": (7e8, 1.6e9),
        "mamba2-130m": (1e8, 2.2e8),
        "olmoe-1b-7b": (5e9, 9e9),
        "chameleon-34b": (2.5e10, 4.5e10),
        "llama4-scout-17b-a16e": (8e10, 1.4e11),
    }
    for arch, (lo, hi) in full.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, (arch, f"{n:.3e}")
        assert n == ref_get_config(arch).param_count()
    assert get_config("gemma3-1b").param_count() == 999_751_680
    for arch in ("olmoe-1b-7b", "llama4-scout-17b-a16e"):
        cfg = get_config(arch)
        assert cfg.active_param_count() < 0.5 * cfg.param_count()


def test_moe_dispatch_conservation():
    """Capacity dispatch: the output is finite and bounded, and the
    balance loss is about 1 for near-uniform routing."""
    _, cfg = _cfgs("olmoe-1b-7b", capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    p = mlp.init_moe(cfg, gen)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y, aux = mlp.moe_forward(p, x, cfg)
    assert y.shape == x.shape
    assert torch.isfinite(y).all()
    assert float(aux) > 0.5
    rp = ref_mlp.init_moe(ref_reduced(ref_get_config("olmoe-1b-7b")),
                          jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in rp.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


# ----------------------------------------------------------------- the CLI
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3",
                                  "zamba2-1.2b"])
def test_serve_cli_on_cpu(arch, capsys):
    rec = {"logits": True}
    rc = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                     "--prompt-len", "6", "--gen", "4", "--device", "cpu"],
                    record=rec)
    assert rc == 0
    assert "[serve]" in capsys.readouterr().out
    cfg = rec["cfg"]
    assert rec["logits"].shape == (2, 10, cfg.padded_vocab)
    assert all(len(t) == 4 and all(0 <= x < cfg.padded_vocab for x in t)
               for t in rec["out_tokens"])
    # the greedy tokens are the argmax of the decode logits before them
    fed = rec["tokens"]
    assert torch.equal(fed[:, 6:], rec["logits"][:, 5:9].argmax(-1))


def test_serve_cli_decode_equals_prefill_on_cpu():
    """What chip_smoke phase 17 checks at full width, here at reduced
    width: the decode path's logits against ``make_prefill_step`` over
    the same tokens, past a ring wrap (reduced gemma3's window is 64)."""
    rec = {"logits": True}
    serve.main(["--arch", "gemma3-1b", "--reduced", "--batch", "2",
                "--prompt-len", "64", "--gen", "8", "--device", "cpu"],
               record=rec)
    cfg = rec["cfg"]
    pre = steps.make_prefill_step(cfg)(rec["model"], rec["tokens"])
    assert _rel_err(rec["logits"].numpy(), pre.numpy()) < 2e-3


def test_serve_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])
    _, cfg = _cfgs("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_reference(cfg, {"embed": np.zeros(2)})


# ------------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b",
                                  "whisper-large-v3", "olmoe-1b-7b"])
def test_card_matches_cpu(cuda_device, arch):
    """float32 on the card (TF32 off) against the port on the CPU, on
    the same weights: forward and teacher-forced decode within RTOL."""
    tok, frames, _, _ = _reference(arch)
    cfg, model = _port_model(arch)
    cfg, card_model = _port_model(arch, device=cuda_device)
    fwd, _ = _port_forward(model, cfg, tok, frames)
    got, _ = _port_forward(card_model, cfg, tok, frames, device=cuda_device)
    assert _rel_err(got, fwd) <= RTOL
    dec = _port_decode(model, cfg, tok, frames)
    got = _port_decode(card_model, cfg, tok, frames, device=cuda_device)
    assert _rel_err(got, dec) <= RTOL


@pytest.mark.cuda
def test_serve_cli_on_card(cuda_device):
    rec = {"logits": True}
    assert serve.main(["--arch", "gemma3-1b", "--reduced", "--batch", "2",
                       "--prompt-len", "64", "--gen", "8"], record=rec) == 0
    assert rec["logits"].device.type == "cuda"
    pre = steps.make_prefill_step(rec["cfg"])(rec["model"], rec["tokens"])
    assert _rel_err(rec["logits"].cpu().numpy(), pre.cpu().numpy()) < 2e-3
