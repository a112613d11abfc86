"""The port's LM layers (``repro_torch.models.{common,mlp,attention,ssm}``)
against ``repro``'s, module by module, on the same inputs.

Inputs come from numpy seeds; weights come from the reference's
initializers (with random values put into the norm scales and biases
that it initializes to constants, so that they count) and cross over as
numpy arrays.  Everything is float32.  Tolerance: ``RTOL = 1e-5`` of the
largest magnitude of the reference's result (float32 keeps about 7
digits; the two frameworks sum in other orders), except where a case
says otherwise.  Bitwise where both sides do the same exact operations:
the numpy sinusoid table and the int8 quantizer's rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp
from repro_torch.models import ssm

RTOL = 1e-5


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
    """The reduced config of ``arch`` in both packages, with changes."""
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes),
            dataclasses.replace(reduced(get_config(arch)), **changes))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: _t(v, device) for k, v in tree.items()}
    return torch.tensor(np.array(tree), device=device)


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() + 1e-12
    err = np.abs(got - want).max() / scale
    assert err <= rtol, err


def _randomize(p, rng, names):
    """Random values for leaves the reference initializes to constants."""
    p = dict(p)
    for k in names:
        if k in p:
            p[k] = (rng.normal(size=np.shape(p[k])) * 0.3).astype(np.float32)
    return p


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 7, 4, 8)],
                         ids=["BSD", "BSHD"])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    want = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    _close(common.rms_norm(torch.tensor(x), torch.tensor(scale)), want)


@pytest.mark.parametrize("theta", [1e4, 1e6], ids=["theta1e4", "theta1e6"])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    want = ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(common.rope(torch.tensor(x), torch.tensor(pos), theta), want)


@pytest.mark.parametrize("d", [8, 64], ids=["d8", "d64"])
def test_sinusoids(d):
    assert common.sinusoidal_positions(37, d).tobytes() == \
        ref_common.sinusoidal_positions(37, d).tobytes()
    pos = np.array([0, 3, 511, 575, 1499], np.int32)
    _close(common.sinusoidal_at(torch.tensor(pos), d),
           ref_common.sinusoidal_at(jnp.asarray(pos), d))


# --------------------------------------------------------------- mlp, moe
def test_mlp_forward():
    rcfg, _ = _cfgs("qwen3-0.6b")
    p = _np(ref_mlp.init_mlp(rcfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(2).normal(
        size=(2, 11, rcfg.d_model)).astype(np.float32)
    _close(mlp.mlp_forward(_t(p), torch.tensor(x)),
           ref_mlp.mlp_forward(p, jnp.asarray(x)))


@pytest.mark.parametrize("arch,cf", [
    ("olmoe-1b-7b", None), ("olmoe-1b-7b", 16.0),
    ("llama4-scout-17b-a16e", None), ("llama4-scout-17b-a16e", 16.0)],
    ids=["olmoe-default-cf", "olmoe-cf16", "llama4-default-cf",
         "llama4-cf16"])
def test_moe_forward(arch, cf):
    """At the default capacity factor expert 0 is made to win every
    token, so it overflows its capacity and tokens are dropped; at 16
    nothing is dropped.  The aux loss is compared too."""
    rcfg, cfg = _cfgs(arch) if cf is None else _cfgs(arch,
                                                     capacity_factor=cf)
    p = _np(ref_mlp.init_moe(rcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    B, S, D = 2, 32, rcfg.d_model
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    if cf is None:
        x = x + 1.0
        p["router"] = p["router"].copy()
        p["router"][:, 0] += 0.1
        cap = min(max(int(S * rcfg.top_k / rcfg.n_experts
                          * rcfg.capacity_factor), 4), S)
        assert cap < S        # expert 0 takes all S tokens: S - cap drop
    want_y, want_aux = ref_mlp.moe_forward(p, jnp.asarray(x), rcfg)
    y, aux = mlp.moe_forward(_t(p), torch.tensor(x), cfg)
    _close(y, want_y)
    _close(aux, want_aux)


# -------------------------------------------------------------- attention
def _qkv(rng, B, S, T, H, K, hd):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, T, K, hd)).astype(np.float32),
            rng.normal(size=(B, T, K, hd)).astype(np.float32))


@pytest.mark.parametrize("case", [
    dict(S=40, causal=True, window=0, scheme="simple"),
    dict(S=40, causal=True, window=16, scheme="simple"),
    dict(S=40, causal=True, window=5, scheme="simple"),
    dict(S=30, causal=True, window=0, scheme="zigzag"),
    dict(S=32, causal=True, window=0, scheme="zigzag"),
    dict(S=40, T=24, causal=False, window=0, scheme="simple")],
    ids=["causal", "window16", "window5", "zigzag-padded", "zigzag",
         "cross"])
def test_chunked_attention(case):
    """q_block = k_block = 8: several query and key blocks, padding
    where S is not a block multiple, clipped window offsets, the zigzag
    pairing (nq even, S == T) and non-causal cross attention (T != S)."""
    rng = np.random.default_rng(5)
    B, H, K, hd = 2, 4, 2, 16
    S = case["S"]
    T = case.get("T", S)
    q, k, v = _qkv(rng, B, S, T, H, K, hd)
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    k_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    kw = dict(causal=case["causal"], window=case["window"], q_block=8,
              k_block=8, scheme=case["scheme"])
    want = ref_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), **kw)
    got = attn.chunked_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(q_pos), torch.tensor(k_pos), **kw)
    _close(got, want)
    assert torch.isfinite(got).all()


def test_chunked_attention_fully_masked_block_has_no_nan():
    """A first block that masks every key of a row (a clipped window
    offset) leaves p = 1 rows that the next real block's corr wipes out:
    NEG_INF is finite, so nothing becomes NaN."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 1, 16, 16, 2, 1, 8)
    pos = np.arange(16, dtype=np.int32)[None]
    args = [torch.tensor(a) for a in (q, k, v, pos, pos)]
    got = attn.chunked_attention(*args, causal=True, window=4, q_block=8,
                                 k_block=8)
    want = ref_attn.chunked_attention(*map(jnp.asarray, (q, k, v, pos,
                                                         pos)),
                                      causal=True, window=4, q_block=8,
                                      k_block=8)
    assert torch.isfinite(got).all()
    _close(got, want)


def _attn_params(rcfg, seed):
    p = _np(ref_attn.init_attention(rcfg, jax.random.PRNGKey(seed)))
    return _randomize(p, np.random.default_rng(seed),
                      ["bq", "bk", "bv", "q_norm", "k_norm"])


def _attn_cfgs(**changes):
    """A reduced qwen2 (qkv bias) with qk-norm too: both optional paths
    of the projection; 4 heads over 2 kv heads."""
    return _cfgs("qwen2-0.5b", qk_norm=True, **changes)


def test_attn_forward():
    rcfg, cfg = _attn_cfgs()
    p = _attn_params(rcfg, 7)
    x = np.random.default_rng(8).normal(
        size=(2, 40, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want, (wk, wv) = ref_attn.attn_forward(p, jnp.asarray(x),
                                           jnp.asarray(pos), rcfg,
                                           window=16, theta=1e4)
    got, (gk, gv) = attn.attn_forward(_t(p), torch.tensor(x),
                                      torch.tensor(pos), cfg, window=16,
                                      theta=1e4)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("window,quant", [(16, ""), (16, "int8"),
                                          (0, ""), (0, "int8")],
                         ids=["ring16", "ring16-int8", "global",
                              "global-int8"])
def test_attn_decode(window, quant):
    """40 decode steps: a ring of 16 wraps twice.  The output and every
    cache leaf against the reference after each step; int8 caches
    bitwise unless a value sits within float32 rounding of a half-way
    point (none does here)."""
    rcfg, cfg = _attn_cfgs()
    p = _attn_params(rcfg, 9)
    pt = _t(p)
    rng = np.random.default_rng(10)
    B, steps, K, hd = 2, 40, rcfg.n_kv_heads, rcfg.hd
    C = window or steps
    kv_dt = jnp.int8 if quant else jnp.float32
    rc = [jnp.zeros((B, C, K, hd), kv_dt), jnp.zeros((B, C, K, hd), kv_dt)]
    if quant:
        rc += [jnp.zeros((B, C, K), jnp.float32)] * 2
    pc = [torch.tensor(np.asarray(a)) for a in rc]
    for i in range(steps):
        x = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
        pos = np.array([i, i], np.int32)
        kw = dict(window=window, theta=1e4)
        if quant:
            want = ref_attn.attn_decode(p, rc[0], rc[1], jnp.asarray(x),
                                        jnp.asarray(pos), rcfg,
                                        k_scale=rc[2], v_scale=rc[3], **kw)
            got = attn.attn_decode(pt, pc[0], pc[1], torch.tensor(x),
                                   torch.tensor(pos), cfg, k_scale=pc[2],
                                   v_scale=pc[3], **kw)
        else:
            want = ref_attn.attn_decode(p, rc[0], rc[1], jnp.asarray(x),
                                        jnp.asarray(pos), rcfg, **kw)
            got = attn.attn_decode(pt, pc[0], pc[1], torch.tensor(x),
                                   torch.tensor(pos), cfg, **kw)
        rc, pc = list(want[1:]), list(got[1:])
        _close(got[0], want[0])
        for g, w in zip(pc, rc):
            if quant and g.dtype == torch.int8:
                assert np.array_equal(g.numpy(), np.asarray(w)), i
            else:
                _close(g, w)


def test_kv_quantize_rounds_half_to_even():
    """x / s lands on .5 exactly: both round half to even."""
    x = np.zeros((1, 1, 8), np.float32)
    x[0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -126.5]
    q, s = attn._kv_quantize(torch.tensor(x), torch.int8)
    rq, rs = ref_attn._kv_quantize(jnp.asarray(x), jnp.int8)
    assert q.numpy().tolist() == np.asarray(rq).tolist()
    assert q.numpy()[0, 0].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()


def test_cross_attn_decode():
    rcfg, cfg = _attn_cfgs()
    p = _attn_params(rcfg, 11)
    rng = np.random.default_rng(12)
    B, T = 2, 24
    ek = rng.normal(size=(B, T, rcfg.n_kv_heads, rcfg.hd)).astype(np.float32)
    ev = rng.normal(size=ek.shape).astype(np.float32)
    x = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
    _close(attn.cross_attn_decode(_t(p), torch.tensor(ek), torch.tensor(ev),
                                  torch.tensor(x), cfg),
           ref_attn.cross_attn_decode(p, jnp.asarray(ek), jnp.asarray(ev),
                                      jnp.asarray(x), rcfg))


# -------------------------------------------------------------------- ssm
def _ssm_params(rcfg, seed):
    p = _np(ref_ssm.init_ssm(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    p = _randomize(p, rng, ["conv_b", "norm", "D"])
    p["A_log"] = rng.normal(size=p["A_log"].shape).astype(np.float32) * 0.5
    p["dt_bias"] = (rng.normal(size=p["dt_bias"].shape) - 2).astype(
        np.float32)
    return p


@pytest.mark.parametrize("L", [40, 64, 7], ids=["L40", "L64", "L7"])
def test_ssm_forward(L):
    """ssm_chunk = 32: L = 40 pads to two chunks, 64 is two whole
    chunks, 7 is one short chunk."""
    rcfg, cfg = _cfgs("mamba2-130m")
    p = _ssm_params(rcfg, 13)
    x = np.random.default_rng(14).normal(
        size=(2, L, rcfg.d_model)).astype(np.float32)
    _close(ssm.ssm_forward(_t(p), torch.tensor(x), cfg),
           ref_ssm.ssm_forward(p, jnp.asarray(x), rcfg))


def test_causal_conv():
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    _close(ssm._causal_conv(*map(torch.tensor, (x, w, b))),
           ref_ssm._causal_conv(*map(jnp.asarray, (x, w, b))))


def test_ssm_decode():
    """24 steps: the output and both cache leaves after each step."""
    rcfg, cfg = _cfgs("mamba2-130m")
    p = _ssm_params(rcfg, 16)
    pt = _t(p)
    rng = np.random.default_rng(17)
    B = 2
    rc = ref_ssm.ssm_init_cache(rcfg, B, jnp.float32)
    pc = ssm.ssm_init_cache(cfg, B, torch.float32)
    for _ in range(24):
        x = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
        wy, rc = ref_ssm.ssm_decode(p, rc, jnp.asarray(x), rcfg)
        gy, pc = ssm.ssm_decode(pt, pc, torch.tensor(x), cfg)
        _close(gy, wy)
        _close(pc["conv"], rc["conv"])
        _close(pc["state"], rc["state"])


# ------------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["simple", "zigzag"])
def test_chunked_attention_on_card_matches_cpu(cuda_device, scheme):
    """float32 on the card (TF32 off) against the port on the CPU."""
    rng = np.random.default_rng(18)
    q, k, v = _qkv(rng, 2, 32, 32, 4, 2, 16)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    kw = dict(causal=True, window=0, q_block=8, k_block=8, scheme=scheme)
    args = [torch.tensor(a) for a in (q, k, v, pos, pos)]
    want = attn.chunked_attention(*args, **kw)
    got = attn.chunked_attention(*[a.to(cuda_device) for a in args], **kw)
    _close(got, want.numpy())
