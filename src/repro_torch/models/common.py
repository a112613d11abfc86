"""Shared model substrate of the port (counterpart of
``repro.models.common``): ``ModelConfig`` and ``round_up``, the
primitive layers (``rms_norm``, ``rope``, the sinusoidal encodings) and
the initializer.

Parameters are nested dicts of tensors with the reference's shapes
(``(d_in, d_out)`` matrices), stored float32 and cast to ``cfg.cdtype``
(a ``torch.dtype``) at use.  ``jax.random`` keys become an explicit
``torch.Generator``: every init function draws from the generator it is
given, so one seed and one device give the same weights.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers every assigned architecture family."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_local: float = 1e4
    window_size: int = 0            # 0 => full attention
    global_every: int = 0           # e.g. 6 => layers 5, 11, ... are global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid: one shared attention+MLP block applied every k ssm layers
    hybrid_attn_every: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    n_frames: int = 1500            # whisper stub frontend output length
    # embeddings / output
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    # numerics
    dtype: str = "bfloat16"
    # decode KV cache quantization: "" = native dtype; "int8" halves the
    # dominant decode memory-roofline term (per-entry symmetric scales)
    kv_cache_dtype: str = ""
    # frontends (vlm/audio) are STUBS: input_specs provides embeddings/ids
    frontend: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def cdtype(self) -> torch.dtype:
        """The compute dtype as a ``torch.dtype`` (``"bfloat16"`` ->
        ``torch.bfloat16``)."""
        return getattr(torch, self.dtype)

    def is_global_layer(self, i: int) -> bool:
        if self.window_size == 0:
            return True
        if self.global_every == 0:
            return False
        return (i + 1) % self.global_every == 0

    def layer_is_attn(self, i: int) -> bool:
        """hybrid: which backbone positions get the shared attention block
        applied after them."""
        if self.family != "hybrid" or self.hybrid_attn_every == 0:
            return False
        return (i + 1) % self.hybrid_attn_every == 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        p = 0
        V, D = self.padded_vocab, self.d_model
        p += V * D                                    # embed
        if not self.tie_embeddings:
            p += V * D                                # unembed
        if self.family in ("dense", "moe", "vlm", "encdec"):
            per = self._attn_params() + self._mlp_params()
            n_dec = self.n_layers
            p += n_dec * per
            if self.family == "encdec":
                # encoder: self-attn + mlp; decoder adds cross-attn
                p += self.n_enc_layers * (self._attn_params()
                                          + self._mlp_params())
                p += self.n_layers * self._attn_params()   # cross-attn
        elif self.family == "ssm":
            p += self.n_layers * self._ssm_params()
        elif self.family == "hybrid":
            p += self.n_layers * self._ssm_params()
            p += self._attn_params() + self._mlp_params()  # shared block
        return p

    def _attn_params(self) -> int:
        D, H, K, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        return D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D

    def _mlp_params(self) -> int:
        D, F = self.d_model, self.d_ff
        if self.n_experts:
            e = self.n_experts + self.n_shared_experts
            return e * 3 * D * F + D * self.n_experts    # experts + router
        return 3 * D * F                                 # swiglu

    def _ssm_params(self) -> int:
        D, Di, N, H = self.d_model, self.d_inner, self.ssm_state, \
            self.ssm_heads
        G = 1                                            # single BC group
        in_proj = D * (2 * Di + 2 * G * N + H)
        conv = (Di + 2 * G * N) * self.ssm_conv_width
        return in_proj + conv + 2 * H + Di + Di * D      # A,dt_bias,norm,out

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * self._mlp_params()
        act_mlp = (self.top_k + self.n_shared_experts) * 3 * D * F \
            + D * self.n_experts
        return dense_like + self.n_layers * act_mlp


# ------------------------------------------------------------- primitives
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, the two halves concatenated (not interleaved).
    x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encoding at run-time positions.  pos: (B,) -> (B, d)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None, :]
    ang = pos.float()[:, None] / torch.pow(10000.0, 2 * i / d)
    out = torch.zeros((pos.shape[0], d), dtype=torch.float32,
                      device=pos.device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


# ------------------------------------------------------------ initializers
class BlockGenerator:
    """A generator whose initializers keep a part of each leaf: ``keep``
    holds one function per leaf, in the order the leaves are drawn,
    mapping the whole leaf to the part to hold (a data-parallel rank's
    block).  Each leaf is drawn whole from ``gen`` and dropped once its
    part is taken, so no more than one whole leaf exists at a time, and
    the parts are those of the whole draw.  The initializers scale a
    draw by constants only, which commutes with taking a block."""

    def __init__(self, gen: torch.Generator, keep):
        self.gen, self.device = gen, gen.device
        self._keep = iter(keep)

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        return next(self._keep)(whole)

    def check_done(self) -> None:
        if next(self._keep, None) is not None:
            raise ValueError("fewer leaves were drawn than keep holds")


def normal(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` on the generator's
    device; on the meta device, the shape alone (nothing is drawn)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    if isinstance(gen, BlockGenerator):
        return gen.take(torch.randn(shape, generator=gen.gen,
                                    dtype=torch.float32, device=gen.device))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, lead: tuple = ()) -> torch.Tensor:
    """A (``*lead``, d_in, d_out) float32 matrix: N(0, 1) times ``scale``
    (1/sqrt(d_in) by default).  ``lead`` is the (repeats,) axis of a
    stacked segment slot."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, tuple(lead) + (d_in, d_out)) * scale


def full(lead: tuple, shape: tuple, value: float,
         gen: torch.Generator) -> torch.Tensor:
    """A constant float32 leaf (norm scales, biases) on the generator's
    device."""
    x = torch.full(tuple(lead) + tuple(shape), value,
                   dtype=torch.float32, device=gen.device)
    return gen.take(x) if isinstance(gen, BlockGenerator) else x
