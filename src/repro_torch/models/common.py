"""Model configuration of the port (counterpart of the config part of
``repro.models.common``): ``ModelConfig`` and ``round_up``, the values
the einsum planner's ``model_planner_trace`` plans at.  The model layers
themselves are not ported; ``cdtype`` gives the compute dtype as a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

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
