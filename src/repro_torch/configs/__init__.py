"""Architecture registry of the port (counterpart of ``repro.configs``):
the published configs by id, and ``reduced``.

Each module defines the exact published config; ``reduced(cfg)`` derives a
CPU-smoke-test variant of the same family (small widths/few experts/tiny
vocab) used by tests and examples.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig

from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3_1b
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3_4b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2

ARCHS: dict[str, ModelConfig] = {
    "olmoe-1b-7b": _olmoe,
    "llama4-scout-17b-a16e": _llama4,
    "zamba2-1.2b": _zamba2,
    "whisper-large-v3": _whisper,
    "chameleon-34b": _chameleon,
    "qwen2-0.5b": _qwen2,
    "gemma3-1b": _gemma3_1b,
    "qwen3-0.6b": _qwen3,
    "gemma3-4b": _gemma3_4b,
    "mamba2-130m": _mamba2,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few small layers,
    few experts, tiny vocab — structure preserved (window pattern, MoE
    top-k, hybrid period, enc-dec)."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 7,
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_multiple=64,
        head_dim=32 if cfg.n_heads else 0,
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        window_size=64 if cfg.window_size else 0,
        global_every=cfg.global_every and 3,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=32,
        hybrid_attn_every=3 if cfg.hybrid_attn_every else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frames=24 if cfg.family == "encdec" else cfg.n_frames,
        dtype="float32",
    )
    if cfg.n_heads and cfg.n_kv_heads == 1:
        changes["n_kv_heads"] = 1
    return dataclasses.replace(cfg, **changes)
