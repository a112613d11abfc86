"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].  The shared transformer block (attn + MLP,
d_ff 8192) is applied after every 6th mamba layer with per-application KV
caches; the paper's per-application LoRA deltas are omitted (DESIGN.md
§Deviations)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    hybrid_attn_every=6,
    rope_theta=1e4,
)
