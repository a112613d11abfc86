"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    n_experts=64, top_k=8,
    rope_theta=1e4, qk_norm=True,
)
