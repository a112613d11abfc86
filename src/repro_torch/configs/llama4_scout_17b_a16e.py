"""llama4-scout-17b-16e [moe] — 16 routed experts top-1 + shared expert,
chunked-local:global attention 3:1 (8192-token chunks)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, n_shared_experts=1,
    window_size=8192, global_every=4,
    rope_theta=5e5, rope_theta_local=5e5,
)
