"""gemma3-4b [dense] — 5:1 local:global, window 1024, 128k ctx, qk-norm,
tied embeddings [hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    window_size=1024, global_every=6,
    qk_norm=True, tie_embeddings=True,
    rope_theta=1e6, rope_theta_local=1e4,
)
