"""gemma3-1b [dense] — 5:1 local:global attention, window 512, 128k ctx,
qk-norm, tied embeddings [hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    window_size=512, global_every=6,
    qk_norm=True, tie_embeddings=True,
    rope_theta=1e6, rope_theta_local=1e4,
)
