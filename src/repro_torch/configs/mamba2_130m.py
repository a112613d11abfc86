"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)
