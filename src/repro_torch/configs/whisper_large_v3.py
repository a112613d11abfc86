"""whisper-large-v3 [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs provides precomputed (B, 1500, d_model) frame embeddings)
[arXiv:2212.04356; unverified].  Learned absolute positions replaced by
sinusoidal (DESIGN.md §Deviations)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    n_frames=1500, frontend="audio_stub",
    qkv_bias=True,
)
