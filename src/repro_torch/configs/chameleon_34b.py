"""chameleon-34b [vlm] — early-fusion; image VQ tokens share the 65536
vocab, so the backbone is a dense decoder and the VQ tokenizer is a STUB
(input_specs provides token ids) [arXiv:2405.09818; unverified].
Chameleon uses qk-norm for stability — kept."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, rope_theta=1e4,
    frontend="vq_stub",
)
