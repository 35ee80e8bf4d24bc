"""hubert-xlarge [audio]: encoder-only 48L d_model=1280 16H (MHA kv=16)
d_ff=5120 vocab=504 (masked-unit targets) [arXiv:2106.07447].

The conv waveform frontend is a STUB: ``input_specs`` provides
precomputed 512-d frame embeddings (the conv stack's output dim) which the
model projects to d_model. Encoder-only: no decode shapes."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    vocab=504,
    d_model=1280,
    n_layers=48,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    causal=False,                 # bidirectional encoder
    frontend_dim=512,
    rope_theta=1e4,
)
