"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936. GQA + QKV bias [arXiv:2407.10671]. head_dim=64, tied
embeddings (the 0.5B Qwen2 ties lm_head to the embedding)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    vocab=151936,
    d_model=896,
    n_layers=24,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
