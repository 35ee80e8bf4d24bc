"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064. GQA + QKV bias [hf:Qwen/Qwen2.5 family]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    vocab=152064,
    d_model=5120,
    n_layers=64,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    qkv_bias=True,
    rope_theta=1e6,
    param_dtype="bfloat16",
)
