"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm + GQA; head_dim=128 per the Qwen3 family config [hf:Qwen/Qwen3-8B].
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    vocab=151936,
    d_model=2560,
    n_layers=36,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1e6,
)
