"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152. llama-arch code model [arXiv:2405.04324]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    vocab=49152,
    d_model=6144,
    n_layers=52,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    rope_theta=1e5,
    param_dtype="bfloat16",
)
