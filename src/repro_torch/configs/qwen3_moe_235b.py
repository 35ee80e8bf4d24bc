"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4), MoE 128
routed experts top-8, d_ff_expert=1536, vocab=151936, qk_norm
[hf:Qwen/Qwen3-235B-A22B family]."""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    vocab=151936,
    d_model=4096,
    n_layers=94,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                        # every layer is MoE
    qk_norm=True,
    moe=MoEConfig(
        n_routed=128,
        top_k=8,
        d_ff_expert=1536,
        n_shared=0,
        freq=1,
        first=0,
    ),
    rope_theta=1e6,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",          # 235B optimizer state must fit v5e HBM
)
