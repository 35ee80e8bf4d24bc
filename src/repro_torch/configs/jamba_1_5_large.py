"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536; mamba:attn 7:1 interleave, MoE 16 experts top-2 on
every other layer [arXiv:2403.19887]."""
from ..models.config import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    vocab=65536,
    d_model=8192,
    n_layers=72,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    hybrid_group=8,                # 1 attention per 8 layers
    attn_index=4,
    moe=MoEConfig(
        n_routed=16,
        top_k=2,
        d_ff_expert=24576,
        n_shared=0,
        freq=2,                    # every other layer (encoded in group body)
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=64),
    rope_theta=1e6,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",          # 398B optimizer state must fit v5e HBM
)
