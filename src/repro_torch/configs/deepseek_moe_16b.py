"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) vocab=102400,
fine-grained MoE: 2 shared + 64 routed top-6, d_ff_expert=1408; first
layer dense (d_ff=10944) [arXiv:2401.06066]."""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    vocab=102400,
    d_model=2048,
    n_layers=28,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,                    # layer-0 dense FFN
    moe=MoEConfig(
        n_routed=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        freq=1,
        first=1,                   # layer 0 stays dense
    ),
    rope_theta=1e4,
)
