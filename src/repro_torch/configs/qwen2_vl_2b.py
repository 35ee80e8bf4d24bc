"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE (t/h/w sections), QKV bias [arXiv:2409.12191].

The vision tower is a STUB: ``input_specs`` provides precomputed patch
embeddings merged into the prompt prefix plus the 3-axis M-RoPE position
ids (the backbone is the assigned component)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    vocab=151936,
    d_model=1536,
    n_layers=28,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),  # sums to head_dim//2
    max_vision_tokens=256,
    rope_theta=1e6,
)
