"""deepseek-v2-lite [moe, MLA]: 27L d_model=2048 16H vocab=102400, untied.

Multi-head latent attention: one 512-wide latent (kv_lora_rank) and one
64-wide rotary key per token, query heads of 128 (nope) + 64 (rope),
value heads of 128, no query LoRA; YaRN rope (factor 40 over 4096
positions, beta 32 / 1, mscale and mscale_all_dim 0.707, theta 1e4).
MoE on every layer after the first: 64 routed experts of 1408, top-6 by
softmax with the gates not renormalised, 2 shared experts; layer 0 a
dense SwiGLU of 10944. rms_norm_eps 1e-6.
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434]

``routed_scaling_factor`` is 1 and ``topk_method`` greedy, which the
router does as it is; ``n_group`` / ``topk_group`` 1 (no group-limited
routing).
"""
from ..models.config import MLAConfig, PortArchConfig, PortMoEConfig, YaRNConfig

CONFIG = PortArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    vocab=102400,
    d_model=2048,
    n_layers=27,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,                  # v_head_dim; the widths are MLA's
    d_ff=10944,                    # layer-0 dense FFN
    moe=PortMoEConfig(
        n_routed=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        freq=1,
        first=1,                   # first_k_dense_replace
        norm_topk_prob=False,
    ),
    rope_theta=1e4,
    norm_eps=1e-6,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    rope_scaling=YaRNConfig(factor=40.0, original_max_position_embeddings=4096,
                            beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                            mscale_all_dim=0.707),
)
