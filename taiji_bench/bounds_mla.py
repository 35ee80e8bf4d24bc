"""The yardstick's arithmetic for the latent-attention (MLA) decode cell:
the paged MLA kernel's bound and a DeepSeek-V2 decode step's model
FLOPs, from the configuration file's published keys. The card's peaks
are ``bounds.py``'s (NVIDIA's data sheet for one H100 SXM at 700 W).

The kernel's work is counted as ``kernels/ops.py::paged_mla_cost``
counts it: each sequence's latent rows over its ``kv_len`` read once,
q, the table and the lengths read once, the output written once; per
row and head 2 FLOPs per multiply-add of the score (the whole row) and
of the value (the latent). On the tensor cores in bf16 its bytes bound
it.
"""
from __future__ import annotations

from . import bounds


def paged_mla_s(cfg: dict, batch: int, kv_lens, max_blocks: int,
                q_bytes: int = 2, pool_bytes: int = 2) -> float:
    """The least time of one paged MLA launch: the larger of its bytes
    over the card's bandwidth and its FLOPs over the bf16 peak."""
    h, rank = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    width = rank + cfg["qk_rope_head_dim"]
    rows = int(sum(int(n) for n in kv_lens))
    nbytes = (rows * width * pool_bytes + batch * h * (width + rank) * q_bytes
              + batch * max_blocks * 4 + batch * 4)
    flops = 2 * rows * h * (width + rank)
    return max(nbytes / bounds.HBM_BYTES_PER_S, flops / bounds.BF16_FLOPS_PER_S)


def active_matmul_params(cfg: dict) -> int:
    """Matrix parameters one token multiplies through: per layer q, kv_a,
    kv_b and o; layer 0's SwiGLU (each of the first
    ``first_k_dense_replace``); each MoE layer's router, its top-k routed
    experts and its shared experts; the head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    rank, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    nope, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    attn = d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + dv) + h * dv * d
    dense = 3 * d * cfg["intermediate_size"]
    fe = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"] + cfg["num_experts_per_tok"] * 3 * d * fe
           + cfg["n_shared_experts"] * 3 * d * fe)
    L, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return L * attn + k * dense + (L - k) * moe + d * cfg["vocab_size"]


def decode_step_flops(cfg: dict, batch: int, kv_lens) -> float:
    """Model FLOPs of one decode step (multiply-add = 2): 2 x the active
    matrix parameters for each sequence, and per attention layer the
    published form's QK and PV, 2 x heads x kv_len x (qk width + v
    width), over each sequence's positions."""
    h = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn = (cfg["num_hidden_layers"] * 2 * h * (qk + cfg["v_head_dim"])
            * float(sum(int(n) for n in kv_lens)))
    return 2.0 * active_matmul_params(cfg) * batch + attn
