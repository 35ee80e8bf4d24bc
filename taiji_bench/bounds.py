"""The yardstick's arithmetic: the card's peaks, the bytes and operations
each kernel on a measured path needs, and a decode step's model FLOPs.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit;
the byte and operation counts are copied from ``chip_smoke.py``'s kernel
bounds (``check_kernels``, ``check_paged_attention``): every input byte
read once and every output byte written once, whatever a kernel reads
again, and for the swap kernels the rows that these inputs need (a zero
row is flagged, not copied).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound_s(nbytes: float, nops: float, ops_per_s: float) -> float:
    """The least time: the larger of bytes over bandwidth and operations
    over the operation rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


# ------------------------------------------------------------- swap kernels
def gather_nonzero_s(rows: int, live: int, chunks: int, mp: int) -> float:
    """The swap-out's compacting gather over ``chunks`` launches: every
    row read, the ``live`` (non-zero) rows written, a flag per row and a
    count per launch; one operation per byte read (the zero scan)."""
    return bound_s(rows * mp + live * mp + rows + 4 * chunks, rows * mp,
                   INT32_OPS_PER_S)


def fletcher_s(live: int, mp: int) -> float:
    """Fletcher tags of the ``live`` rows: each read once, a 4-byte tag
    written; two sums of one multiply-add each per byte."""
    return bound_s(live * mp + 4 * live, 4 * live * mp, INT32_OPS_PER_S)


def scatter_verified_s(rows: int, live: int, chunks: int, mp: int) -> float:
    """The swap-in's verified scatter: the ``live`` staged rows read and
    their tags checked, every row written (zero rows zeroed), a tag read
    per live row and a verdict per launch."""
    return bound_s(live * mp + rows * mp + 8 * live + 4 * chunks, 4 * live * mp,
                   INT32_OPS_PER_S)


# ---------------------------------------------------------- paged attention
def paged_attn_s(batch: int, kv_lens, n_heads: int, n_kv: int, hd: int,
                 max_blocks: int, q_bytes: int = 2, pool_bytes: int = 2) -> float:
    """One paged decode-attention launch: each sequence's K and V over its
    ``kv_len`` positions read once, q read and the output written, the
    block table and the lengths read; QK and PV as 2 multiply-adds per
    element (float32 accumulation)."""
    kv = int(sum(int(n) for n in kv_lens))
    kv_bytes = kv * 2 * n_kv * hd * pool_bytes
    io_bytes = 2 * batch * n_heads * hd * q_bytes + batch * max_blocks * 4 + batch * 4
    return bound_s(kv_bytes + io_bytes, 4 * n_heads * kv * hd, FP32_OPS_PER_S)


# ------------------------------------------------------------- decode step
def decode_step_flops(cfg: dict, batch: int, kv_lens) -> float:
    """Model FLOPs of one decode step of a dense GQA decoder (multiply-add
    = 2): every projection, the SwiGLU FFN and the logits for each
    sequence, and attention's QK and PV over each sequence's positions.
    ``cfg`` is the configuration file's dict (the published keys)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv, f = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"]
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    matmul = cfg["num_hidden_layers"] * per_layer + d * cfg["vocab_size"]
    attn = cfg["num_hidden_layers"] * 4 * h * hd * float(sum(int(n) for n in kv_lens))
    return 2.0 * matmul * batch + attn
