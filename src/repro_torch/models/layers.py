"""Core transformer layers for the decode path: RMSNorm, RoPE / M-RoPE,
single-token decode attention, SwiGLU MLP.

Each function follows ``repro/models/layers.py`` operation for operation
(the same dtypes at the same places). ``decode_attention`` is the plain
counterpart of the paged kernel's math over an already-gathered KV view;
the tests hold it against the JAX function, and ``model.decode_step``
reads KV through ``kernels.ops.paged_decode_attention`` instead.

The reference's ``shard_ctx`` hints are no-ops without a mesh and are
left out. Chunked (flash-semantics) attention and ``attention_block``
come with the forward/training slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dtype)


# --------------------------------------------------------------------- rope
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin of shape (..., S, dim//2)."""
    half = dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2) or (S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def mrope_cos_sin(pos_ids: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (qwen2-vl): pos_ids (3, B, S) for (t, h, w) axes.

    Each rotary pair belongs to one of the three sections; its angle uses
    that axis's position id. Returns cos/sin (B, S, head_dim//2).
    """
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to {half}")
    dev = pos_ids.device
    ar = torch.arange(0, half, dtype=torch.float32, device=dev)
    freqs = 1.0 / (theta ** (ar / half))
    # section id per rotary pair: [0]*s0 + [1]*s1 + [2]*s2
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long, device=dev)
                        for i, s in enumerate(sections)])
    # pick the position for each pair from the matching (t/h/w) axis:
    # (half, B, S) -> (B, S, half)
    pos = pos_ids.float()[sec_id, :, :].permute(1, 2, 0)
    ang = pos * freqs[None, None, :]
    return torch.cos(ang), torch.sin(ang)


# -------------------------------------------------------- decode attention
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, 1, Hq, hd); k/v: (B, S, Hkv, hd); kv_len: (B,) valid lengths.
    As the reference: ``q * scale`` and the probabilities are rounded to
    the input dtypes before their products, which accumulate in f32.
    """
    B, _, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    scale = scale if scale is not None else hd ** -0.5
    g = Hq // Hkv
    qg = (q.float() * scale).to(q.dtype).reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float())
    if kv_len is not None:
        pos = torch.arange(S, device=s.device)
        mask = pos[None, None, None, :] < kv_len[:, None, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, 1, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------- mlp
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g) * u
    return h @ w_down
