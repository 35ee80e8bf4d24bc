"""Core transformer layers: RMSNorm, RoPE / M-RoPE / YaRN, GQA attention with
chunked (flash-semantics) computation and its backward, single-token
decode attention, SwiGLU MLP.

Each function follows ``repro/models/layers.py`` operation for operation
(the same dtypes at the same places). ``decode_attention`` is the plain
counterpart of the paged kernel's math over an already-gathered KV view;
the tests hold it against the JAX function, and ``model.decode_step``
reads KV through ``kernels.ops.paged_decode_attention`` instead.

Attention never materializes the full S x S score matrix: the forward
walks (query chunk, KV chunk) tiles carrying running (max, denominator,
accumulator) -- the online softmax -- and saves only the logsumexp; the
backward recomputes each tile's probabilities from it (the
FlashAttention-2 recipe, the reference's ``custom_vjp``), as a
``torch.autograd.Function``. It is plain torch, operation for operation
the reference's jnp.

The reference's ``shard_ctx`` hints are no-ops without a mesh and are
left out.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import math

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


def yarn_inv_freq(dim: int, theta: float, y, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (hf ``DeepseekV2YarnRotaryEmbedding``),
    (dim//2,) f32: ``1/theta^(2i/dim)`` below the correction range, the
    same over ``factor`` above it, and a linear ramp between. The range
    is where a pair turns ``beta_fast`` .. ``beta_slow`` times over the
    original context: ``dim ln(L / (2 pi b)) / (2 ln theta)``, floored /
    ceiled and clipped to [0, dim - 1]."""
    def corr(rot: float) -> float:
        return (dim * math.log(y.original_max_position_embeddings
                               / (rot * 2 * math.pi))) / (2 * math.log(theta))
    lo = max(math.floor(corr(y.beta_fast)), 0)
    hi = min(math.ceil(corr(y.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / (theta ** (ar / dim))
    inter = 1.0 / (y.factor * theta ** (ar / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device)
                        - lo) / (hi - lo), 0, 1)
    keep = 1.0 - ramp                   # 1: the unscaled frequency
    return inter * (1 - keep) + extra * keep


def rope_cos_sin(cfg, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (..., S, rope_dim//2) at ``positions`` (..., S) for a
    config's rotary width: YaRN's frequencies and cos/sin scale where
    the config has ``rope_scaling``, else :func:`rope_angles`."""
    y = cfg.rope_scaling
    if y is None:
        return rope_angles(positions, cfg.rope_dim, cfg.rope_theta)
    inv = yarn_inv_freq(cfg.rope_dim, cfg.rope_theta, y, positions.device)
    ang = positions.float()[..., None] * inv
    k = y.cos_sin_scale
    return torch.cos(ang) * k, torch.sin(ang) * k


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope convention: the pairs (2i, 2i+1) of the last axis
    go to halves i and d/2 + i, then :func:`apply_rope` turns them
    rotate-half style (hf ``modeling_deepseek.apply_rotary_pos_emb``)."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


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


# ----------------------------------------------------- chunked attention
class _FlashCfg(NamedTuple):
    causal: bool
    cq: int
    ckv: int
    q_offset: int
    nkv: int
    skv: int                     # valid kv length (for padding mask)


def _tile_bias(cfg: _FlashCfg, qi: int, kj: int,
               device) -> torch.Tensor:
    """2-D (cq, ckv) additive bias for tile (qi, kj): padding + causality."""
    kpos = kj * cfg.ckv + torch.arange(cfg.ckv, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    bias = torch.where(kpos < cfg.skv, zero, neg)[None, :]
    if cfg.causal:
        qpos = cfg.q_offset + qi * cfg.cq + torch.arange(cfg.cq, device=device)
        bias = bias + torch.where(qpos[:, None] >= kpos[None, :], zero, neg)
    return bias


def _flash_fwd_pass(cfg: _FlashCfg, qs: torch.Tensor, ks: torch.Tensor,
                    vs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """qs: (nq, B, cq, H, hd) pre-scaled; ks/vs: (nkv, B, ckv, H, hd).

    Returns out (nq, B, cq, H, hd) and lse (nq, B, H, cq).
    """
    nq, B, cq, H, hd = qs.shape
    f32 = dict(dtype=torch.float32, device=qs.device)
    outs, lses = [], []
    for qi in range(nq):
        qc = qs[qi]
        m = torch.full((B, H, cq), NEG_INF, **f32)
        l = torch.zeros((B, H, cq), **f32)
        o = torch.zeros((B, cq, H, hd), **f32)
        for kj in range(cfg.nkv):
            kc, vc = ks[kj], vs[kj]
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float()
            s = s + _tile_bias(cfg, qi, kj, qs.device)[None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            a = torch.exp(m - m_new)
            l = l * a + p.sum(dim=-1)
            oc = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype), vc)
            o = o * a.transpose(1, 2)[..., None] + oc.float()
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((o / l.transpose(1, 2)[..., None]).to(vs.dtype))
        lses.append(m + torch.log(l))
    return torch.stack(outs), torch.stack(lses)


def _flash_bwd(cfg: _FlashCfg, qs, ks, vs, out, lse, do):
    nq, B, cq, H, hd = qs.shape
    # delta_i = sum_d do_id * o_id  -> (nq, B, H, cq)
    delta = torch.einsum("nbqhd,nbqhd->nbhq", do.float(), out.float())

    def p_tile(qi, kj):
        s = torch.einsum("bqhd,bkhd->bhqk", qs[qi], ks[kj]).float()
        s = s + _tile_bias(cfg, qi, kj, qs.device)[None, None]
        return torch.exp(s - lse[qi][..., None])          # (B,H,cq,ckv)

    def ds_tile(qi, kj, p):
        dp = torch.einsum("bqhd,bkhd->bhqk", do[qi].float(), vs[kj].float())
        return p * (dp - delta[qi][..., None])

    # ---- dq: outer loop over q chunks, inner over kv chunks
    dqs = []
    for qi in range(nq):
        dq = torch.zeros((B, cq, H, hd), dtype=torch.float32, device=qs.device)
        for kj in range(cfg.nkv):
            ds = ds_tile(qi, kj, p_tile(qi, kj))
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, ks[kj].float())
        dqs.append(dq)

    # ---- dk/dv: outer loop over kv chunks, inner over q chunks
    ckv = ks.shape[2]
    dks, dvs = [], []
    for kj in range(cfg.nkv):
        dk = torch.zeros((B, ckv, H, hd), dtype=torch.float32, device=qs.device)
        dv = torch.zeros_like(dk)
        for qi in range(nq):
            p = p_tile(qi, kj)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do[qi].float())
            ds = ds_tile(qi, kj, p)
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qs[qi].float())
        dks.append(dk)
        dvs.append(dv)
    return (torch.stack(dqs).to(qs.dtype), torch.stack(dks).to(ks.dtype),
            torch.stack(dvs).to(vs.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward saves (q, k, v,
    out, lse); the backward recomputes the probabilities per tile."""

    @staticmethod
    def forward(ctx, cfg: _FlashCfg, qs, ks, vs):
        out, lse = _flash_fwd_pass(cfg, qs, ks, vs)
        ctx.cfg = cfg
        ctx.save_for_backward(qs, ks, vs, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(ctx.cfg, qs, ks, vs, out, lse, do)
        return None, dq, dk, dv


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, chunk_q: int, chunk_kv: int,
                      scale: Optional[float] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention with the flash backward.

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) with Hq % Hkv == 0 (GQA:
    K/V are repeated to Hq -- the repeat's own backward sums the grads
    over the head groups). Returns (B, Sq, Hq, hd).
    ``q_offset``: absolute position of q[0] (decode: Skv - 1).
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hkv != Hq:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else hd ** -0.5
    q = (q.float() * scale).to(q.dtype)

    cq = min(chunk_q, Sq)
    ckv = min(chunk_kv, Skv)
    pad_q = (-Sq) % cq
    pad_kv = (-Skv) % ckv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq = (Sq + pad_q) // cq
    nkv = (Skv + pad_kv) // ckv

    qs = q.reshape(B, nq, cq, Hq, hd).transpose(0, 1)
    ks = k.reshape(B, nkv, ckv, Hq, hd).transpose(0, 1)
    vs = v.reshape(B, nkv, ckv, Hq, hd).transpose(0, 1)

    cfg = _FlashCfg(causal=causal, cq=cq, ckv=ckv, q_offset=q_offset,
                    nkv=nkv, skv=Skv)
    outs = _Flash.apply(cfg, qs, ks, vs)
    out = outs.transpose(0, 1).reshape(B, nq * cq, Hq, hd)
    return out[:, :Sq]


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


# ------------------------------------------------------------ attention op
def attention_block(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg,
                    cos: torch.Tensor, sin: torch.Tensor,
                    *, causal: bool) -> torch.Tensor:
    """Full attention sub-layer (projections + rope + chunked attn)."""
    B, S, D = x.shape
    hd = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = chunked_attention(q, k, v, causal=causal,
                          chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return o.reshape(B, S, cfg.n_heads * hd) @ p["wo"]


def mla_attention_block(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg,
                        cos: torch.Tensor, sin: torch.Tensor,
                        *, causal: bool) -> torch.Tensor:
    """Latent attention (MLA) sub-layer in its published form, hf
    ``DeepseekV2Attention`` with no query LoRA: ``q = x wq`` split into
    ``q_nope``, ``q_pe``; ``[c, k_pe] = x wkv_a``, ``c`` RMS-normed by
    ``kv_norm``; ``[k_nope, v] = c wkv_b`` per head; the rope (cos/sin
    of :func:`rope_cos_sin`) on ``q_pe`` and on the one ``k_pe`` every
    head shares, each de-interleaved first; causal attention of ``[q_nope,
    q_pe]`` against ``[k_nope, k_pe]`` at ``cfg.softmax_scale()``, then
    ``wo``. The chunked path takes one width for q, k and v, so the
    narrower of them is padded with zeros (which changes no score and
    no output column that is kept)."""
    B, S, _ = x.shape
    a, H = cfg.mla, cfg.n_heads
    nope, rope, dv, R = (a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim,
                         a.kv_lora_rank)
    q_nope, q_pe = (x @ p["wq"]).reshape(B, S, H, nope + rope).split([nope, rope], -1)
    c, k_pe = (x @ p["wkv_a"]).split([R, rope], -1)
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_nope, v = (c @ p["wkv_b"]).reshape(B, S, H, nope + dv).split([nope, dv], -1)
    q_pe = apply_rope(deinterleave(q_pe), cos, sin)
    k_pe = apply_rope(deinterleave(k_pe)[:, :, None, :], cos, sin)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], -1)
    width = max(nope + rope, dv)

    def pad(t: torch.Tensor) -> torch.Tensor:
        return F.pad(t, (0, width - t.shape[-1]))

    o = chunked_attention(pad(q), pad(k), pad(v), causal=causal,
                          chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                          scale=cfg.softmax_scale())
    return o[..., :dv].reshape(B, S, H * dv) @ p["wo"]
