"""Plain float32 forward of DeepSeek-V2 (hf ``DeepseekV2ForCausalLM``,
``modeling_deepseek.py``, as ``deepseek-ai/DeepSeek-V2-Lite``'s
config.json describes it), for the port's tests.

Per layer: RMSNorm; latent attention (``DeepseekV2Attention`` without a
query LoRA): ``q = x wq`` split per head into ``q_nope`` and ``q_pe``,
``[c, k_pe] = x wkv_a``, ``c`` RMS-normed by ``kv_norm``, ``[k_nope, v] =
c wkv_b`` per head, the YaRN rope on ``q_pe`` and on the one ``k_pe``
every head shares (each de-interleaved first: pairs (2i, 2i+1) to halves
i and d/2 + i, then rotate-half), causal softmax attention of ``[q_nope,
q_pe]`` against ``[k_nope, k_pe]`` at ``qk_head_dim^-0.5 *
mscale(factor, mscale_all_dim)^2``, ``wo``; the residual; RMSNorm; the
first ``first_k_dense_replace`` layers a SwiGLU MLP, the rest MoE
(``DeepseekV2MoE``): softmax router, the top ``num_experts_per_tok``
experts (``greedy``), gates renormalised only with ``norm_topk_prob``,
else times ``routed_scaling_factor``, plus the shared experts as one
SwiGLU of ``n_shared_experts * moe_intermediate_size``; the residual.
Then the final RMSNorm and the untied head.

No cache, no batching, no kernel: plain torch operations in float32 on
one token sequence, the attention over the whole causal square. It
imports nothing of the program.

Departures from hf's code, none of which changes the function:
  * weights are ``(in, out)`` (``x @ w``), under the program's names:
    ``embed``, ``final_norm``, ``lm_head``; layer 0 ``layer0.*``, layer
    l > 0 ``layers.<l-1>.*`` (the program keeps its dense first layer
    apart); ``attn.{wq, wkv_a, kv_norm, wkv_b, wo}``,
    ``mlp.{w_gate, w_up, w_down}``, ``moe.{router, w_gate, w_up,
    w_down, shared_gate, shared_up, shared_down}`` with the routed
    experts stacked (E, D, F) / (E, F, D);
  * RMSNorm multiplies by the weight in float32 (hf casts to the input
    dtype first: the same in float32);
  * the experts run over the tokens routed to them (hf's ``moe_infer``
    does the same by sorting); no auxiliary loss (inference);
  * cos and sin are computed at the positions themselves, not read from
    a cache of ``max_position_embeddings`` rows.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(cfg: Mapping, device=None) -> torch.Tensor:
    """hf ``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / (base ** (ar / dim))
    if rs is None:
        return extra
    inter = 1.0 / (rs["factor"] * base ** (ar / dim))

    def corr_dim(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cfg: Mapping) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs is not None and rs.get("mscale_all_dim"):
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _rope(x: torch.Tensor, cfg: Mapping) -> torch.Tensor:
    """x: (T, heads, d), interleaved pairs, at positions 0..T-1."""
    T, _, d = x.shape
    rs = cfg["rope_scaling"]
    k = 1.0 if rs is None else (_mscale(rs["factor"], rs["mscale"])
                                / _mscale(rs["factor"], rs["mscale_all_dim"]))
    ang = (torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
           * yarn_inv_freq(cfg, x.device))
    emb = torch.cat([ang, ang], -1)
    cos, sin = (emb.cos() * k)[:, None, :], (emb.sin() * k)[:, None, :]
    x = x.view(T, -1, d // 2, 2).transpose(-1, -2).reshape(T, -1, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def attention(x: torch.Tensor, w, cfg: Mapping) -> torch.Tensor:
    """Latent attention, published form: x (T, D) -> (T, D)."""
    T = x.shape[0]
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = (x @ w("attn.wq")).view(T, H, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = x @ w("attn.wkv_a")
    c, k_pe = _rms(ckv[:, :R], w("attn.kv_norm"), cfg["rms_norm_eps"]), ckv[:, R:]
    kv = (c @ w("attn.wkv_b")).view(T, H, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe, k_pe = _rope(q_pe, cfg), _rope(k_pe[:, None, :], cfg)
    qh = torch.cat([q_nope, q_pe], -1)
    kh = torch.cat([k_nope, k_pe.expand(T, H, rope)], -1)
    s = torch.einsum("thd,shd->hts", qh, kh) * softmax_scale(cfg)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    a = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = torch.einsum("hts,shd->thd", a, v).reshape(T, H * dv)
    return o @ w("attn.wo")


def moe(x: torch.Tensor, w, cfg: Mapping) -> torch.Tensor:
    """DeepseekV2MoE: x (T, D) -> (T, D)."""
    probs = torch.softmax(x @ w("moe.router"), dim=-1)
    gates, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    else:
        gates = gates * cfg["routed_scaling_factor"]
    wg, wu, wd = w("moe.w_gate"), w("moe.w_up"), w("moe.w_down")
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y = _swiglu(x[tok], wg[e], wu[e], wd[e])
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    if cfg["n_shared_experts"]:
        out = out + _swiglu(x, w("moe.shared_gate"), w("moe.shared_up"),
                            w("moe.shared_down"))
    return out


def layer_prefix(l: int) -> str:
    return "layer0." if l == 0 else f"layers.{l - 1}."


@torch.no_grad()
def forward(weights: Mapping[str, torch.Tensor], cfg: Mapping,
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits (T, V) of one token sequence (T,), float32."""
    eps = cfg["rms_norm_eps"]
    x = weights["embed"][tokens].float()
    for l in range(cfg["num_hidden_layers"]):
        p = layer_prefix(l)

        def w(name, p=p):
            return weights[p + name].float()
        x = x + attention(_rms(x, w("ln1"), eps), w, cfg)
        h = _rms(x, w("ln2"), eps)
        if l < cfg["first_k_dense_replace"]:
            x = x + _swiglu(h, w("mlp.w_gate"), w("mlp.w_up"), w("mlp.w_down"))
        else:
            x = x + moe(h, w, cfg)
    x = _rms(x, weights["final_norm"].float(), eps)
    return x @ weights["lm_head"].float()
