"""Plain float32 forward of DeepSeek-V2 (hf ``DeepseekV2ForCausalLM``,
``modeling_deepseek.py``, as ``deepseek-ai/DeepSeek-V2-Lite``'s
config.json describes it), for the MLA decode cell's comparison.

A copy of the repository's test reference ``tests/ref_deepseek_v2.py``
(same equations, same departures), rearranged to fit beside the program
on the card: it runs layer by layer over every sequence at once, each
layer's weights cast to float32 only while that layer runs, like
``reference/qwen3.py``. It takes the weights the benchmark made
(``weight(name)``), never the program's, and imports nothing of the
program.

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
Then the final RMSNorm and the untied head. No cache, no batching across
sequences, no kernel: plain torch operations in float32 with TF32 off.

Departures from hf's code, none of which changes the function:
  * weights are ``(in, out)`` (``x @ w``), under the program's names:
    ``embed``, ``final_norm``, ``lm_head``; layer 0 ``layer0.*``, layer
    l > 0 ``layers.<l-1>.*``; ``attn.{wq, wkv_a, kv_norm, wkv_b, wo}``,
    ``mlp.{w_gate, w_up, w_down}``, ``moe.{router, w_gate, w_up, w_down,
    shared_gate, shared_up, shared_down}`` with the routed experts
    stacked (E, D, F) / (E, F, D);
  * RMSNorm multiplies by the weight in float32 (hf casts to the input
    dtype first: the same in float32);
  * the experts run over the tokens routed to them (hf's ``moe_infer``
    does the same by sorting); no auxiliary loss (inference);
  * cos and sin are computed at the positions themselves, not read from
    a cache of ``max_position_embeddings`` rows.

The control computes the same forward with every linear layer's input
and weight (the router's and each expert's too) rounded to float8 e4m3
(one scale per tensor, its absolute maximum over 448), the precision
below the bfloat16 that the configuration states.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .qwen3 import ROWS, _fp8, strict_fp32


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(cfg: dict, device=None) -> torch.Tensor:
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


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs is not None and rs.get("mscale_all_dim"):
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
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


def layer_prefix(l: int) -> str:
    return "layer0." if l == 0 else f"layers.{l - 1}."


class Forward:
    """``weight(name)`` returns a weight as the benchmark made it (any
    dtype, on the device the reference runs on), by the names above."""

    def __init__(self, cfg: dict, weight: Callable[[str], torch.Tensor],
                 control: bool = False) -> None:
        self.cfg = cfg
        self.weight = weight
        self.control = control
        self._head = None

    def _w(self, name: str) -> torch.Tensor:
        return self.weight(name).to(torch.float32)

    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.control:
            return _fp8(x) @ _fp8(w)
        return x @ w

    def _swiglu(self, x, wg, wu, wd):
        return self._lin(F.silu(self._lin(x, wg)) * self._lin(x, wu), wd)

    def _attention(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        c = self.cfg
        T = x.shape[0]
        H, R = c["num_attention_heads"], c["kv_lora_rank"]
        nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        q = self._lin(x, w["attn.wq"]).view(T, H, nope + rope)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        ckv = self._lin(x, w["attn.wkv_a"])
        lat, k_pe = _rms(ckv[:, :R], w["attn.kv_norm"], c["rms_norm_eps"]), ckv[:, R:]
        kv = self._lin(lat, w["attn.wkv_b"]).view(T, H, nope + dv)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        q_pe, k_pe = _rope(q_pe, c), _rope(k_pe[:, None, :], c)
        qh = torch.cat([q_nope, q_pe], -1)
        kh = torch.cat([k_nope, k_pe.expand(T, H, rope)], -1)
        s = torch.einsum("thd,shd->hts", qh, kh) * softmax_scale(c)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
        a = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        o = torch.einsum("hts,shd->thd", a, v).reshape(T, H * dv)
        return self._lin(o, w["attn.wo"])

    def _moe(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        c = self.cfg
        probs = torch.softmax(self._lin(x, w["moe.router"]), dim=-1)
        gates, idx = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
        if c["norm_topk_prob"]:
            gates = gates / gates.sum(-1, keepdim=True)
        else:
            gates = gates * c["routed_scaling_factor"]
        out = torch.zeros_like(x)
        for e in range(c["n_routed_experts"]):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if len(tok):
                y = self._swiglu(x[tok], w["moe.w_gate"][e], w["moe.w_up"][e],
                                 w["moe.w_down"][e])
                out.index_add_(0, tok, y * gates[tok, slot][:, None])
        if c["n_shared_experts"]:
            out = out + self._swiglu(x, w["moe.shared_gate"], w["moe.shared_up"],
                                     w["moe.shared_down"])
        return out

    @torch.no_grad()
    def hidden(self, seqs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The final normed hidden states (T, D) of each token sequence."""
        c = self.cfg
        eps = c["rms_norm_eps"]
        emb = self.weight("embed")
        xs = [emb[s].to(torch.float32) for s in seqs]
        for l in range(c["num_hidden_layers"]):
            p = layer_prefix(l)
            dense = l < c["first_k_dense_replace"]
            names = ["ln1", "ln2", "attn.wq", "attn.wkv_a", "attn.kv_norm",
                     "attn.wkv_b", "attn.wo"]
            names += (["mlp.w_gate", "mlp.w_up", "mlp.w_down"] if dense else
                      ["moe.router", "moe.w_gate", "moe.w_up", "moe.w_down"]
                      + (["moe.shared_gate", "moe.shared_up", "moe.shared_down"]
                         if c["n_shared_experts"] else []))
            w = {k: self._w(p + k) for k in names}
            for i, x in enumerate(xs):
                x = x + self._attention(_rms(x, w["ln1"], eps), w)
                h = _rms(x, w["ln2"], eps)
                if dense:
                    x = x + self._swiglu(h, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"])
                else:
                    x = x + self._moe(h, w)
                xs[i] = x
            del w
        fn = self._w("final_norm")
        return [_rms(x, fn, eps) for x in xs]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of hidden rows ``h`` against the untied head."""
        if self._head is None:
            head = self._w("lm_head")
            self._head = _fp8(head) if self.control else head
        x = _fp8(h) if self.control else h
        return x @ self._head


@torch.no_grad()
def served_gaps(cfg: dict, weight, seqs: Sequence[torch.Tensor],
                starts: Sequence[int], control: bool = False) -> List[np.ndarray]:
    """For each token sequence, at every position ``p`` from ``starts[i] - 1``
    on whose next token was served (greedy), the gap by which that
    token's float32 logit lies below the float32 reference's best.

    With ``control``, the token is instead the one the float8 control
    puts first at ``p``, read against the same float32 logits."""
    strict_fp32()
    ref = Forward(cfg, weight)
    hs = ref.hidden(seqs)
    low = Forward(cfg, weight, control=True) if control else None
    hc = low.hidden(seqs) if control else None
    out = []
    for i, (s, h) in enumerate(zip(seqs, hs)):
        gaps = []
        for lo in range(starts[i] - 1, len(s) - 1, ROWS):
            hi = min(lo + ROWS, len(s) - 1)
            lg = ref.logits(h[lo:hi])
            if control:
                tok = low.logits(hc[i][lo:hi]).argmax(-1)
            else:
                tok = s[lo + 1:hi + 1]
            chosen = lg.gather(1, tok[:, None].long())[:, 0]
            gaps.append((lg.max(-1).values - chosen).cpu().numpy())
        out.append(np.concatenate(gaps) if gaps else np.zeros(0))
    return out
