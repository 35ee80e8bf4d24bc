"""Plain float32 forward of a Qwen3 dense decoder (hf ``Qwen3ForCausalLM``,
as ``Qwen/Qwen3-4B``'s config.json describes it), for the decode cells'
comparison.

Per layer: RMSNorm, q/k/v projections, RMSNorm of each head of q and k
over ``head_dim`` (qk-norm), rotary embedding (rotate-half, base
``rope_theta``), causal grouped-query attention scaled by
``1/sqrt(head_dim)``, the output projection and the residual; RMSNorm,
the SwiGLU FFN (``silu(x Wg) * (x Wu)) Wd``) and the residual. Then the
final RMSNorm and the logits against the (tied) embedding. Weights are
``(in, out)``: ``x @ w``. No cache, no batching across sequences, no
kernel: plain torch operations in float32 with TF32 off.

It runs layer by layer over every sequence at once, each layer's weights
cast to float32 only while that layer runs, so that the reference fits
beside what is left on the card. It takes the weights the benchmark
made (``weight(name)``), never the program's. It imports nothing of the
program.

The control computes the same forward with every linear layer's input
and weight rounded to float8 e4m3 (one scale per tensor, its absolute
maximum over 448), the precision below the bfloat16 that the
configuration states.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, hd) at positions 0..T-1."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    rot = torch.cat([-x[..., hd // 2:], x[..., : hd // 2]], -1)
    return x * cos + rot * sin


class Forward:
    """``weight(name)`` returns a weight as the benchmark made it (any
    dtype, on the device the reference runs on); names as
    ``embed``, ``final_norm``, ``layers.<l>.ln1``, ``layers.<l>.ln2``,
    ``layers.<l>.attn.{wq,wk,wv,wo,q_norm,k_norm}``,
    ``layers.<l>.mlp.{w_gate,w_up,w_down}``."""

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

    @torch.no_grad()
    def hidden(self, seqs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The final normed hidden states (T, D) of each token sequence."""
        c = self.cfg
        eps, hd = c["rms_norm_eps"], c["head_dim"]
        H, KV = c["num_attention_heads"], c["num_key_value_heads"]
        emb = self.weight("embed")
        xs = [emb[s].to(torch.float32) for s in seqs]
        for l in range(c["num_hidden_layers"]):
            p = f"layers.{l}."
            w = {k: self._w(p + k) for k in (
                "ln1", "ln2", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                "attn.q_norm", "attn.k_norm", "mlp.w_gate", "mlp.w_up",
                "mlp.w_down")}
            for i, x in enumerate(xs):
                T = x.shape[0]
                h = _rms(x, w["ln1"], eps)
                q = self._lin(h, w["attn.wq"]).view(T, H, hd)
                k = self._lin(h, w["attn.wk"]).view(T, KV, hd)
                v = self._lin(h, w["attn.wv"]).view(T, KV, hd)
                q = _rope(_rms(q, w["attn.q_norm"], eps), c["rope_theta"])
                k = _rope(_rms(k, w["attn.k_norm"], eps), c["rope_theta"])
                k = k.repeat_interleave(H // KV, dim=1)
                v = v.repeat_interleave(H // KV, dim=1)
                s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
                mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
                a = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
                o = torch.einsum("hts,shd->thd", a, v).reshape(T, H * hd)
                x = x + self._lin(o, w["attn.wo"])
                h = _rms(x, w["ln2"], eps)
                g = torch.nn.functional.silu(self._lin(h, w["mlp.w_gate"]))
                x = x + self._lin(g * self._lin(h, w["mlp.w_up"]), w["mlp.w_down"])
                xs[i] = x
            del w
        fn = self._w("final_norm")
        return [_rms(x, fn, eps) for x in xs]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of hidden rows ``h`` against the tied embedding."""
        if self._head is None:
            head = self._w("embed").T
            self._head = _fp8(head) if self.control else head
        x = _fp8(h) if self.control else h
        return x @ self._head


ROWS = 256          # logit rows at a time


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
