"""Mamba-1 selective SSM block (falcon-mamba, jamba's mamba layers).

Follows ``repro/models/ssm.py`` operation for operation (the same dtypes
at the same places). The recurrence h_t = a_t * h_{t-1} + b_t runs as a
chunked scan: a loop over chunks of ``chunk`` positions carrying the
(B, d_inner, d_state) boundary state, and inside a chunk a log-depth
doubling scan over the time axis in place of the reference's
``lax.associative_scan`` (torch has none). The doubling scan combines
the same pairs in another order than the reference's tree, so the two
agree to rounding, not bit for bit.

``mamba_scan_fused`` builds each chunk's (B, chunk, DI, DS) transition
and state tensors inside the loop and, under autograd, wraps each
chunk's step in ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so the (B, S, DI, DS) expansion never exists,
forward or backward. ``selective_scan_chunked`` is the oracle form over
given (a, b).

Decode is the exact single-step recurrence over the carried (conv, ssm)
state.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _scan_in_chunk(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 under (a1, b1) then (a2, b2) ->
    (a1 * a2, a2 * b1 + b2): returns the transitions' running products
    and the states from a zero start. Doubling: at distance d = 1, 2, 4,
    ... each position takes in the partial ending d before it, out of
    place so that autograd keeps every level."""
    c, d = a.shape[1], 1
    while d < c:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def selective_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                           chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t, returning all h_t and the final state.

    a, b: (B, S, d_inner, d_state) f32; h0: (B, d_inner, d_state). The
    padded tail has a = 1 (the identity transition) and b = 0.
    """
    S = a.shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
    h, hs = h0, []
    for i in range(0, S + pad, c):
        pa, pb = _scan_in_chunk(a[:, i:i + c], b[:, i:i + c])
        h_all = pa * h[:, None] + pb              # states at every position
        h = h_all[:, -1]
        hs.append(h_all)
    return torch.cat(hs, dim=1)[:, :S], h


def _fused_step(h: torch.Tensor, xc: torch.Tensor, dt: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, A: torch.Tensor,
                D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (B, c, DI|DS) inputs and the incoming state h -> (the
    outgoing state, y (B, c, DI))."""
    a = torch.exp(dt[..., None] * A[None, None])              # (B,c,DI,DS)
    bx = (dt * xc)[..., None] * Bc[:, :, None, :]
    pa, pb = _scan_in_chunk(a, bx)
    h_all = pa * h[:, None] + pb
    y = torch.sum(h_all * Cc[:, :, None, :], dim=-1)
    return h_all[:, -1], y + xc * D[None, None, :]


def mamba_scan_fused(xc: torch.Tensor, dt: torch.Tensor, Bssm: torch.Tensor,
                     Cssm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Fused chunked selective scan: y from per-chunk state expansion.

    xc/dt: (B, S, DI) f32; Bssm/Cssm: (B, S, DS) f32; A: (DI, DS); D:
    (DI,). Returns y: (B, S, DI) f32. The padded tail is zeros, so each
    padded step is the identity (a = exp(0) = 1, b = 0).
    """
    B, S, DI = xc.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        xc, dt, Bssm, Cssm = (F.pad(v, (0, 0, 0, pad))
                              for v in (xc, dt, Bssm, Cssm))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc, dt, Bssm, Cssm, A, D))
    h = torch.zeros((B, DI, A.shape[-1]), dtype=torch.float32, device=xc.device)
    ys = []
    for i in range(0, S + pad, c):
        args = (h, xc[:, i:i + c], dt[:, i:i + c], Bssm[:, i:i + c],
                Cssm[:, i:i + c], A, D)
        if remat:
            h, y = checkpoint(_fused_step, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _fused_step(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp_min(x, 0)


def mamba_block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                cfg) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, D) -> (B, S, D)."""
    mc = cfg.mamba
    S = x.shape[1]
    DS, dtr = mc.d_state, cfg.dt_rank_

    xp, z = (x @ p["in_proj"]).chunk(2, dim=-1)          # (B, S, DI) each

    # depthwise causal conv over time (kernel d_conv)
    w = p["conv_w"]                                      # (d_conv, DI)
    xp_pad = F.pad(xp, (0, 0, mc.d_conv - 1, 0))
    xc = sum(xp_pad[:, i:i + S, :] * w[i][None, None, :]
             for i in range(mc.d_conv)) + p["conv_b"]
    xc = F.silu(xc)

    # input-dependent SSM parameters
    proj = xc @ p["x_proj"]                              # (B, S, dtr+2*DS)
    dt_low, Bssm, Cssm = torch.split(proj, [dtr, DS, DS], dim=-1)
    dt = _softplus(dt_low @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())                   # (DI, DS)

    y = mamba_scan_fused(xc.float(), dt, Bssm.float(), Cssm.float(), A,
                         p["D"].float(), mc.chunk)
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"]


def mamba_decode_step(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, D); conv_state: (B, d_conv-1, DI) f32;
    ssm_state: (B, DI, DS) f32. Returns (out (B, D), conv_state',
    ssm_state').

    As the reference, the conv window is f32 (the carried state
    promotes the new input), so everything from the conv to the output
    gate runs in f32; the output is cast back to x's dtype before
    ``out_proj``.
    """
    DS, dtr = cfg.mamba.d_state, cfg.dt_rank_
    f32 = torch.float32

    xp, z = (x @ p["in_proj"]).chunk(2, dim=-1)          # (B, DI) each

    # conv over the carried window
    window = torch.cat([conv_state, xp[:, None, :].to(conv_state.dtype)], dim=1)
    xc = torch.einsum("bci,ci->bi", window, p["conv_w"].to(window.dtype))
    xc = F.silu(xc + p["conv_b"])
    new_conv_state = window[:, 1:, :]

    proj = xc @ p["x_proj"].to(xc.dtype)
    dt_low, Bssm, Cssm = torch.split(proj, [dtr, DS, DS], dim=-1)
    dt = _softplus(dt_low @ p["dt_proj"].to(dt_low.dtype)
                   + p["dt_bias"]).to(f32)
    A = -torch.exp(p["A_log"].to(f32))
    a = torch.exp(dt[..., None] * A[None])               # (B, DI, DS)
    bx = (dt * xc.to(f32))[..., None] * Bssm.to(f32)[:, None, :]
    h = a * ssm_state + bx
    y = torch.sum(h * Cssm.to(f32)[:, None, :], dim=-1)
    y = y + xc.to(f32) * p["D"].to(f32)[None, :]
    y = (y * F.silu(z.to(f32))).to(x.dtype)
    return y @ p["out_proj"], new_conv_state, h
