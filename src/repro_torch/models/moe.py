"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Fine-grained MoE in the DeepSeekMoE style: ``n_shared`` always-on experts
plus ``n_routed`` routed experts with top-k gating. Dispatch is the
sort-based (dropping-above-capacity) formulation:

  1. top-k expert ids per token -> (T*k) assignments;
  2. stable-sort assignments by expert id;
  3. position-within-expert via searchsorted run starts;
  4. scatter token ids into an (E, C) slot table (overflow drops);
  5. grouped GEMM over the (E, C, D) gathered activations;
  6. combine: gather each assignment's output and weighted-sum over k.

A copy of ``repro/models/moe.py``, operation for operation. Two places
where torch's defaults differ from JAX's are pinned down:

* top-k: ``jax.lax.top_k`` puts the lower expert id first among equal
  probabilities; ``torch.topk`` gives no order for ties. The port takes
  the first k of a stable descending sort, which keeps equal values in
  index order -- ``lax.top_k``'s order;
* the assignment sort is ``argsort(stable=True)``, as the reference's,
  so the drop order (who keeps a slot when an expert overflows) is the
  reference's: earlier tokens first, each token's choices in rank order.

One option the reference lacks: a :class:`~.config.PortMoEConfig` with
``norm_topk_prob`` False keeps the top-k probabilities as the gates
(DeepSeek-V2), where the reference always renormalises them.

Parameters come as a mapping (``router``, ``w_gate``/``w_up`` (E, D, F),
``w_down`` (E, F, D), optional ``shared_{gate,up,down}``), already in
the compute dtype.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig, MoEConfig

Params = Mapping[str, torch.Tensor]


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
                norm_topk_prob: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (gates (T,k), expert_idx (T,k), aux_loss scalar).
    The gates are the top-k softmax probabilities, renormalised to sum
    to 1 unless ``norm_topk_prob`` is False (the reference always
    renormalises)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt.values[:, :top_k], srt.indices[:, :top_k]
    if norm_topk_prob:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    E = w_router.shape[-1]
    me = probs.mean(dim=0)                             # mean router prob
    # routes per expert as an index_add of ones: bit-equal to
    # ``bincount(...).float()`` below 2**24 routes, and shape-only on the
    # meta device, where bincount has no kernel
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=idx.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=idx.device))
    ce = counts / idx.numel()
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


def capacity(T: int, m: MoEConfig) -> int:
    """Slots per expert: a dropless floor for small token counts (decode
    steps are exact; large training/prefill batches use capacity-factor
    drops)."""
    return min(max(int(T * m.top_k / m.n_routed * m.capacity_factor), 64), T)


def _dispatch_tokens(xt: torch.Tensor, p: Params, cfg: ArchConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch + grouped GEMM over a flat token set.

    xt: (T, D) -> (out (T, D) in xt's dtype, aux scalar).
    """
    m: MoEConfig = cfg.moe
    T, D = xt.shape
    E, k = m.n_routed, m.top_k
    C = capacity(T, m)
    dev = xt.device

    # a reference MoEConfig (the parity tests hand one in) has no such field
    norm = getattr(m, "norm_topk_prob", True)
    gates, idx, aux = router_topk(xt, p["router"], k, norm)

    # ---- sort assignments by expert ------------------------------------
    flat_e = idx.reshape(-1)                          # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # position within each expert's run
    starts = torch.searchsorted(se, torch.arange(E, device=dev), side="left")
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = pos < C

    # ---- scatter into the (E, C) slot table ----------------------------
    slot = torch.where(keep, se * C + pos, E * C)     # drops -> scratch slot
    token_for_slot = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    token_for_slot[slot] = st
    token_for_slot = token_for_slot[: E * C]
    # gather activations; token id T -> zero row
    xt_pad = torch.cat([xt, xt.new_zeros(1, D)], dim=0)
    xe = xt_pad[token_for_slot].reshape(E, C, D)

    # ---- grouped expert GEMMs ------------------------------------------
    h = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = F.silu(h) * u
    ye = torch.bmm(h, p["w_down"])                    # (E, C, D)

    # ---- combine back to tokens ----------------------------------------
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)], dim=0)
    # for each sorted assignment: its slot output (dropped -> zero row);
    # combined in the compute dtype, as the reference
    contrib = ye_flat[slot]
    out = xt.new_zeros(T, D).index_add(
        0, st, (contrib.float() * sg[:, None]).to(xt.dtype))
    return out, aux


def moe_ffn(x: torch.Tensor, p: Params, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss).

    Two dispatch modes, as the reference: global (one sort over all B*S
    tokens) and grouped (the same dispatch per sample, ``B`` groups of
    ``S`` tokens, the auxiliary losses averaged) when
    ``grouped_dispatch`` is set, ``B > 1`` and ``S >= min_group_tokens``.
    """
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    grouped = m.grouped_dispatch and B > 1 and S >= m.min_group_tokens

    if grouped:
        outs, auxs = zip(*(_dispatch_tokens(xg, p, cfg) for xg in x))
        out = torch.stack(outs).reshape(B * S, D)
        aux = torch.stack(auxs).mean()
    else:
        out, aux = _dispatch_tokens(x.reshape(B * S, D), p, cfg)

    # ---- shared experts (dense, always on) ------------------------------
    xt = x.reshape(B * S, D)
    if m.n_shared:
        g = xt @ p["shared_gate"]
        u2 = xt @ p["shared_up"]
        out = out + ((F.silu(g) * u2) @ p["shared_down"]).to(out.dtype)

    return out.reshape(B, S, D).to(x.dtype), aux * m.router_aux_weight
