"""Model assembly: parameters, the full-sequence forward (training and
prefill), the loss, the decode cache and one decode step, for all six
families (dense, MoE, SSM, hybrid, VLM, audio).

Follows ``repro/models/model.py``. The reference scans stacked layer
parameters; here each layer is an ``nn.Module`` holding the reference's
``(in, out)`` weight orientation, so ``x @ w`` reads as it does there.
Parameters are trainable; the serving path (``decode_step``,
``prefill``) runs without autograd.

``forward`` casts each layer's parameters to the compute dtype inside
the layer, and with ``remat`` wraps the layer in
``torch.utils.checkpoint`` -- the reference's ``jax.checkpoint`` on the
scanned body (for the hybrid family, on each group of
``hybrid_group`` layers). deepseek-style MoE configs (``moe.first > 0``)
keep their first layer dense, as a separate ``layer0``.

Decode uses a paged KV cache: per attention layer a block pool
``(n_blocks, block_tokens, 2, kv_heads, head_dim)`` addressed through a
``(B, max_blocks)`` block table -- the device-side analogue of Taiji's
block-table (EPT) indirection. ``decode_step`` writes the new token's
K/V into the pool in place and reads the pool through the table inside
the hand-written paged-attention kernel (``kernels.ops``); on CPU
tensors the same call runs the kernel's plain version. The SSM and
hybrid families carry each mamba layer's conv window and SSM state in
the cache, and ``decode_step`` writes their new values in place too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.virt import resolve_device
from ..kernels import ops
from ..obs.tracer import ST_DECODE_STEP
from .config import ArchConfig
from .layers import (apply_rope, attention_block, mrope_cos_sin, rms_norm,
                     rope_angles, swiglu)
from .moe import moe_ffn
from .ssm import mamba_block, mamba_decode_step

Cache = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def first_dense(cfg: ArchConfig) -> bool:
    """A MoE config whose first layer stays dense (``layer0``)."""
    return cfg.moe is not None and cfg.moe.first > 0


# ============================================================== parameters
class Attention(nn.Module):
    """``wq`` (D, H*hd), ``wk``/``wv`` (D, KV*hd), ``wo`` (H*hd, D);
    ``bq``/``bk``/``bv`` with QKV bias, ``q_norm``/``k_norm`` (hd,) with
    qk-norm."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        D, hd = cfg.d_model, cfg.head_dim_
        H, KV = cfg.n_heads, cfg.n_kv_heads
        mk = lambda *s: _param(*s, dtype=dtype, device=device)  # noqa: E731
        self.wq, self.wk, self.wv = mk(D, H * hd), mk(D, KV * hd), mk(D, KV * hd)
        self.wo = mk(H * hd, D)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = mk(H * hd), mk(KV * hd), mk(KV * hd)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = mk(hd), mk(hd)


class MLP(nn.Module):
    """SwiGLU: ``w_gate``/``w_up`` (D, F), ``w_down`` (F, D)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.w_gate = _param(D, F, dtype=dtype, device=device)
        self.w_up = _param(D, F, dtype=dtype, device=device)
        self.w_down = _param(F, D, dtype=dtype, device=device)


class MoE(nn.Module):
    """``router`` (D, E), ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D); with shared experts ``shared_gate``/``shared_up`` (D, Fs)
    and ``shared_down`` (Fs, D), Fs = n_shared * F."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        m = cfg.moe
        D, E, F = cfg.d_model, m.n_routed, m.d_ff_expert
        mk = lambda *s: _param(*s, dtype=dtype, device=device)  # noqa: E731
        self.router = mk(D, E)
        self.w_gate, self.w_up, self.w_down = mk(E, D, F), mk(E, D, F), mk(E, F, D)
        if m.n_shared:
            Fs = m.n_shared * F
            self.shared_gate, self.shared_up = mk(D, Fs), mk(D, Fs)
            self.shared_down = mk(Fs, D)


class Mamba(nn.Module):
    """Mamba-1 mixer: ``in_proj`` (D, 2*DI), ``conv_w`` (d_conv, DI),
    ``conv_b`` (DI,), ``x_proj`` (DI, dt_rank + 2*DS), ``dt_proj``
    (dt_rank, DI), ``dt_bias`` (DI,), ``A_log`` (DI, DS), ``D`` (DI,),
    ``out_proj`` (DI, D)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        mc, D, DI, dtr = cfg.mamba, cfg.d_model, cfg.d_inner, cfg.dt_rank_
        mk = lambda *s: _param(*s, dtype=dtype, device=device)  # noqa: E731
        self.in_proj, self.conv_w = mk(D, 2 * DI), mk(mc.d_conv, DI)
        self.conv_b, self.x_proj = mk(DI), mk(DI, dtr + 2 * mc.d_state)
        self.dt_proj, self.dt_bias = mk(dtr, DI), mk(DI)
        self.A_log, self.D = mk(DI, mc.d_state), mk(DI)
        self.out_proj = mk(DI, D)


class DecoderLayer(nn.Module):
    """Norms, attention and either a SwiGLU ``mlp`` or a ``moe`` FFN (the
    dense, MoE, VLM and audio families)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device, *,
                 moe: bool) -> None:
        super().__init__()
        self.ln1 = _param(cfg.d_model, dtype=dtype, device=device)
        self.ln2 = _param(cfg.d_model, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device)
        if moe:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)


class SSMLayer(nn.Module):
    """An SSM-family layer: ``ln1`` and a ``mamba`` mixer, no FFN."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        self.ln1 = _param(cfg.d_model, dtype=dtype, device=device)
        self.mamba = Mamba(cfg, dtype, device)


class HybridGroup(nn.Module):
    """One jamba group of g = ``hybrid_group`` layers, as the reference's
    tree: ``ln_mix`` / ``ln_ffn`` (g, D); one ``attn`` (layer
    ``attn_index``), g-1 ``mamba`` mixers (the other layers, in order);
    g//2 ``moe`` FFNs (odd layers j, ``moe[j//2]``) and g - g//2 ``mlp``
    FFNs (even layers, ``mlp[j//2]``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        g, D = cfg.hybrid_group, cfg.d_model
        self.ln_mix = _param(g, D, dtype=dtype, device=device)
        self.ln_ffn = _param(g, D, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device)
        self.mamba = nn.ModuleList(Mamba(cfg, dtype, device) for _ in range(g - 1))
        self.moe = nn.ModuleList(MoE(cfg, dtype, device) for _ in range(g // 2))
        self.mlp = nn.ModuleList(MLP(cfg, dtype, device)
                                 for _ in range(g - g // 2))


class Model(nn.Module):
    """The reference's parameter tree: ``embed`` (V, D), ``final_norm``
    (D,), ``lm_head`` (D, V) unless embeddings are tied,
    ``frontend_proj`` (frontend_dim, D) for the audio family, and
    ``layers``, one module where the reference stacks them: a
    :class:`DecoderLayer` per layer (MoE layers for a MoE config, after
    the dense ``layer0`` of a first-dense one), an :class:`SSMLayer` per
    layer for the SSM family, a :class:`HybridGroup` per group for the
    hybrid family."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param(V, D, dtype=dtype, device=device)
        self.final_norm = _param(D, dtype=dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(D, V, dtype=dtype, device=device)
        if cfg.frontend_dim:
            self.frontend_proj = _param(cfg.frontend_dim, D, dtype=dtype,
                                        device=device)
        self.layer0 = (DecoderLayer(cfg, dtype, device, moe=False)
                       if first_dense(cfg) else None)
        if cfg.family == "ssm":
            layers = (SSMLayer(cfg, dtype, device) for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            layers = (HybridGroup(cfg, dtype, device)
                      for _ in range(cfg.n_layers // cfg.hybrid_group))
        else:
            layers = (DecoderLayer(cfg, dtype, device, moe=cfg.moe is not None)
                      for _ in range(cfg.n_layers - int(first_dense(cfg))))
        self.layers = nn.ModuleList(layers)

    def decoder_layers(self):
        """Every attention decoder layer in order, ``layer0`` first (the
        families whose layers are all :class:`DecoderLayer`)."""
        return ([self.layer0] if self.layer0 is not None else []) + list(self.layers)


def init_params(cfg: ArchConfig, *, seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                device=None) -> Model:
    """Random parameters in ``cfg.param_dtype``, as the reference's
    ``init_params``: normal with std 0.02, ``wo``, ``w_down``,
    ``shared_down`` and ``out_proj`` scaled by ``1/sqrt(2L)``, ``dt_proj``
    with std ``dt_rank**-0.5``; norms and ``D`` one, biases zero,
    ``dt_bias`` log(e - 1) (softplus of it is 1), ``A_log`` log(1..DS) in
    every channel. The random values come from a torch generator
    (``generator``, or one seeded with ``seed`` on the parameters'
    device), so they are not the reference's. ``device`` ``None`` means
    the card; on ``meta`` there are no values to draw, so the model comes
    back with its shapes and dtypes only (the dry run sizes it)."""
    if (seed is None) == (generator is None):
        raise ValueError("init_params: pass exactly one of seed, generator")
    device = resolve_device(device)
    if device.type == "meta":
        return Model(cfg, DTYPES[cfg.param_dtype], device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = Model(cfg, DTYPES[cfg.param_dtype], device)
    std, std_out = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
    out_proj = ("wo", "w_down", "shared_down", "out_proj")
    ones = ("ln1", "ln2", "ln_mix", "ln_ffn", "final_norm", "q_norm",
            "k_norm", "D")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ones:
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv", "conv_b"):
                p.zero_()
            elif leaf == "dt_bias":
                p.fill_(math.log(math.e - 1))
            elif leaf == "A_log":
                # S4-style A = -(1..d_state) per channel, rounded as the
                # reference: log in f32, then the parameter dtype
                p.copy_(torch.log(torch.arange(
                    1, p.shape[-1] + 1, dtype=torch.float32, device=device)))
            else:
                sd = (cfg.dt_rank_ ** -0.5 if leaf == "dt_proj" else
                      std_out if leaf in out_proj else std)
                p.normal_(0.0, sd, generator=generator)
    return model


def cast_params(model: Model) -> Model:
    """Cast every parameter once, in place, to the config's compute
    dtype, as a server does when it starts: the reference casts each
    layer's parameters at every step (``model.py:592``), which gives the
    same values."""
    return model.to(DTYPES[model.cfg.compute_dtype])


def _cast(module: nn.Module, dtype: torch.dtype) -> dict:
    """The module's parameters as the reference's nested dict, cast to
    ``dtype`` (no copy where they are in it already)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.to(dtype)
    return tree


# ================================================================= forward
def _layer_body(x: torch.Tensor, aux: torch.Tensor, layer: DecoderLayer,
                cfg: ArchConfig, cos: torch.Tensor, sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over (B, S, D), its parameters cast to the
    compute dtype inside (recomputed under remat, as the reference)."""
    lp = _cast(layer, DTYPES[cfg.compute_dtype])
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h = attention_block(h, lp["attn"], cfg, cos, sin, causal=cfg.causal)
    x = x + h
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        h, a = moe_ffn(h, lp["moe"], cfg)
        aux = aux + a
    else:
        m = lp["mlp"]
        h = swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
    return x + h, aux


def _ssm_layer_body(x: torch.Tensor, aux: torch.Tensor, layer: SSMLayer,
                    cfg: ArchConfig, cos=None, sin=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSM-family layer: a pre-norm mamba mixer, no FFN."""
    lp = _cast(layer, DTYPES[cfg.compute_dtype])
    return x + mamba_block(rms_norm(x, lp["ln1"], cfg.norm_eps), lp["mamba"],
                           cfg), aux


def _hybrid_group_body(x: torch.Tensor, aux: torch.Tensor, group: HybridGroup,
                       cfg: ArchConfig, cos: torch.Tensor, sin: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One jamba group of ``hybrid_group`` layers: attention at
    ``attn_index`` and mamba elsewhere (``mi`` counts the mamba layers),
    then a MoE FFN at odd j and a SwiGLU MLP at even j."""
    gp = _cast(group, DTYPES[cfg.compute_dtype])
    mi = 0
    for j in range(cfg.hybrid_group):
        h = rms_norm(x, gp["ln_mix"][j], cfg.norm_eps)
        if j == cfg.attn_index:
            h = attention_block(h, gp["attn"], cfg, cos, sin, causal=True)
        else:
            h = mamba_block(h, gp["mamba"][str(mi)], cfg)
            mi += 1
        x = x + h
        h = rms_norm(x, gp["ln_ffn"][j], cfg.norm_eps)
        if j % 2 == 1:                          # MoE every other layer
            h, a = moe_ffn(h, gp["moe"][str(j // 2)], cfg)
            aux = aux + a
        else:
            m = gp["mlp"][str(j // 2)]
            h = swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
        x = x + h
    return x, aux


_BODIES = {"ssm": _ssm_layer_body, "hybrid": _hybrid_group_body}


def _embed_inputs(model: Model, cfg: ArchConfig, batch: Batch) -> torch.Tensor:
    """The first hidden state: audio frames through ``frontend_proj``, or
    token embeddings -- for the VLM family with the vision prefix written
    over positions ``[0, nv)``."""
    cdt = DTYPES[cfg.compute_dtype]
    if cfg.family == "audio":
        return batch["features"].to(cdt) @ model.frontend_proj.to(cdt)
    x = model.embed[batch["tokens"]].to(cdt)
    if cfg.family == "vlm":
        vis = batch["vision_embeds"].to(cdt)
        x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    return x


def _positions_cos_sin(cfg: ArchConfig, batch: Batch, S: int, device):
    """Rotary angles: M-RoPE from ``batch["mrope_pos"]`` (3, B, S) where
    the config has sections, else RoPE at positions 0..S-1."""
    if cfg.mrope_sections is not None:
        return mrope_cos_sin(batch["mrope_pos"], cfg.head_dim_,
                             cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(torch.arange(S, device=device), cfg.head_dim_,
                       cfg.rope_theta)


def forward(model: Model, cfg: ArchConfig, batch: Batch, *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (hidden (B,S,D) in the compute dtype,
    aux_loss). With ``remat`` each layer (each group for the hybrid
    family) runs under ``torch.utils.checkpoint``."""
    x = _embed_inputs(model, cfg, batch)
    S = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cos = sin = None                        # the SSM family has no attention
    if cfg.family != "ssm":
        cos, sin = _positions_cos_sin(cfg, batch, S, x.device)
    body = _BODIES.get(cfg.family, _layer_body)
    if model.layer0 is not None:            # dense, outside the remat'd stack
        x, aux = _layer_body(x, aux, model.layer0, cfg, cos, sin)
    for layer in model.layers:
        if remat:
            x, aux = checkpoint(body, x, aux, layer, cfg, cos, sin,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = body(x, aux, layer, cfg, cos, sin)
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    return x, aux


def logits_from_hidden(model: Model, cfg: ArchConfig,
                       x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return x @ head.to(x.dtype)


def loss_fn(model: Model, cfg: ArchConfig, batch: Batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token (decoder) or frame-label (encoder) cross entropy (f32
    log-softmax, ``loss_mask`` if the batch has one) plus the MoE
    auxiliary loss."""
    hidden, aux = forward(model, cfg, batch)
    logits = logits_from_hidden(model, cfg, hidden)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    ce = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ================================================================== decode
@dataclasses.dataclass
class CacheSpec:
    """Geometry of the paged decode cache for one arch/shape."""
    batch: int
    max_seq: int
    n_attn_layers: int
    n_mamba_layers: int

    def n_blocks(self, cfg: ArchConfig) -> int:
        return self.batch * (self.max_seq // cfg.kv_block_tokens)

    def max_blocks_per_seq(self, cfg: ArchConfig) -> int:
        return self.max_seq // cfg.kv_block_tokens


def attn_layer_count(cfg: ArchConfig) -> int:
    return sum(cfg.is_attn_layer(l) for l in range(cfg.n_layers)
               ) if cfg.n_heads else 0


def mamba_layer_count(cfg: ArchConfig) -> int:
    if cfg.mamba is None:
        return 0
    return sum(not cfg.is_attn_layer(l) for l in range(cfg.n_layers))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Allocate an empty decode cache (``device`` ``None``: the card):
    ``kv_len``; for the attention layers a paged pool and its block
    table, in the reference's layouts -- ``global``, one flat pool where
    sequence i owns rows ``[i*mbs, (i+1)*mbs)``, or ``per_seq``, the pool
    factored ``(B, mbs, ...)`` with a table that indexes within a
    sequence's own partition; for the mamba layers ``conv_state`` (Lm,
    B, d_conv-1, DI) and ``ssm_state`` (Lm, B, DI, DS) in f32. The SSM
    family has no pool."""
    device = resolve_device(device)
    spec = CacheSpec(batch, max_seq, attn_layer_count(cfg),
                     mamba_layer_count(cfg))
    i32 = dict(dtype=torch.int32, device=device)
    cache = {"kv_len": torch.zeros((batch,), **i32)}
    if spec.n_attn_layers:
        bt = cfg.kv_block_tokens
        nb, mbs = spec.n_blocks(cfg), spec.max_blocks_per_seq(cfg)
        row = (spec.n_attn_layers, bt, 2, cfg.n_kv_heads, cfg.head_dim_)
        if cfg.kv_pool_layout == "per_seq":
            pool = torch.zeros((row[0], batch, mbs, *row[1:]), dtype=dtype,
                               device=device)
            table = torch.arange(mbs, **i32)[None, :].repeat(batch, 1)
        else:
            pool = torch.zeros((row[0], nb, *row[1:]), dtype=dtype,
                               device=device)
            table = (torch.arange(batch, **i32)[:, None] * mbs
                     + torch.arange(mbs, **i32)[None, :])
        cache.update(kv_pool=pool, block_table=table)
    if spec.n_mamba_layers:
        mc, f32 = cfg.mamba, dict(dtype=torch.float32, device=device)
        cache["conv_state"] = torch.zeros(
            (spec.n_mamba_layers, batch, mc.d_conv - 1, cfg.d_inner), **f32)
        cache["ssm_state"] = torch.zeros(
            (spec.n_mamba_layers, batch, cfg.d_inner, mc.d_state), **f32)
    return cache


def _paged_kv_write(pool_l: torch.Tensor, block_table: torch.Tensor,
                    pos: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bt: int) -> None:
    """Write one token's K/V into the paged pool, in place.

    pool_l: (n_blocks, bt, 2, KV, hd) [global layout] or
    (B, mbs, bt, 2, KV, hd) [per_seq layout]; pos: (B,) absolute
    positions; k/v: (B, KV, hd).
    """
    B = pos.shape[0]
    pos = pos.long()
    blk = torch.gather(block_table, 1, (pos // bt)[:, None])[:, 0].long()
    slot = pos % bt
    kv = torch.stack([k, v], dim=1).to(pool_l.dtype)        # (B, 2, KV, hd)
    if pool_l.dim() == 6:                    # per_seq layout
        pool_l[torch.arange(B, device=pos.device), blk, slot] = kv
    else:
        pool_l[blk, slot] = kv


@torch.no_grad()
def decode_step(model: Model, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Cache, mrope_pos: Optional[torch.Tensor] = None,
                input_embeds: Optional[torch.Tensor] = None, tracer=None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B,) -> (logits (B, V), cache').

    ``tracer`` (a :class:`repro_torch.obs.tracer.SpanTracer`, or None)
    records the call as one ``decode_step`` span: the host's dispatch of
    the step, which returns before the card has run it.

    ``input_embeds`` (B, D), if given, takes the place of the token
    embedding (a multimodal prefix replayed through decode);
    ``mrope_pos`` (3, B, 1) gives an M-RoPE config's position ids (the
    current position on all three axes if absent).

    The new token's K/V land in ``cache["kv_pool"]`` and each mamba
    layer's new conv window and SSM state in ``cache["conv_state"]`` /
    ``cache["ssm_state"]``, in place (the reference returns new arrays);
    the returned cache holds them and ``kv_len + 1``. Every attention
    layer reads the pool through the block table in one paged-attention
    call: the dense, MoE, VLM and audio families have one pool layer per
    decoder layer (a first-dense config's ``layer0`` the first), the
    hybrid family one per group, and its mamba states are indexed
    ``group * (g - 1) + mi``. A MoE layer runs ``moe_ffn`` on the (B, 1,
    D) batch. No autograd.
    """
    if tracer is not None:
        t0 = tracer.begin(ST_DECODE_STEP)
    cdt = DTYPES[cfg.compute_dtype]
    B = tokens.shape[0]
    hd = cfg.head_dim_
    pos = cache["kv_len"]                                    # (B,)
    kv_len = pos + 1

    if input_embeds is not None:
        x = input_embeds.to(cdt)
    else:
        x = model.embed[tokens].to(cdt)                      # (B, D)

    # rope angles at the current position
    if cfg.mrope_sections is not None:
        p3 = (mrope_pos if mrope_pos is not None
              else pos[None, :, None].repeat(3, 1, 1))       # (3, B, 1)
        cos, sin = mrope_cos_sin(p3, hd, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.n_heads:
        cos, sin = rope_angles(pos[:, None], hd, cfg.rope_theta)  # (B,1,half)

    if "kv_pool" in cache:
        table = cache["block_table"]
        if cache["kv_pool"].dim() == 7:
            # per_seq: a layer's (B, mbs, ...) pool is read as (B*mbs, ...)
            # rows, with sequence b's table shifted to its own partition
            mbs = cache["kv_pool"].shape[2]
            attn_table = table + mbs * torch.arange(
                B, dtype=table.dtype, device=table.device)[:, None]
        else:
            attn_table = table
        attn_table = attn_table.contiguous()

    def attn_decode(h: torch.Tensor, p: dict,
                    pool_l: torch.Tensor) -> torch.Tensor:
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(B, 1, cfg.n_heads, hd)
        k = k.reshape(B, 1, cfg.n_kv_heads, hd)
        v = v.reshape(B, 1, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        _paged_kv_write(pool_l, table, pos, k[:, 0], v[:, 0],
                        cfg.kv_block_tokens)
        rows = pool_l.flatten(0, 1) if pool_l.dim() == 6 else pool_l
        o = ops.paged_decode_attention(q[:, 0].contiguous(), rows,
                                       attn_table, kv_len)
        return o.reshape(B, cfg.n_heads * hd) @ p["wo"]

    def ffn(h: torch.Tensor, p: dict, moe: bool) -> torch.Tensor:
        if moe:
            return moe_ffn(h[:, None, :], p, cfg)[0][:, 0]
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])

    def mamba_decode(h: torch.Tensor, p: dict, l: int) -> torch.Tensor:
        conv, ssm = cache["conv_state"][l], cache["ssm_state"][l]
        h, new_conv, new_ssm = mamba_decode_step(h, p, cfg, conv, ssm)
        conv.copy_(new_conv)
        ssm.copy_(new_ssm)
        return h

    if cfg.family == "ssm":
        for l, layer in enumerate(model.layers):
            lp = _cast(layer, cdt)      # no copy once cast_params has run
            x = x + mamba_decode(rms_norm(x, lp["ln1"], cfg.norm_eps),
                                 lp["mamba"], l)
    elif cfg.family == "hybrid":
        g = cfg.hybrid_group
        for gi, (group, pool_l) in enumerate(zip(model.layers,
                                                 cache["kv_pool"])):
            gp, mi = _cast(group, cdt), 0
            for j in range(g):
                h = rms_norm(x, gp["ln_mix"][j], cfg.norm_eps)
                if j == cfg.attn_index:
                    x = x + attn_decode(h, gp["attn"], pool_l)
                else:
                    x = x + mamba_decode(h, gp["mamba"][str(mi)],
                                         gi * (g - 1) + mi)
                    mi += 1
                h = rms_norm(x, gp["ln_ffn"][j], cfg.norm_eps)
                moe = j % 2 == 1
                x = x + ffn(h, gp["moe" if moe else "mlp"][str(j // 2)], moe)
    else:
        for layer, pool_l in zip(model.decoder_layers(), cache["kv_pool"]):
            lp = _cast(layer, cdt)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + attn_decode(h, lp["attn"], pool_l)
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            moe = "moe" in lp
            x = x + ffn(h, lp["moe" if moe else "mlp"], moe)
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    logits = logits_from_hidden(model, cfg, x)
    new_cache = dict(cache)
    new_cache["kv_len"] = kv_len
    if tracer is not None:
        tracer.end(ST_DECODE_STEP, t0)
    return logits, new_cache


# ================================================================= prefill
@torch.no_grad()
def prefill(model: Model, cfg: ArchConfig, batch: Batch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward (no remat, no autograd): returns last-position
    logits (B, V) and aux."""
    hidden, aux = forward(model, cfg, batch, remat=False)
    return logits_from_hidden(model, cfg, hidden[:, -1, :]), aux
