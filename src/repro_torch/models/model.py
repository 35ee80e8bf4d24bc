"""Model assembly: parameters, the full-sequence forward (training and
prefill), the loss, the paged KV cache and one decode step, for the
dense and MoE families.

Follows ``repro/models/model.py``. The reference scans stacked layer
parameters; here each layer is an ``nn.Module`` holding the reference's
``(in, out)`` weight orientation, so ``x @ w`` reads as it does there.
Parameters are trainable; the serving path (``decode_step``,
``prefill``) runs without autograd.

``forward`` casts each layer's parameters to the compute dtype inside
the layer, and with ``remat`` wraps the layer in
``torch.utils.checkpoint`` -- the reference's ``jax.checkpoint`` on the
scanned body. deepseek-style MoE configs (``moe.first > 0``) keep their
first layer dense, as a separate ``layer0``.

Decode uses a paged KV cache: per attention layer a block pool
``(n_blocks, block_tokens, 2, kv_heads, head_dim)`` addressed through a
``(B, max_blocks)`` block table -- the device-side analogue of Taiji's
block-table (EPT) indirection. ``decode_step`` writes the new token's
K/V into the pool in place and reads the pool through the table inside
the hand-written paged-attention kernel (``kernels.ops``); on CPU
tensors the same call runs the kernel's plain version.

The SSM, hybrid, audio and VLM families raise ``NotImplementedError``
(ROADMAP.md, Queue A).
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
from .config import ArchConfig
from .layers import apply_rope, attention_block, rms_norm, rope_angles, swiglu
from .moe import moe_ffn

Cache = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the port "
            f"runs the dense and MoE families, and the SSM, hybrid, VLM and "
            f"audio families come with the next slice (ROADMAP.md, Queue A)")


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


class DecoderLayer(nn.Module):
    """Norms, attention and either a SwiGLU ``mlp`` or a ``moe`` FFN."""

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


class Model(nn.Module):
    """The reference's parameter tree: ``embed`` (V, D), ``final_norm``
    (D,), ``lm_head`` (D, V) unless embeddings are tied, the dense
    ``layer0`` of a first-dense MoE config, and one
    :class:`DecoderLayer` per layer where the reference stacks them (MoE
    layers for a MoE config)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        _check_family(cfg)
        cfg.validate()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param(V, D, dtype=dtype, device=device)
        self.final_norm = _param(D, dtype=dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(D, V, dtype=dtype, device=device)
        self.layer0 = (DecoderLayer(cfg, dtype, device, moe=False)
                       if first_dense(cfg) else None)
        L = cfg.n_layers - int(first_dense(cfg))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device, moe=cfg.moe is not None)
            for _ in range(L))

    def decoder_layers(self):
        """Every decoder layer in order, ``layer0`` first."""
        return ([self.layer0] if self.layer0 is not None else []) + list(self.layers)


def init_params(cfg: ArchConfig, *, seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                device=None) -> Model:
    """Random parameters in ``cfg.param_dtype``, as the reference's
    ``init_params``: normal with std 0.02, ``wo``, ``w_down`` and
    ``shared_down`` scaled by ``1/sqrt(2L)``, norms one, biases zero. The
    values come from a torch generator (``generator``, or one seeded with
    ``seed`` on the parameters' device), so they are not the reference's.
    ``device`` ``None`` means the card."""
    if (seed is None) == (generator is None):
        raise ValueError("init_params: pass exactly one of seed, generator")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = Model(cfg, DTYPES[cfg.param_dtype], device)
    std, std_out = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
    out_proj = ("wo", "w_down", "shared_down")
    norms = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in norms:
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            else:
                p.normal_(0.0, std_out if leaf in out_proj else std,
                          generator=generator)
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


def forward(model: Model, cfg: ArchConfig, batch: Batch, *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (hidden (B,S,D) in the compute dtype,
    aux_loss)."""
    _check_family(cfg)
    x = model.embed[batch["tokens"]].to(DTYPES[cfg.compute_dtype])
    S = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cos, sin = rope_angles(torch.arange(S, device=x.device), cfg.head_dim_,
                           cfg.rope_theta)
    if model.layer0 is not None:            # dense, outside the remat'd stack
        x, aux = _layer_body(x, aux, model.layer0, cfg, cos, sin)
    for layer in model.layers:
        if remat:
            x, aux = checkpoint(_layer_body, x, aux, layer, cfg, cos, sin,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _layer_body(x, aux, layer, cfg, cos, sin)
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    return x, aux


def logits_from_hidden(model: Model, cfg: ArchConfig,
                       x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return x @ head.to(x.dtype)


def loss_fn(model: Model, cfg: ArchConfig, batch: Batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (f32 log-softmax, ``loss_mask`` if the
    batch has one) plus the MoE auxiliary loss."""
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


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Allocate an empty paged decode cache (``device`` ``None``: the
    card). Layouts as the reference: ``global`` -- one flat pool, where
    sequence i owns rows ``[i*mbs, (i+1)*mbs)`` -- or ``per_seq`` -- the
    pool factored ``(B, mbs, ...)`` with a table that indexes within a
    sequence's own partition."""
    _check_family(cfg)
    device = resolve_device(device)
    spec = CacheSpec(batch, max_seq, attn_layer_count(cfg), 0)
    bt = cfg.kv_block_tokens
    nb, mbs = spec.n_blocks(cfg), spec.max_blocks_per_seq(cfg)
    i32 = dict(dtype=torch.int32, device=device)
    row = (spec.n_attn_layers, bt, 2, cfg.n_kv_heads, cfg.head_dim_)
    if cfg.kv_pool_layout == "per_seq":
        pool = torch.zeros((row[0], batch, mbs, *row[1:]), dtype=dtype,
                           device=device)
        table = torch.arange(mbs, **i32)[None, :].repeat(batch, 1)
    else:
        pool = torch.zeros((row[0], nb, *row[1:]), dtype=dtype, device=device)
        table = (torch.arange(batch, **i32)[:, None] * mbs
                 + torch.arange(mbs, **i32)[None, :])
    return {"kv_len": torch.zeros((batch,), **i32), "kv_pool": pool,
            "block_table": table}


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
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B,) -> (logits (B, V), cache').

    The new token's K/V land in ``cache["kv_pool"]`` in place (the
    reference returns a new pool); the returned cache holds that pool
    and ``kv_len + 1``. Every attention layer reads the pool through the
    block table in one paged-attention call. A MoE layer runs ``moe_ffn``
    on the (B, 1, D) batch; a first-dense config's ``layer0`` uses the
    pool's first layer. No autograd.
    """
    _check_family(cfg)
    cdt = DTYPES[cfg.compute_dtype]
    B = tokens.shape[0]
    hd = cfg.head_dim_
    bt = cfg.kv_block_tokens
    pos = cache["kv_len"]                                    # (B,)
    kv_len = pos + 1
    table = cache["block_table"]
    pool = cache["kv_pool"]
    if pool.dim() == 7:
        # per_seq: a layer's (B, mbs, ...) pool is read as (B*mbs, ...)
        # rows, with sequence b's table shifted to its own partition
        mbs = pool.shape[2]
        attn_table = table + mbs * torch.arange(
            B, dtype=table.dtype, device=table.device)[:, None]
    else:
        attn_table = table
    attn_table = attn_table.contiguous()

    x = model.embed[tokens].to(cdt)                          # (B, D)
    cos, sin = rope_angles(pos[:, None], hd, cfg.rope_theta)  # (B, 1, half)

    def w(t: torch.Tensor) -> torch.Tensor:
        return t.to(cdt)          # no copy once cast_params has run

    def attn_decode(h: torch.Tensor, p: Attention,
                    pool_l: torch.Tensor) -> torch.Tensor:
        q, k, v = h @ w(p.wq), h @ w(p.wk), h @ w(p.wv)
        if cfg.qkv_bias:
            q, k, v = q + w(p.bq), k + w(p.bk), v + w(p.bv)
        q = q.reshape(B, 1, cfg.n_heads, hd)
        k = k.reshape(B, 1, cfg.n_kv_heads, hd)
        v = v.reshape(B, 1, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, w(p.q_norm), cfg.norm_eps)
            k = rms_norm(k, w(p.k_norm), cfg.norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        _paged_kv_write(pool_l, table, pos, k[:, 0], v[:, 0], bt)
        rows = pool_l.flatten(0, 1) if pool_l.dim() == 6 else pool_l
        o = ops.paged_decode_attention(q[:, 0].contiguous(), rows,
                                       attn_table, kv_len)
        return o.reshape(B, cfg.n_heads * hd) @ w(p.wo)

    for layer, pool_l in zip(model.decoder_layers(), pool):
        h = rms_norm(x, w(layer.ln1), cfg.norm_eps)
        x = x + attn_decode(h, layer.attn, pool_l)
        h = rms_norm(x, w(layer.ln2), cfg.norm_eps)
        if hasattr(layer, "moe"):
            mp = {n: w(t) for n, t in layer.moe.named_parameters()}
            x = x + moe_ffn(h[:, None, :], mp, cfg)[0][:, 0]
        else:
            m = layer.mlp
            x = x + swiglu(h, w(m.w_gate), w(m.w_up), w(m.w_down))
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    logits = logits_from_hidden(model, cfg, x)
    new_cache = dict(cache)
    new_cache["kv_len"] = kv_len
    return logits, new_cache


# ================================================================= prefill
@torch.no_grad()
def prefill(model: Model, cfg: ArchConfig, batch: Batch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward (no remat, no autograd): returns last-position
    logits (B, V) and aux."""
    hidden, aux = forward(model, cfg, batch, remat=False)
    return logits_from_hidden(model, cfg, hidden[:, -1, :]), aux
