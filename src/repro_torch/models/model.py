"""Model assembly for the decode path: parameters, the paged KV cache and
one decode step, dense family.

Follows ``repro/models/model.py``. The reference scans stacked layer
parameters; here each layer is an ``nn.Module`` holding the reference's
``(in, out)`` weight orientation, so ``x @ w`` reads as it does there.
Parameters carry no gradient (the decode path is inference only).

Decode uses a paged KV cache: per attention layer a block pool
``(n_blocks, block_tokens, 2, kv_heads, head_dim)`` addressed through a
``(B, max_blocks)`` block table -- the device-side analogue of Taiji's
block-table (EPT) indirection. ``decode_step`` writes the new token's
K/V into the pool in place and reads the pool through the table inside
the hand-written paged-attention kernel (``kernels.ops``); on CPU
tensors the same call runs the kernel's plain version.

Only the dense family is ported: MoE, SSM, hybrid, audio and VLM configs
raise ``NotImplementedError`` (ROADMAP.md, Queue A).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.virt import resolve_device
from ..kernels import ops
from .config import ArchConfig
from .layers import apply_rope, rms_norm, rope_angles, swiglu

Cache = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the port "
            f"runs dense decoders only (ROADMAP.md, Queue A)")


def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


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


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device) -> None:
        super().__init__()
        self.ln1 = _param(cfg.d_model, dtype=dtype, device=device)
        self.ln2 = _param(cfg.d_model, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class Model(nn.Module):
    """The reference's parameter tree: ``embed`` (V, D), ``final_norm``
    (D,), ``lm_head`` (D, V) unless embeddings are tied, and one
    :class:`DecoderLayer` per layer where the reference stacks them."""

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
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ArchConfig, *, seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                device=None) -> Model:
    """Random parameters in ``cfg.param_dtype``, as the reference's
    ``init_params``: normal with std 0.02, ``wo`` and ``w_down`` scaled
    by ``1/sqrt(2L)``, norms one, biases zero. The values come from a
    torch generator (``generator``, or one seeded with ``seed`` on the
    parameters' device), so they are not the reference's. ``device``
    ``None`` means the card."""
    if (seed is None) == (generator is None):
        raise ValueError("init_params: pass exactly one of seed, generator")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = Model(cfg, DTYPES[cfg.param_dtype], device)
    std, std_out = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
    out_proj = ("wo", "w_down")
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


def logits_from_hidden(model: Model, cfg: ArchConfig,
                       x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return x @ head.to(x.dtype)


def decode_step(model: Model, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B,) -> (logits (B, V), cache').

    The new token's K/V land in ``cache["kv_pool"]`` in place (the
    reference returns a new pool); the returned cache holds that pool
    and ``kv_len + 1``. Every attention layer reads the pool through the
    block table in one paged-attention call.
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

    for layer, pool_l in zip(model.layers, pool):
        h = rms_norm(x, w(layer.ln1), cfg.norm_eps)
        x = x + attn_decode(h, layer.attn, pool_l)
        h = rms_norm(x, w(layer.ln2), cfg.norm_eps)
        m = layer.mlp
        x = x + swiglu(h, w(m.w_gate), w(m.w_up), w(m.w_down))
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    logits = logits_from_hidden(model, cfg, x)
    new_cache = dict(cache)
    new_cache["kv_len"] = kv_len
    return logits, new_cache
