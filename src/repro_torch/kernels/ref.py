"""Plain PyTorch versions of the port's kernels, written to follow
``repro/kernels/ref.py`` operation for operation.

They are what :mod:`.ops` runs for tensors on the CPU, and what
``chip_smoke.py`` holds each CUDA kernel against on the card. The swap
functions are exact (bytes and integers), so their kernels must match
them bit for bit; paged attention is floating point and is held within
the tolerances of ``tests/test_kernels.py`` (latent attention, which no
Pallas kernel has, within those of ``tests/test_torch_mla.py``). The int8
block quantizer is exact too: its absmax is order-free, and every other
step is one IEEE operation, so its kernel must match it bit for bit as
well.
"""
from __future__ import annotations

from typing import Tuple

import torch

_CHK_P = 65521          # largest prime < 2^16 (Adler/Fletcher)
_CHUNK = 4096           # the reference's modular-fold granularity


def zero_detect(blocks: torch.Tensor) -> torch.Tensor:
    """blocks: (n, elems) -> (n,) bool, True where the row is all zero.
    Compares values, so ``-0.0`` counts as zero for float rows."""
    return (blocks == 0).all(dim=-1)


def fletcher_checksum(blocks: torch.Tensor) -> torch.Tensor:
    """Weighted Fletcher-style checksum per row.

    blocks: (n, elems) uint8-valued (any int dtype, cast through uint32
    as the reference does) -> (n,) uint32 =
    ``(sum(x) mod p) | ((sum((i+1) * x) mod p) << 16)``. Accumulates in
    int64 and folds modulo p per 4096-element chunk, as the reference.
    """
    x = (blocks.to(torch.int64) & 0xFFFFFFFF) % _CHK_P
    n, elems = x.shape
    w = (torch.arange(elems, dtype=torch.int64, device=x.device) + 1) % _CHK_P
    pad = (-elems) % _CHUNK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    xc = x.reshape(n, -1, _CHUNK)
    wc = w.reshape(-1, _CHUNK)
    s1 = (xc.sum(dim=-1) % _CHK_P).sum(dim=-1) % _CHK_P
    s2 = (((xc * wc[None]) % _CHK_P).sum(dim=-1) % _CHK_P).sum(dim=-1) % _CHK_P
    return (s1 | (s2 << 16)).to(torch.uint32)


def block_quantize(blocks: torch.Tensor, mps_per_block: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-MP symmetric int8 quantization.

    blocks: (n, elems) float -> (q (n, elems) int8, scales (n, mps) f32).
    Each row is split into ``mps_per_block`` equal MPs with independent
    absmax scales: ``scale = absmax / 127`` (1 where the MP is all zero)
    and ``q = clip(round(x / scale), -127, 127)``, rounding half to even.

    Both divisions are true f32 divisions, as in the reference's eager
    oracle: the divisor is a tensor, because on CUDA torch multiplies by
    the reciprocal of a Python-number divisor, which can differ in the
    last bit (as XLA does under ``jit``, so the Pallas kernel's scales
    sit up to one ulp from the oracle's).
    """
    n, elems = blocks.shape
    mp = elems // mps_per_block
    x = blocks.reshape(n, mps_per_block, mp).to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(n, elems), scale


def block_dequantize(q: torch.Tensor, scales: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`block_quantize`: ``q * scale`` of its MP in f32,
    rounded to ``out_dtype`` -> (n, elems)."""
    n, elems = q.shape
    mps = scales.shape[-1]
    x = q.reshape(n, mps, elems // mps).to(torch.float32)
    return (x * scales[..., None]).reshape(n, elems).to(out_dtype)


def gather_blocks(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Swap-out copy: ``out[i] = pool[indices[i]]``."""
    return pool.index_select(0, indices)


def gather_nonzero_blocks(pool: torch.Tensor, indices: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The swap-out's chunk read: :func:`gather_blocks` then
    :func:`zero_detect` -> ``(zero (k,) bool, the non-zero rows in
    ascending order)``."""
    rows = gather_blocks(pool, indices)
    zero = zero_detect(rows)
    return zero, rows[~zero]


def scatter_blocks_(pool: torch.Tensor, indices: torch.Tensor,
                    blocks: torch.Tensor) -> None:
    """Swap-in copy, in place: ``pool[indices[i]] = blocks[i]``."""
    pool.index_copy_(0, indices, blocks)


def scatter_verified_blocks_(pool: torch.Tensor, stage: torch.Tensor,
                             dst: torch.Tensor, tags: torch.Tensor,
                             zero: torch.Tensor) -> int:
    """The swap-in's verified write, in place, all or nothing.

    stage: (R, elems) staged rows; dst: (R,) int64 pool row of each, -1
    for a row that is only verified; tags: (R,) int64 expected Fletcher
    tag of each, -1 for none; zero: (Z,) int64 pool rows to zero. If
    every expected tag equals :func:`fletcher_checksum` of its row,
    :func:`scatter_blocks_` writes the rows that have a destination, the
    zero rows are zeroed, and -1 is returned; else nothing is written and
    the first staged row whose tag differs is returned.
    """
    has = tags >= 0
    if bool(has.any()):
        got = fletcher_checksum(stage[has]).to(torch.int64)
        bad = (got != tags[has]).nonzero()
        if len(bad):
            return int(has.nonzero()[int(bad[0, 0]), 0])
    write = dst >= 0
    scatter_blocks_(pool, dst[write], stage[write])
    pool.index_fill_(0, zero, 0)
    return -1


def paged_decode_attention(q: torch.Tensor, kv_pool: torch.Tensor,
                           block_table: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention through a block table (the EPT walk on the I/O path).

    q: (B, H, hd); kv_pool: (n_blocks, bt, 2, KV, hd); block_table:
    (B, mbs) int; kv_len: (B,) int. Returns (B, H, hd) in q's dtype.

    As the reference's oracle, except that a sequence with ``kv_len ==
    0`` gets zeros, as the Pallas kernel gives it (the oracle's softmax
    over an all-masked row would return the mean of V). Table entries
    of context blocks at or past ``ceil(kv_len / bt)`` are never used.
    """
    B, H, hd = q.shape
    _, bt, _, KV, _ = kv_pool.shape
    mbs = block_table.shape[1]
    kv_len = kv_len.to(torch.int64)
    # the entries of blocks no position reads may be anything: point them
    # at block 0 (their scores are masked below)
    used = (torch.arange(mbs, device=q.device)[None, :] * bt) < kv_len[:, None]
    table = torch.where(used, block_table.to(torch.int64),
                        torch.zeros_like(block_table, dtype=torch.int64))
    gathered = kv_pool[table]                      # (B, mbs, bt, 2, KV, hd)
    seq = gathered.reshape(B, mbs * bt, 2, KV, hd)
    k, v = seq[:, :, 0], seq[:, :, 1]
    g = H // KV
    qg = q.reshape(B, KV, g, hd).float() * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    pos = torch.arange(mbs * bt, device=q.device)
    mask = pos[None, None, None, :] < kv_len[:, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = torch.where(kv_len[:, None, None, None] > 0, o, torch.zeros_like(o))
    return o.reshape(B, H, hd).to(q.dtype)


def paged_mla_decode(q: torch.Tensor, latent_pool: torch.Tensor,
                     block_table: torch.Tensor, kv_len: torch.Tensor,
                     kv_rank: int, scale: float) -> torch.Tensor:
    """Latent (MLA) decode attention through a block table, absorbed form.

    q: (B, H, W), each head's ``[q_lat | q_pe]``; latent_pool: (n_blocks,
    bt, W), each token's ``[c | k_pe]``; block_table: (B, mbs) int;
    kv_len: (B,) int. The score of a position is ``q . row * scale``
    (every head against the one shared row), the softmax is over the
    positions below ``kv_len[b]``, and the output (B, H, kv_rank) in q's
    dtype is ``sum p c``: the first ``kv_rank`` values of a row are also
    its value. In f32; ``kv_len == 0`` gives zeros. It replaces no Pallas
    kernel: the reference has no latent attention.
    """
    B, H, W = q.shape
    _, bt, _ = latent_pool.shape
    mbs = block_table.shape[1]
    kv_len = kv_len.to(torch.int64)
    used = (torch.arange(mbs, device=q.device)[None, :] * bt) < kv_len[:, None]
    table = torch.where(used, block_table.to(torch.int64),
                        torch.zeros_like(block_table, dtype=torch.int64))
    rows = latent_pool[table].reshape(B, mbs * bt, W).float()
    s = torch.einsum("bhw,bsw->bhs", q.float(), rows) * scale
    pos = torch.arange(mbs * bt, device=q.device)
    s = torch.where(pos[None, None, :] < kv_len[:, None, None], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bsr->bhr", p, rows[..., :kv_rank])
    o = torch.where(kv_len[:, None, None] > 0, o, torch.zeros_like(o))
    return o.to(q.dtype)
