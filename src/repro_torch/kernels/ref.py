"""Plain PyTorch versions of the swap kernels, written to follow
``repro/kernels/ref.py`` operation for operation.

They are what :mod:`.ops` runs for tensors on the CPU, and what
``chip_smoke.py`` holds each CUDA kernel against on the card. Every
function here is exact (bytes and integers), so the kernels must match
them bit for bit.
"""
from __future__ import annotations

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


def gather_blocks(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Swap-out copy: ``out[i] = pool[indices[i]]``."""
    return pool.index_select(0, indices)


def scatter_blocks_(pool: torch.Tensor, indices: torch.Tensor,
                    blocks: torch.Tensor) -> None:
    """Swap-in copy, in place: ``pool[indices[i]] = blocks[i]``."""
    pool.index_copy_(0, indices, blocks)
