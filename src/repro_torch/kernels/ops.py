"""Wrappers of the port's kernels: the swap data-path kernels (the
indexed pass, the verified scatter, Fletcher tags), paged decode
attention, paged latent (MLA) decode attention and the int8 block
quantize/dequantize pair.

Each wrapper checks device, dtype, shape and contiguity, then dispatches
on where its tensors live:

* on a CUDA device it launches the hand-written Hopper kernel from
  ``csrc/swap_kernels.cu``, ``csrc/paged_attention.cu``,
  ``csrc/paged_mla.cu`` or ``csrc/quantize.cu`` on the current stream
  and bumps
  ``launches[name]`` -- there is no fallback: a kernel that does not
  build or launch raises;
* on the CPU it runs the plain version in :mod:`.ref`, and counts
  nothing;
* the two paged attentions, the wrappers the model's step reaches, also
  take meta tensors: each returns an empty output of its shape and
  dtype, nothing executes, and it reports the kernel's own FLOPs and
  bytes to :data:`meta_cost_sinks` (the dry run, ``launch/dryrun.py``).
  This is shape inference, not a fallback; every other device raises.

Index vectors of the swap kernels come from the host bitmaps (numpy);
the wrappers check them against the pool on the host, and both the
indexed pass (gather, zero scan, and the swap-out's compacting gather)
and the verified scatter (the swap-in's write, and the plain scatter)
take them by value in their launch parameters. Paged attention takes its block table and lengths on the
device and never synchronises: the kernel itself traps on a table entry
out of range.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..analysis.lock_order import named_lock
from . import _build, ref

# launches of each kernel since the last reset; plain integers, bumped
# only where a kernel is launched. hv_sched threads launch too, so every
# bump and reset holds the lock (a bare += can lose an increment). The
# verified scatter's ("scatter_verified": the swap-in's write; "scatter"
# counts its plain mode), paged attention's ("paged_attn"), latent
# attention's ("paged_mla") and quantize's ("quantize", "dequantize")
# entries appear with their first launch
launches: Dict[str, int] = {"gather": 0, "scatter": 0, "zero": 0,
                            "fletcher": 0}
# launches recorded into CUDA graphs, counted apart: a launch made while
# the launching thread's stream captures runs at each replay, not now. A
# graph's owner takes this tally's change over its capture and adds it to
# ``launches`` at each replay (count_graph); never reset
captured: Dict[str, int] = {}
# host transfers around the swap kernels, counted the same way: index
# vectors uploaded on their own, and host waits for a verified scatter's
# verdict
transfers: Dict[str, int] = {"index_upload": 0, "verdict_wait": 0}
_count_lock = named_lock("metrics")
# where a kernel traced on meta reports its cost, as (kernel, FLOPs,
# bytes): nothing runs there that an operator counter could see.
# ``launch.op_count.OpCounter`` adds its own while it counts
meta_cost_sinks: List[Callable[[str, float, float], None]] = []


def reset_launches() -> None:
    with _count_lock:
        for counts in (launches, transfers):
            for k in counts:
                counts[k] = 0


def _count(name: str, n: int = 1) -> None:
    tally = captured if torch.cuda.is_current_stream_capturing() else launches
    with _count_lock:
        tally[name] = tally.get(name, 0) + n


def count_graph(recorded: Dict[str, int]) -> None:
    """Count a CUDA graph's replay: ``recorded`` is what its capture added
    to :data:`captured`, name by name."""
    with _count_lock:
        for name, n in recorded.items():
            launches[name] = launches.get(name, 0) + n


def _count_transfer(name: str) -> None:
    with _count_lock:
        transfers[name] += 1


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on anything
    else or on a mix."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA or CPU tensors, got {dev}")
    return True


def _check_rows(name: str, t: torch.Tensor) -> None:
    """Shape, layout and -- off the CPU, where the kernel runs -- dtype."""
    if t.dim() != 2:
        raise ValueError(f"{name}: expects (rows, elems), got {tuple(t.shape)}")
    if t.device.type != "cpu" and t.dtype != torch.uint8:
        # the kernels compare and sum bytes; a float row would see -0.0
        # as non-zero where the value comparison of the reference does not
        raise TypeError(f"{name}: the CUDA kernel takes uint8 rows, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")


def _host_index(name: str, idx, n_pool: int) -> np.ndarray:
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    if idx.ndim != 1:
        raise ValueError(f"{name}: indices must be 1-D, got {idx.shape}")
    if not np.issubdtype(idx.dtype, np.integer):
        raise TypeError(f"{name}: indices must be integers, got {idx.dtype}")
    idx = idx.astype(np.int64, copy=False)
    if len(idx) and (idx.min() < 0 or idx.max() >= n_pool):
        raise IndexError(f"{name}: index out of range for {n_pool} rows")
    return idx


def _check_rc(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name}: launch failed: {lib.swap_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dev_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """An index vector uploaded on its own (counted): no kernel of the
    swap path takes one any more, and the counter shows that."""
    _count_transfer("index_upload")
    return torch.from_numpy(np.ascontiguousarray(idx)).to(device)


def copy_to_host(*tensors: torch.Tensor):
    """CPU copies of ``tensors`` after one wait: device tensors go through
    pinned buffers of their own (non-blocking copies, then one sync of the
    current stream); CPU tensors come back as they are."""
    if not tensors or all(t.device.type == "cpu" for t in tensors):
        return list(tensors)
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return out


# ------------------------------------------------------------ indexed pass
# modes of swap_gather_pass in csrc/swap_kernels.cu
_FULL, _FLAGS, _COMPACT = 0, 1, 2


def _launch_pass(name: str, mode: int, pool: torch.Tensor,
                 idx: "np.ndarray | None", n: int, out=None, zero=None,
                 count=None) -> None:
    """One call of the indexed pass on already-checked operands; ``idx``
    is a host index vector (None: the identity), passed by value."""
    if pool.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: {pool.shape[0]} rows overflow int32 indices")
    if idx is not None:
        idx = np.ascontiguousarray(idx, dtype=np.int32)
    lib = _build.load()
    with torch.cuda.device(pool.device):
        rc = lib.swap_gather_pass(
            mode, pool.data_ptr(), None if idx is None else idx.ctypes.data, n,
            pool.shape[1], *(None if t is None else t.data_ptr()
                             for t in (out, zero, count)), _stream(pool))
    _check_rc(lib, rc, name)


def gather_rows(pool: torch.Tensor, idx) -> torch.Tensor:
    """``out[i] = pool[idx[i]]``: (n_pool, elems) rows, host index vector
    -> a new (len(idx), elems) tensor on the pool's device."""
    _check_rows("gather_rows", pool)
    cuda = _on_cuda("gather_rows", pool)
    idx = _host_index("gather_rows", idx, pool.shape[0])
    if not cuda:
        return ref.gather_blocks(pool, torch.from_numpy(idx))
    out = torch.empty((len(idx), pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    if len(idx):
        launch_gather(pool, idx, out)
    return out


def launch_gather(pool: torch.Tensor, idx: np.ndarray,
                  out: torch.Tensor) -> None:
    """One gather on already-checked operands (host indices in range,
    contiguous uint8 rows)."""
    _launch_pass("gather_rows", _FULL, pool, idx, len(idx), out=out)
    _count("gather")


def gather_nonzero_rows(pool: torch.Tensor, idx):
    """The swap-out's read of a chunk: rows ``pool[idx[i]]``, read once.

    Returns ``(zero, rows)``: ``zero`` a (len(idx),) bool tensor on the
    host, True where the row is all zero, and ``rows`` the non-zero rows
    in ascending ``i`` order, (count, elems) on the pool's device. On
    the card one launch does it (:func:`launch_gather_nonzero`) and one
    wait brings the flags and the count to the host.
    """
    name = "gather_nonzero_rows"
    _check_rows(name, pool)
    cuda = _on_cuda(name, pool)
    idx = _host_index(name, idx, pool.shape[0])
    if not cuda:
        return ref.gather_nonzero_blocks(pool, torch.from_numpy(idx))
    k = len(idx)
    out = torch.empty((k, pool.shape[1]), dtype=pool.dtype, device=pool.device)
    if not k:
        return torch.zeros(0, dtype=torch.bool), out
    meta = torch.empty(4 + k, dtype=torch.uint8, device=pool.device)
    launch_gather_nonzero(pool, idx, meta, out)
    (meta,) = copy_to_host(meta)
    return meta[4:].view(torch.bool), out[:int(meta[:4].view(torch.int32))]


def launch_gather_nonzero(pool: torch.Tensor, idx: np.ndarray,
                          meta: torch.Tensor, out: torch.Tensor) -> None:
    """One compacting gather on already-checked operands: ``meta`` is
    4 + len(idx) bytes, the int32 count then the zero flags; ``out`` has
    room for every row. Counted as a gather: it does the gather's work."""
    _launch_pass("gather_nonzero_rows", _COMPACT, pool, idx, len(idx),
                 out=out, zero=meta[4:], count=meta[:4])
    _count("gather")


def scatter_rows_(pool: torch.Tensor, idx, blocks: torch.Tensor) -> None:
    """``pool[idx[i]] = blocks[i]`` in place; rows not in ``idx`` are
    never touched. Duplicate indices give an undefined result. On the
    card: the verified scatter's plain mode, indices by value."""
    _check_rows("scatter_rows_", pool)
    _check_rows("scatter_rows_", blocks)
    cuda = _on_cuda("scatter_rows_", pool, blocks)
    idx = _host_index("scatter_rows_", idx, pool.shape[0])
    if blocks.shape != (len(idx), pool.shape[1]) or blocks.dtype != pool.dtype:
        raise ValueError(
            f"scatter_rows_: blocks {tuple(blocks.shape)} {blocks.dtype} do not "
            f"fit {len(idx)} rows of {tuple(pool.shape)} {pool.dtype}")
    if not cuda:
        ref.scatter_blocks_(pool, torch.from_numpy(idx), blocks)
        return
    if len(idx):
        launch_scatter(pool, idx, blocks)


def launch_scatter(pool: torch.Tensor, idx: np.ndarray,
                   blocks: torch.Tensor) -> None:
    """One plain scatter on checked operands (contiguous uint8 rows)."""
    _launch_scatter("scatter_rows_", "scatter", pool, blocks.data_ptr(),
                    blocks.shape[0], idx)


_NO_ROWS = np.zeros(0, dtype=np.int64)
_BAD_INDEX = -1        # swap_scatter_verified's code for an index out of range


def _launch_scatter(name: str, counter: str, pool: torch.Tensor, stage: int,
                    n: int, dst, tags=None, zero=None, verdict: int = 0,
                    upload: int = 0, host_verdict: int = 0) -> None:
    """One call of ``swap_scatter_verified``: ``stage`` is the device
    address of the ``n`` staged rows; ``dst``, ``tags`` (-1: none) and
    ``zero`` are host vectors, passed by value and checked against the
    pool there. ``upload``: the address of a pinned host copy of the rows,
    uploaded to ``stage`` first on the same stream. ``verdict`` and
    ``host_verdict``: device and pinned host addresses of one int32; with
    ``host_verdict`` the call copies the verdict back and waits for the
    stream, the one host wait."""
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if tags is not None:
        tags = np.ascontiguousarray(tags, dtype=np.int64)
    zero = _NO_ROWS if zero is None else np.ascontiguousarray(zero, dtype=np.int64)
    if len(dst) != n or (tags is not None and len(tags) != n):
        raise ValueError(f"{name}: {len(dst)} destinations and "
                         f"{None if tags is None else len(tags)} tags for {n} rows")
    launched = ctypes.c_int32(0)
    lib = _build.load()
    with _on_device(pool.device):
        rc = lib.swap_scatter_verified(
            pool.data_ptr(), pool.shape[0], stage, n, pool.shape[1],
            dst.ctypes.data, None if tags is None else tags.ctypes.data,
            zero.ctypes.data, len(zero), verdict or None, upload or None,
            host_verdict or None, _stream(pool), ctypes.addressof(launched))
    _count(counter, launched.value)
    if rc == _BAD_INDEX:
        raise IndexError(f"{name}: index out of range for {pool.shape[0]} rows "
                         f"(or a tag outside uint32)")
    _check_rc(lib, rc, name)
    if host_verdict:
        _count_transfer("verdict_wait")


def _on_device(device: torch.device):
    """The device's context, entered only where it is not already the
    current one (entering costs the hot path microseconds)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _verified_operands(name: str, pool: torch.Tensor, dst, tags, zero):
    """The host vectors of a verified scatter on the CPU, checked as the
    C entry point checks them on the card."""
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    _host_index(name, dst[dst >= 0], pool.shape[0])
    if (dst < -1).any():
        raise IndexError(f"{name}: destination below -1")
    tags = (np.full(len(dst), -1, np.int64) if tags is None
            else np.asarray(tags, dtype=np.int64).reshape(-1))
    if len(tags) != len(dst) or (tags < -1).any() or (tags >= 2 ** 32).any():
        raise ValueError(f"{name}: tags must be {len(dst)} uint32 values or -1")
    zero = _host_index(name, _NO_ROWS if zero is None else zero, pool.shape[0])
    return dst, tags, zero


def scatter_verified_rows_(pool: torch.Tensor, stage: torch.Tensor, dst,
                           tags=None, zero=None) -> int:
    """The swap-in's verified write: staged rows ``stage`` (R, elems),
    each with a pool row (``dst``, -1: verify only) and an expected
    Fletcher tag (``tags``, -1: none), and pool rows to zero. Writes the
    pool only if every tag matches; returns -1 then, else the first
    staged row whose tag differs (bit for bit
    :func:`.ref.scatter_verified_blocks_`). On the card: one launch and
    one wait for the 4-byte verdict (:func:`scatter_staged_rows_` does the
    same from a staging buffer, with the upload in the same call)."""
    name = "scatter_verified_rows_"
    _check_rows(name, pool)
    _check_rows(name, stage)
    cuda = _on_cuda(name, pool, stage)
    if stage.shape[1] != pool.shape[1] or stage.dtype != pool.dtype:
        raise ValueError(f"{name}: staged rows {tuple(stage.shape)} "
                         f"{stage.dtype} do not fit {tuple(pool.shape)} "
                         f"{pool.dtype}")
    if not cuda:
        dst, tags, zero = _verified_operands(name, pool, dst, tags, zero)
        if len(dst) != stage.shape[0]:
            raise ValueError(f"{name}: {len(dst)} destinations for "
                             f"{stage.shape[0]} rows")
        return ref.scatter_verified_blocks_(
            pool, stage, torch.from_numpy(dst), torch.from_numpy(tags),
            torch.from_numpy(zero))
    verdict = torch.empty(1, dtype=torch.int32, device=pool.device)
    host = torch.empty(1, dtype=torch.int32, pin_memory=True)
    _launch_scatter(name, "scatter_verified", pool, stage.data_ptr(),
                    stage.shape[0], dst, tags, zero, verdict=verdict.data_ptr(),
                    host_verdict=host.data_ptr())
    return int(host[0])


def scatter_staged_rows_(pool: torch.Tensor, host: torch.Tensor,
                         dev: "torch.Tensor | None", n: int, dst, tags=None,
                         zero=None, *, verify: bool = True) -> int:
    """The swap-in's write of one chunk from a staging pair: ``host`` is a
    flat uint8 buffer whose head holds ``n`` staged rows of
    ``pool.shape[1]`` bytes (pinned where the pool is on the card), ``dev``
    a flat uint8 buffer on the pool's device at least as large (None on
    the CPU). With ``verify``, as :func:`scatter_verified_rows_`, the
    verdict passing through the 16 bytes after the rows (rounded up to 16)
    of both buffers: on the card one call uploads the rows, launches the
    verified scatter, copies the verdict back and waits -- one host wait.
    Without it the plain scatter (no tags, no zero rows, no wait; the
    caller keeps ``host`` until the upload has run)."""
    name = "scatter_staged_rows_"
    _check_rows(name, pool)
    elems = pool.shape[1]
    voff = -(-n * elems // 16) * 16
    need = voff + 16 if verify else n * elems
    if (host.dim() != 1 or host.dtype != torch.uint8 or host.numel() < need
            or not host.is_contiguous()):
        raise ValueError(f"{name}: the host buffer must be a contiguous flat "
                         f"uint8 tensor of at least {need} bytes")
    if not verify and (tags is not None or zero is not None):
        raise ValueError(f"{name}: the plain scatter takes no tags or zero rows")
    if pool.device.type == "cpu":
        rows = host[:n * elems].view(n, elems)
        if verify:
            return scatter_verified_rows_(pool, rows, dst, tags, zero)
        scatter_rows_(pool, dst, rows)
        return -1
    if not (host.is_pinned() and dev is not None and dev.device == pool.device
            and dev.dtype == torch.uint8 and dev.numel() >= need):
        raise ValueError(f"{name}: needs a pinned host buffer and a uint8 "
                         f"buffer of at least {need} bytes on {pool.device}")
    if pool.dtype != torch.uint8:
        raise TypeError(f"{name}: the CUDA kernel takes uint8 rows, got {pool.dtype}")
    if verify:
        _launch_scatter(name, "scatter_verified", pool, dev.data_ptr(), n, dst,
                        tags, zero, verdict=dev.data_ptr() + voff,
                        upload=host.data_ptr(), host_verdict=host.data_ptr() + voff)
        return int(host.numpy()[voff:voff + 4].view(np.int32)[0])
    _launch_scatter(name, "scatter", pool, dev.data_ptr(), n, dst,
                    upload=host.data_ptr())
    return -1


def launch_scatter_verified(pool: torch.Tensor, stage: torch.Tensor,
                            dst: np.ndarray, tags: np.ndarray,
                            zero: np.ndarray, verdict: torch.Tensor) -> None:
    """One verified scatter on checked device operands, without a wait:
    ``verdict``, one device int32, holds -1 (ok) or the first bad staged
    row once it has run."""
    _launch_scatter("scatter_verified_rows_", "scatter_verified", pool,
                    stage.data_ptr(), stage.shape[0], dst, tags, zero,
                    verdict=verdict.data_ptr())


def zero_rows(blocks: torch.Tensor) -> torch.Tensor:
    """(n, elems) rows -> (n,) bool on the same device, True where the
    row is all zero."""
    _check_rows("zero_rows", blocks)
    cuda = _on_cuda("zero_rows", blocks)
    if not cuda:
        return ref.zero_detect(blocks)
    out = torch.empty(blocks.shape[0], dtype=torch.bool, device=blocks.device)
    if blocks.shape[0]:
        launch_zero(blocks, out)
    return out


def launch_zero(blocks: torch.Tensor, out: torch.Tensor) -> None:
    _launch_pass("zero_rows", _FLAGS, blocks, None, blocks.shape[0], zero=out)
    _count("zero")


def fletcher_rows(blocks: torch.Tensor) -> torch.Tensor:
    """(n, elems) rows -> (n,) uint32 Fletcher tags on the same device."""
    _check_rows("fletcher_rows", blocks)
    cuda = _on_cuda("fletcher_rows", blocks)
    if not cuda:
        return ref.fletcher_checksum(blocks)
    out = torch.empty(blocks.shape[0], dtype=torch.uint32,
                      device=blocks.device)
    if blocks.shape[0]:
        launch_fletcher(blocks, out)
    return out


def launch_fletcher(blocks: torch.Tensor, out: torch.Tensor) -> None:
    lib = _build.load()
    with torch.cuda.device(blocks.device):
        rc = lib.swap_fletcher_rows(blocks.data_ptr(), out.data_ptr(),
                                    blocks.shape[0], blocks.shape[1],
                                    _stream(blocks))
    _check_rc(lib, rc, "fletcher_rows")
    _count("fletcher")


# ---------------------------------------------------------- paged attention
# dtype codes of csrc/paged_attention.cu and csrc/quantize.cu, and the
# (q, pool) pairs paged attention takes
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
ATTN_DTYPE_PAIRS = frozenset({(torch.bfloat16, torch.bfloat16),
                              (torch.float32, torch.bfloat16),
                              (torch.float32, torch.float32),
                              (torch.float16, torch.float16)})
_ATTN_CHUNK = 64                # positions per split, as kChunk in the source


def attn_splits(mbs: int, bt: int) -> int:
    """Splits (work items per sequence and KV head) that cover a table
    of ``mbs`` blocks of ``bt`` tokens; sizes the workspace."""
    return -(-mbs * bt // _ATTN_CHUNK)


def _check_table_host(block_table: torch.Tensor, kv_len: torch.Tensor,
                      n_blocks: int, bt: int,
                      name: str = "paged_decode_attention") -> None:
    """The entries a sequence reads (context blocks below
    ``ceil(kv_len / bt)``) must name a pool block; CPU tensors only."""
    mbs = block_table.shape[1]
    used = (torch.arange(mbs)[None, :] * bt) < kv_len.to(torch.int64)[:, None]
    bad = used & ((block_table < 0) | (block_table >= n_blocks))
    if bool(bad.any()):
        b, j = (int(x) for x in bad.nonzero()[0])
        raise IndexError(
            f"{name}: block_table[{b}, {j}] = "
            f"{int(block_table[b, j])} is outside the pool's {n_blocks} blocks")


def paged_decode_attention(q: torch.Tensor, kv_pool: torch.Tensor,
                           block_table: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """GQA decode attention through a block table.

    q: (B, H, hd); kv_pool: (n_blocks, bt, 2, KV, hd); block_table:
    (B, mbs) int32; kv_len: (B,) int32 -> (B, H, hd) in q's dtype. Query
    heads group KV-major (``q[b].reshape(KV, H // KV, hd)``); positions
    at or past ``kv_len[b]`` are left out, and ``kv_len == 0`` gives
    zeros. On CUDA tensors the (q, pool) dtypes must be one of
    ``ATTN_DTYPE_PAIRS``; a head size or a query-head group the kernel
    does not take fails the launch with ``RuntimeError``.
    """
    name = "paged_decode_attention"
    if q.dim() != 3 or kv_pool.dim() != 5 or kv_pool.shape[2] != 2:
        raise ValueError(f"{name}: expects q (B, H, hd) and pool (n_blocks, "
                         f"bt, 2, KV, hd), got {tuple(q.shape)} and "
                         f"{tuple(kv_pool.shape)}")
    B, H, hd = q.shape
    n_blocks, bt, _, KV, hd_pool = kv_pool.shape
    if hd_pool != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: pool {tuple(kv_pool.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(kv_len.shape) != (B,):
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} and "
                         f"kv_len {tuple(kv_len.shape)} do not fit batch {B}")
    if block_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and kv_len must be int32, got "
                        f"{block_table.dtype} and {kv_len.dtype}")
    for t in (q, kv_pool, block_table, kv_len):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if all(t.device.type == "meta" for t in (q, kv_pool, block_table, kv_len)):
        # shapes only (the dry run): a meta table holds no entries to
        # check, and no length, so the cost is at every table entry used
        flops, nbytes = paged_attn_cost(q, kv_pool, block_table,
                                        block_table.shape[1] * bt)
        for sink in meta_cost_sinks:
            sink("paged_attn_kernel", flops, nbytes)
        return torch.empty_like(q)
    if not _on_cuda(name, q, kv_pool, block_table, kv_len):
        _check_table_host(block_table, kv_len, n_blocks, bt)
        return ref.paged_decode_attention(q, kv_pool, block_table, kv_len)
    if (q.dtype, kv_pool.dtype) not in ATTN_DTYPE_PAIRS:
        raise TypeError(f"{name}: the CUDA kernel takes (q, pool) dtypes "
                        f"{sorted((str(a), str(b)) for a, b in ATTN_DTYPE_PAIRS)}, "
                        f"got ({q.dtype}, {kv_pool.dtype})")
    out = torch.empty_like(q)
    launch_paged_attn(q, kv_pool, block_table, kv_len, out)
    return out


def paged_attn_cost(q: torch.Tensor, kv_pool: torch.Tensor,
                    block_table: torch.Tensor, kv_rows: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one paged-attention launch whose sequences each
    read ``kv_rows`` positions: q, those K and V rows, the table and
    ``kv_len`` read once and the output written once; q.K and p.V take 4
    FLOPs per K/V element and query head."""
    B, H, hd = q.shape
    KV = kv_pool.shape[3]
    kv_bytes = B * kv_rows * 2 * KV * hd * kv_pool.element_size()
    io_bytes = (2 * q.numel() * q.element_size()
                + block_table.numel() * block_table.element_size() + B * 4)
    return 4 * B * H * kv_rows * hd, kv_bytes + io_bytes


def launch_paged_attn(q: torch.Tensor, kv_pool: torch.Tensor,
                      block_table: torch.Tensor, kv_len: torch.Tensor,
                      out: torch.Tensor) -> None:
    """One paged-attention launch on already-checked device operands:
    one kernel whose splits leave their partials in an f32 workspace of
    ``B * H * n_split * (hd + 2)`` elements, the last split of each
    (sequence, KV head) merging them."""
    lib = _build.load()
    B, H, hd = q.shape
    n_blocks, bt, _, KV, _ = kv_pool.shape
    mbs = block_table.shape[1]
    n_split = attn_splits(mbs, bt)
    ws = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.paged_attn_decode(
            q.data_ptr(), kv_pool.data_ptr(), block_table.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, KV, hd,
            bt, mbs, n_blocks, n_split, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[kv_pool.dtype], hd ** -0.5, _stream(q))
    if rc:      # the source decides which head sizes and groups it takes
        _check_rc(lib, rc, f"paged_decode_attention (H {H}, KV {KV}, hd "
                           f"{hd}, table {mbs} x {bt})")
    _count("paged_attn")


# ----------------------------------------------------- paged latent attention
# the one shape csrc/paged_mla.cu takes, DeepSeek-V2's: 16 query heads, a
# 576-wide latent row whose first 512 values are also the value; its
# dtypes (q and pool alike); and the positions of one split, as kSpan in
# the source
MLA_SHAPE = (16, 576, 512)
MLA_DTYPES = frozenset({torch.bfloat16, torch.float32})
_MLA_SPAN = 256


def mla_splits(mbs: int, bt: int) -> int:
    """Splits per sequence that cover a table of ``mbs`` blocks of ``bt``
    tokens; sizes the grid and the workspace."""
    return -(-mbs * bt // _MLA_SPAN)


def paged_mla_decode(q: torch.Tensor, latent_pool: torch.Tensor,
                     block_table: torch.Tensor, kv_len: torch.Tensor,
                     kv_rank: int, scale: float) -> torch.Tensor:
    """Latent (MLA) decode attention through a block table, absorbed form.

    q: (B, H, W), each head ``[q_lat | q_pe]``; latent_pool: (n_blocks,
    bt, W), each token's ``[c | k_pe]``; block_table: (B, mbs) int32;
    kv_len: (B,) int32 -> (B, H, kv_rank) in q's dtype: per head
    ``softmax(q . rows * scale) @ rows[:, :kv_rank]`` over the positions
    below ``kv_len[b]`` (zeros where it is 0). On CUDA tensors q and the
    pool are both bfloat16 or both float32, and (H, W, kv_rank) must be
    :data:`MLA_SHAPE`.
    """
    name = "paged_mla_decode"
    if q.dim() != 3 or latent_pool.dim() != 3 or latent_pool.shape[2] != q.shape[2] \
            or not 0 < kv_rank <= q.shape[2]:
        raise ValueError(f"{name}: expects q (B, H, W), pool (n_blocks, bt, W) "
                         f"and 0 < kv_rank <= W, got {tuple(q.shape)}, "
                         f"{tuple(latent_pool.shape)} and {kv_rank}")
    B, H, W = q.shape
    n_blocks, bt, _ = latent_pool.shape
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(kv_len.shape) != (B,):
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} and "
                         f"kv_len {tuple(kv_len.shape)} do not fit batch {B}")
    if block_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and kv_len must be int32, got "
                        f"{block_table.dtype} and {kv_len.dtype}")
    for t in (q, latent_pool, block_table, kv_len):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    out_shape = (B, H, kv_rank)
    if all(t.device.type == "meta" for t in (q, latent_pool, block_table, kv_len)):
        # shapes only (the dry run): every table entry used
        flops, nbytes = paged_mla_cost(q, latent_pool, block_table,
                                       block_table.shape[1] * bt, kv_rank)
        for sink in meta_cost_sinks:
            sink("paged_mla_kernel", flops, nbytes)
        return q.new_empty(out_shape)
    if not _on_cuda(name, q, latent_pool, block_table, kv_len):
        _check_table_host(block_table, kv_len, n_blocks, bt, name)
        return ref.paged_mla_decode(q, latent_pool, block_table, kv_len,
                                    kv_rank, scale)
    if q.dtype != latent_pool.dtype or q.dtype not in MLA_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes q and pool both bfloat16 "
                        f"or both float32, got {q.dtype} and {latent_pool.dtype}")
    if (H, W, kv_rank) != MLA_SHAPE:
        raise ValueError(f"{name}: the CUDA kernel takes (heads, width, rank) "
                         f"{MLA_SHAPE}, got {(H, W, kv_rank)}")
    out = q.new_empty(out_shape)
    launch_paged_mla(q, latent_pool, block_table, kv_len, out, scale)
    return out


def paged_mla_cost(q: torch.Tensor, latent_pool: torch.Tensor,
                   block_table: torch.Tensor, kv_rows: int,
                   kv_rank: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one paged MLA launch whose sequences each read
    ``kv_rows`` positions: those latent rows, q, the table and ``kv_len``
    read once and the output written once; per row and head 2 FLOPs per
    multiply-add of the score (W wide) and of the value (kv_rank wide)."""
    B, H, W = q.shape
    rows = B * kv_rows
    io_bytes = ((q.numel() + B * H * kv_rank) * q.element_size()
                + block_table.numel() * block_table.element_size() + B * 4)
    return 2 * rows * H * (W + kv_rank), rows * W * latent_pool.element_size() + io_bytes


def launch_paged_mla(q: torch.Tensor, latent_pool: torch.Tensor,
                     block_table: torch.Tensor, kv_len: torch.Tensor,
                     out: torch.Tensor, scale: float) -> None:
    """One paged MLA call on already-checked device operands: a split
    kernel whose splits leave their partials in an f32 workspace of
    ``B * n_split * H * (kv_rank + 2)`` elements, then a merge kernel."""
    lib = _build.load()
    B, H, W = q.shape
    R = out.shape[2]
    n_blocks, bt, _ = latent_pool.shape
    mbs = block_table.shape[1]
    n_split = mla_splits(mbs, bt)
    ws = torch.empty(B * n_split * H * (R + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.paged_mla_decode(
            q.data_ptr(), latent_pool.data_ptr(), block_table.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, W, R, bt,
            mbs, n_blocks, n_split, _DTYPE_CODES[q.dtype], scale, _stream(q))
    if rc:
        _check_rc(lib, rc, f"paged_mla_decode (B {B}, table {mbs} x {bt})")
    _count("paged_mla")


# ------------------------------------------------------- int8 quantization


def block_quantize(blocks: torch.Tensor, mps_per_block: int):
    """Per-MP symmetric int8 quantization: (n, elems) f32/f16/bf16 ->
    ``(q (n, elems) int8, scales (n, mps_per_block) f32)``, bit for bit
    :func:`.ref.block_quantize`."""
    name = "block_quantize"
    if blocks.dim() != 2:
        raise ValueError(f"{name}: expects (n, elems), got {tuple(blocks.shape)}")
    n, elems = blocks.shape
    if mps_per_block < 1 or elems == 0 or elems % mps_per_block:
        raise ValueError(f"{name}: {elems} elements do not split into "
                         f"{mps_per_block} equal MPs")
    if blocks.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: takes float32, float16 or bfloat16 "
                         f"blocks, got {blocks.dtype}")
    if not blocks.is_contiguous():
        raise ValueError(f"{name}: blocks must be contiguous")
    if not _on_cuda(name, blocks):
        return ref.block_quantize(blocks, mps_per_block)
    q = torch.empty((n, elems), dtype=torch.int8, device=blocks.device)
    scales = torch.empty((n, mps_per_block), dtype=torch.float32,
                         device=blocks.device)
    if n:
        launch_quantize(blocks, q, scales)
    return q, scales


def launch_quantize(blocks: torch.Tensor, q: torch.Tensor,
                    scales: torch.Tensor) -> None:
    """One quantize launch on already-checked device operands: one
    thread block cluster per MP of ``blocks.numel() // scales.numel()``
    elements."""
    lib = _build.load()
    with torch.cuda.device(blocks.device):
        rc = lib.quant_block_quantize(
            blocks.data_ptr(), q.data_ptr(), scales.data_ptr(), scales.numel(),
            blocks.numel() // scales.numel(), _DTYPE_CODES[blocks.dtype],
            _stream(blocks))
    _check_rc(lib, rc, "block_quantize")
    _count("quantize")


def block_dequantize(q: torch.Tensor, scales: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`block_quantize`: (n, elems) int8 and (n, mps) f32
    scales -> (n, elems) ``out_dtype`` (f32, f16 or bf16), bit for bit
    :func:`.ref.block_dequantize`."""
    name = "block_dequantize"
    if q.dim() != 2 or scales.dim() != 2 or scales.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: expects q (n, elems) and scales (n, mps), "
                         f"got {tuple(q.shape)} and {tuple(scales.shape)}")
    n, elems = q.shape
    mps = scales.shape[1]
    if mps < 1 or elems == 0 or elems % mps:
        raise ValueError(f"{name}: {elems} elements do not split into {mps} "
                         f"equal MPs")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{name}: takes int8 q and float32 scales, got "
                         f"{q.dtype} and {scales.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: out_dtype must be float32, float16 or "
                         f"bfloat16, got {out_dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if not _on_cuda(name, q, scales):
        return ref.block_dequantize(q, scales, out_dtype)
    out = torch.empty((n, elems), dtype=out_dtype, device=q.device)
    if n:
        launch_dequantize(q, scales, out)
    return out


def launch_dequantize(q: torch.Tensor, scales: torch.Tensor,
                      out: torch.Tensor) -> None:
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.quant_block_dequantize(
            q.data_ptr(), scales.data_ptr(), out.data_ptr(), scales.numel(),
            q.numel() // scales.numel(), _DTYPE_CODES[out.dtype],
            _stream(q))
    _check_rc(lib, rc, "block_dequantize")
    _count("dequantize")


__all__ = ["launches", "transfers", "reset_launches", "copy_to_host",
           "gather_rows", "gather_nonzero_rows", "scatter_rows_",
           "scatter_verified_rows_", "zero_rows", "fletcher_rows",
           "launch_gather", "launch_gather_nonzero", "launch_scatter",
           "launch_scatter_verified", "scatter_staged_rows_",
           "launch_zero", "launch_fletcher", "paged_decode_attention",
           "launch_paged_attn", "ATTN_DTYPE_PAIRS", "attn_splits",
           "paged_mla_decode", "launch_paged_mla", "paged_mla_cost",
           "MLA_SHAPE", "MLA_DTYPES", "mla_splits",
           "block_quantize", "launch_quantize", "block_dequantize",
           "launch_dequantize"]
