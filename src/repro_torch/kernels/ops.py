"""Wrappers of the four swap data-path kernels.

Each wrapper checks device, dtype, shape and contiguity, then dispatches
on where its tensors live:

* on a CUDA device it launches the hand-written Hopper kernel from
  ``csrc/swap_kernels.cu`` on the current stream and bumps
  ``launches[name]`` -- there is no fallback: a kernel that does not
  build or launch raises;
* on the CPU it runs the plain version in :mod:`.ref`, and counts
  nothing.

Index vectors come from the host bitmaps (numpy); the wrappers check
them against the pool on the host and copy them to the device once per
call.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..analysis.lock_order import named_lock
from . import _build, ref

# launches of each kernel since the last reset; plain integers, bumped
# only where a kernel is launched. hv_sched threads launch too, so every
# bump and reset holds the lock (a bare += can lose an increment)
launches: Dict[str, int] = {"gather": 0, "scatter": 0, "zero": 0,
                            "fletcher": 0}
_count_lock = named_lock("metrics")


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


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
    return torch.from_numpy(np.ascontiguousarray(idx)).to(device)


# ------------------------------------------------------------------ kernels
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
        launch_gather(pool, _dev_index(idx, pool.device), out)
    return out


def launch_gather(pool: torch.Tensor, idx_dev: torch.Tensor,
                  out: torch.Tensor) -> None:
    """One gather launch on already-checked device operands (int64
    indices in range, contiguous uint8 rows)."""
    lib = _build.load()
    with torch.cuda.device(pool.device):
        rc = lib.swap_gather_rows(pool.data_ptr(), idx_dev.data_ptr(),
                                  out.data_ptr(), out.shape[0], out.shape[1],
                                  _stream(pool))
    _check_rc(lib, rc, "gather_rows")
    _count("gather")


def scatter_rows_(pool: torch.Tensor, idx, blocks: torch.Tensor) -> None:
    """``pool[idx[i]] = blocks[i]`` in place; rows not in ``idx`` are
    never touched. Duplicate indices give an undefined result."""
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
        launch_scatter(pool, _dev_index(idx, pool.device), blocks)


def launch_scatter(pool: torch.Tensor, idx_dev: torch.Tensor,
                   blocks: torch.Tensor) -> None:
    lib = _build.load()
    with torch.cuda.device(pool.device):
        rc = lib.swap_scatter_rows(pool.data_ptr(), idx_dev.data_ptr(),
                                   blocks.data_ptr(), blocks.shape[0],
                                   blocks.shape[1], _stream(pool))
    _check_rc(lib, rc, "scatter_rows_")
    _count("scatter")


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
    lib = _build.load()
    with torch.cuda.device(blocks.device):
        rc = lib.swap_zero_rows(blocks.data_ptr(), out.data_ptr(),
                                blocks.shape[0], blocks.shape[1],
                                _stream(blocks))
    _check_rc(lib, rc, "zero_rows")
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


__all__ = ["launches", "reset_launches", "gather_rows", "scatter_rows_",
           "zero_rows", "fletcher_rows", "launch_gather", "launch_scatter",
           "launch_zero", "launch_fletcher"]
