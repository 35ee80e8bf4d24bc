"""Build and load the port's kernel library from every source in ``SOURCES``
(``csrc/swap_kernels.cu``, ``csrc/paged_attention.cu``, ``csrc/quantize.cu``,
``csrc/paged_mla.cu``).

On first use each source is compiled with ``nvcc`` for ``sm_90a`` into an
object file -- one ``nvcc`` per source, all started together -- and the
objects are linked into one plain-C shared library, loaded with
:mod:`ctypes`; nothing includes PyTorch's headers, so a build takes
seconds. The library lands in ``build/repro_torch/`` at the root of the
checkout under a name keyed by a hash of every source and the flags, so
an edit rebuilds it and an unchanged tree reuses it.

Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from ..analysis.lock_order import named_lock

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "swap_kernels.cu",
           _PKG / "csrc" / "paged_attention.cu",
           _PKG / "csrc" / "quantize.cu",
           _PKG / "csrc" / "paged_mla.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    # mode, pool, host int32 indices (or NULL), n, elems, out, zero flags,
    # count, stream
    "swap_gather_pass": (_I32, _VP, _VP, _I64, _I64, _VP, _VP, _VP, _VP),
    # pool, pool rows, stage, n, elems, host int64 destinations, tags and
    # zero rows, n_zero, verdict, host upload, host verdict, stream, host
    # int32 launch count
    "swap_scatter_verified": (_VP, _I64, _VP, _I64, _I64, _VP, _VP, _VP, _I64,
                              _VP, _VP, _VP, _VP, _VP),
    "swap_fletcher_rows": (_VP, _VP, _I64, _I64, _VP),
    # q, pool, block_table, kv_len, out, workspace, B, H, KV, hd, bt, mbs,
    # n_blocks, n_split, q dtype, pool dtype, scale, stream
    "paged_attn_decode": (_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64,
                          _I64, _I64, _I64, _I64, _I64, _I32, _I32,
                          ctypes.c_float, _VP),
    # q, pool, block_table, kv_len, out, workspace, B, H, W, R, bt, mbs,
    # n_blocks, n_split, dtype, scale, stream
    "paged_mla_decode": (_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64,
                         _I64, _I64, _I64, _I64, _I32, ctypes.c_float, _VP),
    # x, q, scales, n_mps, mp, dtype, stream
    "quant_block_quantize": (_VP, _VP, _VP, _I64, _I64, _I32, _VP),
    # q, scales, out, n_mps, mp, dtype, stream
    "quant_block_dequantize": (_VP, _VP, _VP, _I64, _I64, _I32, _VP),
}

_lock = named_lock("kernels.build")
_lib: Optional[ctypes.CDLL] = None


# src/repro_torch -> the checkout root
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the kernels are "
            "built from source on first use on a CUDA machine")
    return str(path)


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    """Run one nvcc; its output, headed by its source and wall time."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    what = Path(cmd[-1]).name if "-c" in cmd else "link"
    return (f"nvcc {what}: {time.perf_counter() - t0:.1f} s\n"
            f"{proc.stdout}{proc.stderr}")


def build(verbose: bool = False) -> Path:
    """Compile the library unless a build of this exact source exists.
    Returns its path. ``verbose`` adds ``-Xptxas -v`` and prints each
    nvcc's wall time and the compiler's report (registers, shared
    memory, spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                 "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
    tmp = out.with_name(f"{tag}.so.tmp")
    try:
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            reports = list(pool.map(_run, compiles))
        reports.append(_run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                             *(str(o) for o in objs)]))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(reports), end="")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, building it on first use (thread-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.swap_error_string.argtypes = [ctypes.c_int]
            lib.swap_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
