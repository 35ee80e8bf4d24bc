"""Build and load the swap kernels' shared library (``csrc/swap_kernels.cu``).

The source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
plain-C shared library and loaded with :mod:`ctypes`; nothing includes
PyTorch's headers, so a build takes seconds. The library lands in
``build/repro_torch/`` at the root of the checkout under a name keyed by
a hash of the source and the flags, so an edit rebuilds it and an
unchanged tree reuses it.

Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from ..analysis.lock_order import named_lock

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "swap_kernels.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
# entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "swap_gather_rows": (_VP, _VP, _VP, _I64, _I64, _VP),
    "swap_scatter_rows": (_VP, _VP, _VP, _I64, _I64, _VP),
    "swap_zero_rows": (_VP, _VP, _I64, _I64, _VP),
    "swap_fletcher_rows": (_VP, _VP, _I64, _I64, _VP),
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
            "nvcc not found (PATH, $CUDA_HOME/bin): the swap kernels are "
            "built from source on first use on a CUDA machine")
    return str(path)


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libswap_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless a build of this exact source exists.
    Returns its path. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
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
