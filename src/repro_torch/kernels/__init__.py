"""Hand-written Hopper kernels of the swap data path, their plain
PyTorch versions and the wrappers that pick between them.

  ops      -- wrappers: CUDA tensors launch the kernel (and count the
              launch), CPU tensors run the plain version
  ref      -- plain PyTorch versions, operation for operation the
              reference's oracles in repro/kernels/ref.py
  _build   -- nvcc build + ctypes load of csrc/swap_kernels.cu

  gather_rows    -- swap-out copy   (repro/kernels/swap_copy.py:gather_blocks)
  scatter_rows_  -- swap-in copy    (repro/kernels/swap_copy.py:scatter_blocks)
  zero_rows      -- zero-page scan  (repro/kernels/zero_detect.py:zero_detect)
  fletcher_rows  -- extent-row tags (repro/kernels/crc32c.py:fletcher_checksum)
"""
from . import ops, ref  # noqa: F401
