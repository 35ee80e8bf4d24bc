"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the wrappers that pick between them.

  ops      -- wrappers: CUDA tensors launch the kernel (and count the
              launch), CPU tensors run the plain version
  ref      -- plain PyTorch versions, operation for operation the
              reference's oracles in repro/kernels/ref.py
  _build   -- nvcc build + ctypes load of csrc/*.cu

  gather_rows    -- row gather      (repro/kernels/swap_copy.py:gather_blocks)
  zero_rows      -- zero-page scan  (repro/kernels/zero_detect.py:zero_detect)
  gather_nonzero_rows -- the swap-out's chunk read: both of the above in
                 one pass that hands back only the non-zero rows
  scatter_verified_rows_ -- the swap-in's write: staged rows' tags
                 checked and the frame written (or not) in one launch
                 (repro/kernels/swap_copy.py:scatter_blocks, and the
                 swap-in's use of crc32c.py:fletcher_checksum)
  scatter_rows_  -- its plain mode, the fault path's copy
  fletcher_rows  -- extent-row tags (repro/kernels/crc32c.py:fletcher_checksum)
  paged_decode_attention -- decode attention through the block table
                 (repro/kernels/paged_attention.py:paged_decode_attention)
  paged_mla_decode -- latent (MLA) decode attention through the block
                 table (no Pallas kernel: the reference has no MLA)
  block_quantize / block_dequantize -- per-MP int8 (de)quantization
                 (repro/kernels/compress.py, on no path of either package)
"""
from . import ops, ref  # noqa: F401
