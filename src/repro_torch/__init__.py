"""PyTorch/CUDA port of the Taiji reproduction.

Mirrors ``repro``'s layout (``core``, ``kernels``, ``analysis``,
``obs``, ``models``, ``optim``, ``data``, ``checkpoint``, ``train``,
``launch``, ``fleet``, ``benchmarks``) and runs Taiji's swap data path
with guest frames held in a torch tensor on an explicit device: the
H100's HBM by default, the CPU when a caller asks for it. Imports ``torch`` and ``numpy``; never
``jax`` and nothing of ``repro``.
"""
