"""Benchmarks of the port (``python -m repro_torch.benchmarks.<name>``).

  fleet -- the fleet control plane: the paper trace, the chaos trace and
           the captured serving workloads, each replayed twice
"""
