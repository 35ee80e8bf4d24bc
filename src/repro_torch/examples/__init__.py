"""Runnable flows of the port (``python -m repro_torch.examples.<name>``).

  elastic_serving -- more live sequences than physical KV capacity, the
                     swap engine hot-upgraded v1 -> v2 under load
"""
