"""Runnable flows of the port (``python -m repro_torch.examples.<name>``).

  elastic_serving      -- more live sequences than physical KV capacity,
                          the swap engine hot-upgraded v1 -> v2 under load
  quickstart           -- train a ~100M decoder with checkpoint/resume
  elastic_moe_training -- train deepseek-moe with its experts mirrored in
                          an expert cache with room for half of them
"""
