"""Reduced same-family configs for CPU smoke tests.

Every reduction keeps the arch's distinguishing features (GQA ratio,
qk-norm, QKV bias, shared+routed fine-grained MoE, 7:1 hybrid interleave,
M-RoPE sections, encoder-onlyness) while shrinking width/depth/vocab so a
forward + train step runs in seconds on one CPU device.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig, MambaConfig, MoEConfig

from . import get_config


def reduced_config(arch_id: str) -> ArchConfig:
    full = get_config(arch_id)
    r = {
        "vocab": 512,
        "d_model": 128,
        "attn_chunk_q": 32,
        "attn_chunk_kv": 64,
        "kv_block_tokens": 8,
        "param_dtype": "float32",
        "compute_dtype": "float32",
        "opt_dtype": "float32",
    }
    if full.family == "hybrid":
        r.update(n_layers=8, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                 moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=256,
                               n_shared=0, freq=2),
                 mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16))
    elif full.family == "ssm":
        r.update(n_layers=4, n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
                 mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16))
    elif full.family == "moe":
        m = full.moe
        r.update(n_layers=3, n_heads=4,
                 n_kv_heads=4 if full.n_kv_heads == full.n_heads else 2,
                 head_dim=32, d_ff=256,
                 moe=MoEConfig(n_routed=8, top_k=min(m.top_k, 4),
                               d_ff_expert=64, n_shared=m.n_shared,
                               freq=m.freq, first=m.first))
    else:  # dense / audio / vlm
        r.update(n_layers=3, n_heads=4,
                 n_kv_heads=1 if full.n_kv_heads == 1 else 2,
                 head_dim=32, d_ff=256)
        if full.family == "audio":
            r.update(frontend_dim=32, vocab=64)
        if full.family == "vlm":
            r.update(mrope_sections=(4, 6, 6), max_vision_tokens=8)
    return dataclasses.replace(full, **r)
