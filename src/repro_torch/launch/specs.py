"""Meta-device stand-ins for every model input (no allocation).

As ``repro/launch/specs.py``: ``input_specs(cfg, shape)`` returns the
abstract batch for a cell, ``state_specs`` / ``cache_specs`` the
abstract train state and decode cache. The reference's
``ShapeDtypeStruct`` becomes a tensor on the ``meta`` device: shape and
dtype, no storage, and the port's own step functions trace on it (the
dry run). Token ids, labels and M-RoPE positions are int32, as the
reference's and as the port's data pipeline gives them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs import ShapeSpec
from ..models import model as M
from ..models.config import ArchConfig
from ..optim import adamw
from ..train import steps

META = torch.device("meta")


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    i32, f32 = torch.int32, torch.float32
    if kind == "decode":
        out = {"tokens": _sds((B,), i32)}
        if cfg.mrope_sections is not None:
            out["mrope_pos"] = _sds((3, B, 1), i32)
        return out

    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        out["features"] = _sds((B, S, cfg.frontend_dim), f32)
    else:
        out["tokens"] = _sds((B, S), i32)
    if cfg.family == "vlm":
        out["vision_embeds"] = _sds((B, cfg.max_vision_tokens, cfg.d_model), f32)
        out["mrope_pos"] = _sds((3, B, S), i32)
    if kind == "train":
        out["labels"] = _sds((B, S), i32)
        if cfg.family == "vlm":
            out["loss_mask"] = _sds((B, S), f32)
    return out


def opt_config(cfg: ArchConfig) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(state_dtype=cfg.opt_dtype)


def state_specs(cfg: ArchConfig) -> steps.TrainState:
    return steps.init_train_state(cfg, opt_config(cfg), seed=0, device=META)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    return M.init_cache(cfg, batch, max_seq, device=META)
