"""Step functions over the port's model.

Only the serving step is ported; ``TrainState``, ``train_step`` and
``prefill_step`` come with the training slice (ROADMAP.md, Queue A).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models import model as M
from ..models.config import ArchConfig


def serve_step(params: M.Model, tokens: torch.Tensor, cache: M.Cache,
               cfg: ArchConfig) -> Tuple[torch.Tensor, M.Cache]:
    """One decode step: new token for every sequence against its KV."""
    return M.decode_step(params, cfg, tokens, cache)
