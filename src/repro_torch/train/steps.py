"""Train / prefill / decode step functions over a TrainState.

As ``repro/train/steps.py``: ``train_step`` runs the loss, its backward
and one AdamW update and returns the reference's metrics (``loss``,
``ce``, ``aux``, ``grad_norm``, ``lr``). The state is updated in place
(the model's parameters and the moments) and returned with its step
advanced.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.virt import resolve_device
from ..models import model as M
from ..models.config import ArchConfig
from ..optim import adamw


@dataclasses.dataclass
class TrainState:
    step: int
    model: M.Model
    opt: adamw.AdamWState


def to_device(batch: Mapping[str, np.ndarray], device) -> M.Batch:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def init_train_state(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                     seed: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Fresh parameters (``M.init_params``) and zero moments; ``device``
    ``None`` means the card."""
    model = M.init_params(cfg, seed=seed, generator=generator,
                          device=resolve_device(device))
    return TrainState(step=0, model=model,
                      opt=adamw.init(list(model.parameters()), opt_cfg))


def train_step(state: TrainState, batch: M.Batch, cfg: ArchConfig,
               opt_cfg: adamw.AdamWConfig
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    params = list(state.model.parameters())
    for p in params:
        p.grad = None
    loss, metrics = M.loss_fn(state.model, cfg, batch)
    loss.backward()
    # a parameter the loss does not reach (the audio family's ``embed``)
    # has a zero gradient, as in the reference
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    opt_metrics = adamw.update(grads, state.opt, params, state.step, opt_cfg)
    for p in params:
        p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(opt_metrics)
    metrics["loss"] = loss.detach()
    return TrainState(state.step + 1, state.model, state.opt), metrics


def prefill_step(params: M.Model, batch: M.Batch, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward -> (last-token logits (B,V), aux)."""
    return M.prefill(params, cfg, batch)


def serve_step(params: M.Model, tokens: torch.Tensor, cache: M.Cache,
               cfg: ArchConfig, mrope_pos: Optional[torch.Tensor] = None,
               input_embeds: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, M.Cache]:
    """One decode step: new token for every sequence against its KV and
    SSM state; ``input_embeds`` (B, D) in place of the tokens' embedding
    (a vision prefix), beyond the reference's arguments."""
    return M.decode_step(params, cfg, tokens, cache, mrope_pos, input_embeds)
