"""AdamW with dtype-configurable state + global-norm clipping + schedule.

A copy of ``repro/optim/adamw.py`` as plain functions over the model's
parameters in a fixed order (``model.parameters()``): the clip scale,
``b1 ** t`` and ``b2 ** t`` with ``t`` in f32, ``p - lr * (upd + wd *
p)`` in f32, the moments stored in ``state_dtype``. Not
``torch.optim.AdamW``, which orders the decay differently. ``update``
writes the parameters and the moments in place where the reference
returns new trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Sequence

import torch


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init(params: Sequence[torch.Tensor], cfg: AdamWConfig) -> AdamWState:
    dt = _dtype(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return AdamWState(mu=[zeros(p) for p in params],
                      nu=[zeros(p) for p in params])


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(step: int, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` as an f32 scalar (on the host)."""
    s = _f32(step)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((_f32(step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tensors)
    return torch.sqrt(sq)


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state: AdamWState,
           params: Sequence[torch.Tensor], step: int,
           cfg: AdamWConfig) -> Dict[str, torch.Tensor]:
    """One AdamW step: ``params`` and ``state`` are written in place;
    returns ``grad_norm`` (before clipping) and ``lr``."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    lr = schedule(step, cfg)
    t = _f32(step + 1)
    c1 = 1.0 - torch.pow(_f32(cfg.b1), t)
    c2 = 1.0 - torch.pow(_f32(cfg.b2), t)
    sdt = _dtype(cfg.state_dtype)
    dev = params[0].device if params else None
    lr_d, c1_d, c2_d = (x.to(dev) for x in (lr, c1, c2))

    for g, m, v, p in zip(grads, state.mu, state.nu, params):
        g32 = g.float() * scale
        m32 = m.float() * cfg.b1 + g32 * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(g32) * (1 - cfg.b2)
        del g32
        upd = (m32 / c1_d) / (torch.sqrt(v32 / c2_d) + cfg.eps)
        m.copy_(m32.to(sdt))
        v.copy_(v32.to(sdt))
        del m32, v32
        p32 = p.float()
        p.copy_((p32 - lr_d * (upd + cfg.weight_decay * p32)).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
