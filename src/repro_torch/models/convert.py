"""Carry parameters and training state across from the reference.

``params_from_numpy`` takes the reference's ``init_params`` tree with its
leaves as numpy arrays -- layer leaves stacked ``(L, ...)`` as the
reference scans them, hybrid leaves ``(G, n, ...)`` or ``(G, ...)``, a
first-dense MoE config's ``layer0`` as its own subtree -- and returns the port's :class:`~.model.Model` with the same
values. ``train_state_from_numpy`` does the same for a whole reference
``TrainState`` (parameters, AdamW moments, step). Converting the
reference's arrays to numpy is the caller's step; nothing here imports
the reference.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch

from .config import ArchConfig
from .model import DTYPES, Model


def _tensor(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # torch wants arrays it may write
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _names(node: Mapping, prefix: str = "") -> Iterator[str]:
    for key, val in node.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            yield from _names(val, path)
        else:
            yield path


def _leaves(tree: Mapping[str, Any], cfg: ArchConfig,
            model: Model) -> Iterator[Tuple[str, torch.nn.Parameter, torch.Tensor]]:
    """(name, port parameter, the tree's leaf for it) in the model's
    parameter order; raises where a shape differs or the tree holds a
    leaf the port has no parameter for.

    A port name's numeric parts index the reference's stacked leaf, in
    order: the layer (or, for the hybrid family, the group) and then the
    mixer or FFN within a group. The reference stacks a leaf over ``n``
    only where ``n > 1`` (``model.py:49``, ``:107``, ``:174``) but always
    stacks norms over layers and hybrid leaves over groups
    (``_stack_over_groups``), so an index applies while the leaf has
    more dimensions than the port's parameter."""
    seen = set()
    for name, p in model.named_parameters():
        src, idx, path = tree, [], []
        for key in name.split("."):
            if key.isdigit():
                idx.append(int(key))
            else:
                src = src[key]
                path.append(key)
        seen.add(".".join(path))
        for i in idx:
            if src.ndim > p.dim():
                src = src[i]
        src = _tensor(src)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name} has shape {tuple(src.shape)}, the port "
                             f"expects {tuple(p.shape)}")
        yield name, p, src
    extra = sorted(set(_names(tree)) - seen)
    if extra:
        raise ValueError(f"leaves the port has no parameter for: {extra}")


def params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                      device) -> Model:
    """The reference's parameter tree (numpy leaves) as a port model on
    ``device``, in ``cfg.param_dtype``. Every parameter of the port must
    be in the tree with the reference's shape; extra leaves raise too."""
    model = Model(cfg, DTYPES[cfg.param_dtype], torch.device(device))
    try:
        with torch.no_grad():
            for _, p, src in _leaves(tree, cfg, model):
                p.copy_(src)
    except ValueError as e:
        raise ValueError(f"params_from_numpy: {e}") from None
    return model


def train_state_from_numpy(params_tree: Mapping[str, Any],
                           mu_tree: Mapping[str, Any],
                           nu_tree: Mapping[str, Any], step: int,
                           cfg: ArchConfig, opt_cfg, device):
    """A reference ``TrainState`` (its params, ``opt.mu``, ``opt.nu``
    trees with numpy leaves, and its step) as the port's
    :class:`~repro_torch.train.steps.TrainState` on ``device``; the
    moments in ``opt_cfg.state_dtype``."""
    from ..optim import adamw
    from ..train.steps import TrainState

    model = params_from_numpy(params_tree, cfg, device)
    sdt = DTYPES[opt_cfg.state_dtype]
    moments = []
    for tree in (mu_tree, nu_tree):
        try:
            moments.append([src.to(device=device, dtype=sdt, copy=True)
                            for _, _, src in _leaves(tree, cfg, model)])
        except ValueError as e:
            raise ValueError(f"train_state_from_numpy: {e}") from None
    return TrainState(step=int(step), model=model,
                      opt=adamw.AdamWState(mu=moments[0], nu=moments[1]))
