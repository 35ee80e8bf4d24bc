"""Carry parameters across from the reference.

``params_from_numpy`` takes the reference's ``init_params`` tree with its
leaves as numpy arrays -- layer leaves stacked ``(L, ...)`` as the
reference scans them -- and returns the port's :class:`~.model.Model`
with the same values. Converting the reference's arrays to numpy is the
caller's step; nothing here imports the reference.
"""
from __future__ import annotations

from typing import Any, Mapping

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


def params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                      device) -> Model:
    """The reference's parameter tree (numpy leaves) as a port model on
    ``device``, in ``cfg.param_dtype``. Every parameter of the port must
    be in the tree with the reference's shape; extra leaves raise too."""
    model = Model(cfg, DTYPES[cfg.param_dtype], torch.device(device))
    layers = tree["layers"]
    stacked = cfg.n_layers > 1     # the reference stacks only when L > 1
    seen = set()

    def leaf(name: str):
        top, *rest = name.split(".")
        if top != "layers":
            seen.add(name)
            return tree[top]
        idx, *path = rest
        node = layers
        for key in path:
            node = node[key]
        seen.add(".".join(["layers", *path]))
        return node[int(idx)] if stacked else node

    with torch.no_grad():
        for name, p in model.named_parameters():
            src = _tensor(leaf(name))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"params_from_numpy: {name} has shape "
                                 f"{tuple(src.shape)}, the port expects "
                                 f"{tuple(p.shape)}")
            p.copy_(src)

    def names(node, prefix):
        for key, val in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                yield from names(val, path)
            else:
                yield path

    extra = sorted(set(names(tree, "")) - seen)
    if extra:
        raise ValueError(f"params_from_numpy: leaves the port has no "
                         f"parameter for: {extra}")
    return model
