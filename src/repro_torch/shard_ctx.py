"""Activation-sharding context.

As ``repro/shard_ctx.py``: a launcher installs an :class:`AxisCtx`
describing the active mesh axes (``ShardingRules.make_axis_ctx``), and
the reference's model applies ``constrain*`` hints at the key activation
cut points (embeddings, per-layer residual stream, attention heads, MoE
dispatch, logits) so XLA's SPMD propagation does not replicate them.

The port runs on one device, where the reference's hints are no-ops
(there, with no context installed), so every helper here returns ``x``
unchanged, with or without a context; the port's model calls none of
them. ``AxisCtx``, ``use`` and ``current`` are the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    batch: Any = None          # axis (or tuple) sharding the batch dim
    tp: Optional[str] = None   # tensor-parallel axis name
    seq: Optional[str] = None  # sequence-parallel axis (long-context cells)
    heads_ok: bool = False     # n_heads divisible by tp
    kv_heads_ok: bool = False
    vocab_ok: bool = False
    d_inner_ok: bool = False
    experts_ok: bool = False
    ffn_ok: bool = False


_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_axis_ctx",
                                                      default=None)


def current() -> Optional[AxisCtx]:
    return _CTX.get()


@contextlib.contextmanager
def use(ctx: Optional[AxisCtx]):
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def act(x):
    """Residual stream (B, S, D) or (B, D)."""
    return x


def heads(x, kv: bool = False):
    """Per-head activations (B, S, H, hd)."""
    return x


def logits(x):
    """(.., V): vocab over tp when divisible."""
    return x


def moe_dispatch(x):
    """(E, C, D/F): experts over tp, capacity over batch axes."""
    return x


def mamba_inner(x):
    """(B, S, DI, DS) scan tensors: d_inner over tp."""
    return x


def ffn_hidden(x):
    """(B, S, F): FFN hidden over tp."""
    return x
