"""Sharding rules: parameter / optimizer / batch / cache specs.

The rules of ``repro/launch/sharding.py`` (DESIGN.md §5), over an
abstract mesh:

  * ``model`` axis = tensor parallel (attention heads, FFN hidden, Mamba
    d_inner, vocab for the LM head, MoE expert dim = expert parallel);
  * ``data`` axis = batch data-parallel + ZeRO-3 FSDP on parameters and
    optimizer state (sharded on d_model-sized dims);
  * ``pod`` axis (multi-pod mesh) = outer data parallel: batch sharded
    over (pod, data), parameters replicated across pods.

Every rule is divisibility-guarded: an axis is only assigned if it evenly
divides the dim, so one rule set serves all ten archs (e.g. 14-head
qwen2-0.5b simply leaves heads unsharded on a 16-way model axis).

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names -- the entries of
the reference's ``PartitionSpec``. The port's parameters are one tensor
per layer where the reference stacks layers, so a port spec is the
reference's with its stacked leading entries (always ``None``) dropped.
Parameter specs are keyed by the port's ``named_parameters()`` names; a
rule reads the name's non-digit parts, which are the reference's tree
path (as ``models/convert.py`` does). :func:`placements` turns a spec
into ``torch.distributed.tensor`` placements, one per mesh axis, and
:func:`local_shape` gives a device's shard.

The reference's ``named`` (``NamedSharding`` per spec for ``jax.jit``)
has no counterpart: the port runs on one device and hands no sharding to
a compiler; :func:`placements` is what a ``DTensor`` would take.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

from .. import shard_ctx
from ..models.config import ArchConfig
from .mesh import AbstractMesh

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    """A device-free mesh of ``axis_sizes`` named ``axis_names``."""
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def axis_size(mesh: AbstractMesh, name: Optional[str]) -> int:
    return mesh.shape[name] if name and name in mesh.shape else 1


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh: AbstractMesh) -> list:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``, one
    per mesh axis: ``Shard(d)`` where tensor dim ``d`` is split over the
    axis, ``Replicate()`` where no dim is."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec,
                mesh: AbstractMesh) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``spec`` (the
    rules assign an axis only where it divides the dim)."""
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _entry_axes(entry):
            n *= axis_size(mesh, a)
        out.append(dim // n)
    return tuple(out)


def _shape(t: Any) -> Tuple[int, ...]:
    return tuple(t.shape)


class ShardingRules:
    def __init__(self, cfg: ArchConfig, mesh: AbstractMesh,
                 pod_axis: Optional[str] = None) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.tp = "model"
        self.fsdp = "data" if "data" in mesh.shape else None
        self.pod = pod_axis if (pod_axis and pod_axis in mesh.shape) else None
        # batch shards over (pod, data)
        self.batch_axes: Any = (self.pod, "data") if self.pod else "data"

    # -------------------------------------------------------------- helpers
    def _fit(self, dim: int, axis) -> Optional[Any]:
        """Assign ``axis`` to a dim only if it divides evenly."""
        if axis is None:
            return None
        if isinstance(axis, tuple):
            total = 1
            for a in axis:
                if a is None:
                    return None
                total *= axis_size(self.mesh, a)
            return axis if dim % total == 0 else self._fit(dim, axis[-1])
        return axis if dim % axis_size(self.mesh, axis) == 0 else None

    def _spec(self, shape: Tuple[int, ...], *last_dims) -> Spec:
        """Right-aligned spec: assign rules to the trailing dims."""
        lead = len(shape) - len(last_dims)
        entries = [None] * lead
        for i, axis in enumerate(last_dims):
            entries.append(self._fit(shape[lead + i], axis))
        return tuple(entries)

    # ------------------------------------------------------------ parameters
    def param_pspecs(self, named_params: Union[Mapping[str, Any],
                                               Iterable[Tuple[str, Any]]]
                     ) -> Dict[str, Spec]:
        """A spec per parameter: ``named_params`` is ``model.named_parameters()``
        (or a name -> tensor mapping; only shapes are read)."""
        cfg = self.cfg
        tp, fsdp = self.tp, self.fsdp

        def tp_if(cond):
            return tp if cond else None

        tp_size = axis_size(self.mesh, tp)
        tp_q = tp_if(cfg.n_heads and cfg.n_heads % tp_size == 0)
        tp_kv = tp_if(cfg.n_kv_heads and cfg.n_kv_heads % tp_size == 0)
        tp_ep = None
        if cfg.moe is not None and cfg.moe.n_routed % tp_size == 0:
            tp_ep = tp

        def rule(pname: str, shape: Tuple[int, ...]) -> Spec:
            keys = [k for k in pname.split(".") if not k.isdigit()]
            name = keys[-1]
            in_moe = "moe" in keys or name.startswith("shared_")

            if name == "embed":
                if cfg.tie_embeddings:
                    # tied: keep vocab-major so the logits matmul comes out
                    # vocab-sharded (Megatron-style vocab parallelism)
                    return self._spec(shape, tp, None)
                # d_model over the model axis: the token-gather output then
                # reshards with one small all-gather
                return self._spec(shape, None, tp)
            if name == "lm_head":
                return self._spec(shape, fsdp, tp)
            if name == "frontend_proj":
                return self._spec(shape, None, fsdp)
            if name in ("final_norm",) or name.startswith("ln"):
                return (None,) * len(shape)
            # attention
            if name == "wq":
                return self._spec(shape, fsdp, tp_q)
            if name in ("wk", "wv"):
                return self._spec(shape, fsdp, tp_kv)
            if name == "wo":
                return self._spec(shape, tp_q, fsdp)
            if name == "bq":
                return self._spec(shape, tp_q)
            if name in ("bk", "bv"):
                return self._spec(shape, tp_kv)
            if name in ("q_norm", "k_norm"):
                return (None,) * len(shape)
            # MoE
            if name == "router":
                return self._spec(shape, fsdp, None)
            if in_moe and name in ("w_gate", "w_up"):
                return self._spec(shape, tp_ep, fsdp, None)
            if in_moe and name == "w_down":
                return self._spec(shape, tp_ep, None, fsdp)
            if name in ("shared_gate", "shared_up"):
                return self._spec(shape, fsdp, tp)
            if name == "shared_down":
                return self._spec(shape, tp, fsdp)
            # dense MLP
            if name in ("w_gate", "w_up"):
                return self._spec(shape, fsdp, tp)
            if name == "w_down":
                return self._spec(shape, tp, fsdp)
            # mamba
            if name == "in_proj":
                return self._spec(shape, fsdp, tp)
            if name == "conv_w":
                return self._spec(shape, None, tp)
            if name in ("conv_b", "dt_bias", "D"):
                return self._spec(shape, tp)
            if name == "x_proj":
                return self._spec(shape, tp, None)
            if name == "dt_proj":
                return self._spec(shape, None, tp)
            if name == "A_log":
                return self._spec(shape, tp, None)
            if name == "out_proj":
                return self._spec(shape, tp, fsdp)
            return (None,) * len(shape)

        items = (named_params.items() if isinstance(named_params, Mapping)
                 else named_params)
        return {n: rule(n, _shape(t)) for n, t in items}

    def state_pspecs(self, state) -> Dict[str, Any]:
        """Specs of a train state (``steps.TrainState``): the step
        replicated; the parameters and both AdamW moments (the moments in
        parameter order, keyed here by parameter name) share the
        parameter rules."""
        params = self.param_pspecs(state.model.named_parameters())
        return {"step": (), "params": params,
                "opt": {"mu": dict(params), "nu": dict(params)}}

    # ----------------------------------------------------------------- data
    def batch_pspecs(self, batch_shapes: Mapping[str, Any]) -> Dict[str, Spec]:
        out = {}
        for k, v in batch_shapes.items():
            shape = _shape(v)
            if k == "mrope_pos":        # (3, B, S)
                out[k] = (None, self._fit(shape[1], self.batch_axes), None)
            else:                        # (B, ...) leading batch
                out[k] = (self._fit(shape[0], self.batch_axes),
                          *([None] * (len(shape) - 1)))
        return out

    def cache_pspecs(self, cache_shapes: Mapping[str, Any],
                     batch: int) -> Dict[str, Spec]:
        cfg = self.cfg
        tp_size = axis_size(self.mesh, self.tp)
        tp_di = self.tp if (cfg.d_inner and cfg.d_inner % tp_size == 0) else None
        # batch too small to shard (long_500k B=1): shard blocks over data
        b_ax = self._fit(batch, self.batch_axes)
        out: Dict[str, Spec] = {}
        for k, v in cache_shapes.items():
            shape = _shape(v)
            if k == "kv_pool":
                if len(shape) == 7:      # per_seq: (La, B, mbs, bt, 2, KV, hd)
                    out[k] = (None, self._fit(shape[1], self.batch_axes),
                              None, None, None, None, None)
                else:                    # global: (La, NB, bt, 2, KV, hd)
                    out[k] = (None, self._fit(shape[1], self.batch_axes),
                              None, None, None, None)
            elif k == "block_table":    # (B, mbs)
                out[k] = (b_ax, None)
            elif k == "kv_len":         # (B,)
                out[k] = (b_ax,)
            elif k == "conv_state":     # (Lm, B, dc-1, DI)
                out[k] = (None, b_ax, None, tp_di)
            elif k == "ssm_state":      # (Lm, B, DI, DS)
                out[k] = (None, b_ax, tp_di, None)
            else:
                out[k] = (None,) * len(shape)
        return out

    # -------------------------------------------------------------- helpers
    def make_axis_ctx(self, batch: Optional[int] = None) -> shard_ctx.AxisCtx:
        """Activation-sharding context for model-internal constraints."""
        cfg = self.cfg
        tp_size = axis_size(self.mesh, self.tp)
        batch_axes = self.batch_axes
        if batch is not None and self._fit(batch, batch_axes) is None:
            batch_axes = None
        return shard_ctx.AxisCtx(
            batch=batch_axes,
            tp=self.tp,
            heads_ok=bool(cfg.n_heads and cfg.n_heads % tp_size == 0),
            kv_heads_ok=bool(cfg.n_kv_heads and cfg.n_kv_heads % tp_size == 0),
            vocab_ok=cfg.vocab % tp_size == 0,
            d_inner_ok=bool(cfg.d_inner and cfg.d_inner % tp_size == 0),
            experts_ok=bool(cfg.moe is not None
                            and cfg.moe.n_routed % tp_size == 0),
            ffn_ok=bool(cfg.d_ff and cfg.d_ff % tp_size == 0),
        )
