"""Operation and byte counts of a traced step, for the roofline.

The port's counterpart of ``repro/launch/hlo_analysis.py``. The
reference lowers a step to optimized HLO and re-derives FLOPs, HBM bytes
and collective bytes from its text, multiplying each ``while`` body by
its trip count (``cost_analysis`` counts a scanned body once). The port
has no HLO: it runs its step eagerly, one aten operator after another,
so the count is taken where the operators are dispatched:

  * :class:`OpCounter`, a ``TorchDispatchMode``, sees every aten
    operator a step runs -- forward, checkpoint recompute, backward and
    the optimizer -- on meta tensors (nothing executes), and counts per
    operator its FLOPs, by ``torch.utils.flop_counter``'s formulas, and
    its bytes: each tensor operand read once and each result written
    once. Views are left out (:data:`VIEW_OPS` and every operator whose
    schema returns an alias of its input: ``view``, ``reshape``'s
    ``_unsafe_view``, ``expand``, ``transpose``, ``slice``, ``select``
    and the like), as are allocations that move no byte (``empty``),
    the counterparts of the reference's ``_VIEW_OPS``;
  * trip counts: the layers are identical, so a cell is traced at two
    depths and :func:`extrapolate` takes the count linearly to the
    config's depth -- exact, as the tests check against a third depth.

Departures from the HLO analysis:

  * ``memory_s`` is the eager (unfused) byte count: every operator's
    operands and results go through HBM, which a fused kernel would keep
    on chip. It is an upper bound, and ``memory_fusion_s`` (the
    reference's fusion-boundary bound) is the same number;
  * ``tile_bytes`` (the reference's VMEM-resident tile working sets) has
    no counterpart: eager torch keeps no tile on chip;
  * ``collective_s`` is 0: the port runs on one device, and the
    reference's collective bytes parsed from the HLO are dropped;
  * the paged-attention kernel runs no aten operator: on meta its
    wrapper reports the kernel's own cost (``ops.paged_attn_cost``, the
    formula of its bound in ``chip_smoke.py``) under
    ``paged_attn_kernel``, with every table entry used, since a meta
    ``kv_len`` holds no lengths.

The hardware constants are one H100 SXM's (NVIDIA's data sheet, dense):
989 TFLOP/s in bf16 and 3.35 TB/s of HBM.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ops

aten = torch.ops.aten
# operators that return a view (beyond those whose schema says so) or
# allocate without moving a byte
VIEW_OPS = {aten._unsafe_view, aten.lift_fresh, aten.empty, aten.empty_like,
            aten.empty_strided, aten.new_empty, aten.new_empty_strided}
# in-place operators that write their destination without reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_}
# in-place operators that write only the rows they are given: their
# destination moves as many bytes as the values written into it
_SCATTER = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
            aten.index_add_, aten.scatter_, aten.scatter_add_,
            aten.scatter_reduce_, aten.masked_scatter_, aten.index_fill_}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    # per operator: [calls, flops, bytes]
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def record(self, op: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        row = self.by_op.setdefault(op, [0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for op, row in other.by_op.items():
            mine = self.by_op.setdefault(op, [0.0, 0.0, 0.0])
            for i in range(3):
                mine[i] += row[i] * mult

    def top(self, n: int = 10) -> List[Tuple[str, List[float]]]:
        """The ``n`` operators that move the most bytes."""
        return sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:n]


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten operator run under it."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = Cost()

    def __enter__(self):
        ops.meta_cost_sinks.append(self.cost.record)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.meta_cost_sinks.remove(self.cost.record)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in VIEW_OPS or func.is_view:
            return out
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        operands = _tensors((args, kwargs))
        if packet in _WRITE_ONLY or packet in _SCATTER:
            rest = sum(_nbytes(t) for t in operands[1:])
            nbytes = rest + (rest if packet in _SCATTER else _nbytes(operands[0]))
        else:
            nbytes = (sum(_nbytes(t) for t in operands)
                      + sum(_nbytes(t) for t in _tensors(out)))
        self.cost.record(str(packet).removeprefix("aten."), flops, nbytes)
        return out


def count(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its result,
    its :class:`Cost`)."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.cost


def extrapolate(c1: Cost, d1: int, c2: Cost, d2: int, n: int) -> Cost:
    """The cost at depth ``n`` from costs at depths ``d1`` < ``d2``: the
    depth-independent part plus ``n`` times the per-layer slope (each
    layer the same, as the reference's trip count times its body)."""
    per = (n - d1) / (d2 - d1)
    out = Cost()
    out.add(c1, 1.0 - per)
    out.add(c2, per)
    return out


# one NVIDIA H100 SXM, dense rates (NVIDIA's data sheet)
PEAK_FLOPS = 989e12        # bf16 FLOP/s
HBM_BW = 3.35e12           # bytes/s


def roofline_terms(cost: Cost) -> Dict[str, float]:
    """Roofline terms in seconds per step on one H100, under the
    reference's keys. ``memory_s`` and ``memory_fusion_s`` are both the
    eager byte count over HBM bandwidth (an upper bound); ``collective_s``
    is 0 on one device."""
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.hbm_bytes / HBM_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": 0.0}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {**terms, "memory_fusion_s": memory_s, "dominant": dom,
            "roofline_fraction": (compute_s / bound) if bound else 0.0,
            "overlap_fraction": (bound / total) if total else 0.0}
