"""Elastic MoE expert-weight cache -- Taiji applied to sparse models.

MoE expert weights are the cleanest in-model instance of the paper's
observation: capacity provisioned for *all* experts while the router's
empirical distribution keeps a fraction of them hot. One MS holds one
expert's weight shard; router statistics feed the access bits; rarely
routed experts cool down and get compressed out; a scheduled batch whose
router activates a swapped expert faults it back in before dispatch (the
DMA contract again).

Every expert lives behind a typed :class:`~.guest.MSView` on the one
sanctioned :class:`~.guest.GuestSpace` surface, so weight reads/writes
are shape-checked and capture observers see expert churn as a replayable
workload.

Inapplicable to dense architectures -- noted in DESIGN.md
§Arch-applicability; dense archs run without this feature.

Port: a copy of ``repro/core/elastic_params.py`` over the port's
:class:`~.guest.GuestSpace`, so each expert is an MS of guest frames on
the system's device (the card's HBM by default). Reads return host numpy
arrays, as ``GuestSpace.gather`` does.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Union

import numpy as np

from ..analysis.lock_order import named_lock
from .config import TaijiConfig, size_mpool_reserve
from .guest import GuestSpace, MSView
from .system import TaijiSystem


def make_expert_taiji_config(expert_bytes: int, n_hot_experts: int,
                             n_experts: int, **overrides) -> TaijiConfig:
    """Size a Taiji config: one MS per expert, physical = hot working set."""
    mps = 16
    while expert_bytes // mps < 1024 and mps > 1:
        mps //= 2
    # align the MS so every MP is a multiple of 8 bytes
    align = 8 * mps
    expert_bytes = -(-expert_bytes // align) * align
    over = max(0.25, n_experts / max(1, n_hot_experts) - 1.0)
    reserve = size_mpool_reserve(expert_bytes, mps, n_hot_experts, over)
    base = dict(
        ms_bytes=expert_bytes,
        mps_per_ms=mps,
        n_phys_ms=n_hot_experts + reserve,
        mpool_reserve_ms=reserve,
        overcommit_ratio=over,
    )
    base.update(overrides)
    return TaijiConfig(**base)


class ElasticExpertCache:
    """Host-side elastic store for per-expert weights of one MoE layer.

    Accepts either a :class:`GuestSpace` or a :class:`TaijiSystem` (its
    canonical ``.guest`` space is used).
    """

    def __init__(self, space: Union[GuestSpace, TaijiSystem], n_experts: int,
                 expert_shape: tuple, dtype=np.float32) -> None:
        self.space = space.guest if isinstance(space, TaijiSystem) else space
        self.system = self.space.system      # telemetry / legacy accessors
        self.n_experts = n_experts
        self.expert_shape = tuple(expert_shape)
        self.dtype = np.dtype(dtype)
        nbytes = int(np.prod(expert_shape)) * self.dtype.itemsize
        if nbytes > self.space.cfg.ms_bytes:
            raise ValueError(
                f"expert ({nbytes}B) exceeds MS ({self.space.cfg.ms_bytes}B)")
        self._lock = named_lock("app")
        self._view: Dict[int, MSView] = {}    # eid -> typed view of its MS
        self.route_counts = np.zeros(n_experts, dtype=np.int64)

    def _view_of(self, eid: int, create: bool = False) -> MSView:
        with self._lock:
            view = self._view.get(eid)
            if view is None:
                if not create:
                    raise KeyError(eid)
                gfn = self.space.alloc_ms()
                view = self.space.view(gfn, self.dtype, self.expert_shape)
                self._view[eid] = view
        return view

    # ------------------------------------------------------------- weights
    def put_expert(self, eid: int, weights: np.ndarray) -> None:
        if weights.shape != self.expert_shape:
            raise ValueError("bad expert shape")
        self._view_of(eid, create=True).store(weights)

    def get_expert(self, eid: int) -> np.ndarray:
        return self._view_of(eid).load()

    def get_experts(self, eids: Sequence[int]) -> np.ndarray:
        """Fetch several experts in one batched gather: a single
        residency probe + observer dispatch over the whole activation
        set, returning ``[len(eids), *expert_shape]`` (the MoE dispatch
        hot path -- per-expert ``load()`` paid the full stack each)."""
        gfns = [self._view_of(e).gfn for e in eids]
        return self.space.gather(gfns, self.dtype, self.expert_shape)

    # ------------------------------------------------------------- routing
    def note_routing(self, expert_ids: Iterable[int]) -> None:
        """Report the router's choices: marks those experts accessed."""
        gfns = []
        for eid in set(expert_ids):
            self.route_counts[eid] += 1
            with self._lock:
                view = self._view.get(eid)
            if view is not None:
                gfns.append(view.gfn)
        self.space.hint_accessed(gfns)

    def prepare_dispatch(self, active_experts: Sequence[int]):
        """Swap in + pin the experts the scheduled batch activates."""
        with self._lock:
            gfns = [self._view[e].gfn for e in active_experts
                    if e in self._view]
        return self.space.pin(gfns)

    # ------------------------------------------------------------ telemetry
    def residency(self) -> Dict[str, int]:
        with self._lock:
            gfns = [v.gfn for v in self._view.values()]
        res = self.space.residency(gfns)
        return {"resident_experts": res["resident"],
                "swapped_experts": res["swapped"]}
