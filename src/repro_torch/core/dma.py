"""DMA protection and data correctness (paper §7.1).

    "as current DMA devices lack retry support, swapping memory must be
     avoided to prevent corruption ... Taiji lets applications specify DMA
     ranges for protection and ensures timely swap-in before access. Taiji
     also intercepts DMAR exceptions and uses CRC to ensure correctness."

On the TPU side the "DMA device" is a dispatched XLA step: once launched it
cannot retry a missing block, so every block a step may touch is pinned for
the step duration. The registry supports both long-lived application tags
(``register_range``) and per-step pins (``pin_for_step`` context).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterable, List, Set

from ..analysis.lock_order import named_lock
from .metrics import Metrics
from .swap import SwapEngine
from .virt import NO_PFN, VirtualizationLayer


class DMARegistry:
    def __init__(self, virt: VirtualizationLayer, engine: SwapEngine,
                 metrics: Metrics) -> None:
        self.virt = virt
        self.engine = engine
        self.metrics = metrics
        self._lock = named_lock("app")
        # gfn -> pin refcount (a gfn may be in several active ranges/steps)
        self._pins: Dict[int, int] = {}
        self._ranges: Dict[str, List[int]] = {}

    # ------------------------------------------------------- range tagging
    def register_range(self, tag: str, gfns: Iterable[int]) -> None:
        """Application-specified DMA range: swap-in now, pin until dropped."""
        gfns = list(gfns)
        for gfn in gfns:
            self._ensure_resident(gfn)
        with self._lock:
            self._ranges[tag] = gfns
            for gfn in gfns:
                self._pin_locked(gfn)

    def drop_range(self, tag: str) -> None:
        with self._lock:
            gfns = self._ranges.pop(tag, [])
            for gfn in gfns:
                self._unpin_locked(gfn)

    # ----------------------------------------------------------- step pins
    @contextmanager
    def pin_for_step(self, gfns: Iterable[int]):
        """Pin a working set for one in-flight step (DMA cannot retry)."""
        gfns = list(gfns)
        for gfn in gfns:
            self._ensure_resident(gfn)
        with self._lock:
            for gfn in gfns:
                self._pin_locked(gfn)
        try:
            yield
        finally:
            with self._lock:
                for gfn in gfns:
                    self._unpin_locked(gfn)

    # ------------------------------------------------------------ internals
    def _ensure_resident(self, gfn: int) -> None:
        """Timely swap-in before access (§7.1)."""
        req = self.engine.reqs.lookup(gfn)
        if req is not None and req.record.swapped_out_count() > 0:
            self.engine.swap_in_ms(gfn)
        if int(self.virt.table.pfn[gfn]) == NO_PFN:
            # fully swapped and no req progress -- fault in MP 0 to allocate
            self.engine.swap_in_ms(gfn)

    def _pin_locked(self, gfn: int) -> None:
        c = self._pins.get(gfn, 0)
        self._pins[gfn] = c + 1
        if c == 0:
            self.virt.table.set_pinned(gfn, True)

    def _unpin_locked(self, gfn: int) -> None:
        c = self._pins.get(gfn, 0) - 1
        if c <= 0:
            self._pins.pop(gfn, None)
            self.virt.table.set_pinned(gfn, False)
        else:
            self._pins[gfn] = c

    def pinned_gfns(self) -> Set[int]:
        with self._lock:
            return set(self._pins)
