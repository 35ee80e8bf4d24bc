"""Watermark-based swapping policy (paper §4.2.2 end, Fig 14e / 15a).

    "Three watermarks are set: high, low, and min. Swapping starts when
     memory drops below low and stops when it rises above high. min marks
     critically low memory, triggering proactive swap-out during page
     faults to avoid prolonged low-memory states."

The policy is a pure decision function over the free-MS count; the swap
engine consults it from the background reclaim task (BACK priority) and
from the fault path (min watermark).
"""
from __future__ import annotations

from ..analysis.lock_order import named_lock
from .config import TaijiConfig


class WatermarkPolicy:
    def __init__(self, cfg: TaijiConfig) -> None:
        self.cfg = cfg
        managed = cfg.n_phys_ms - cfg.mpool_reserve_ms
        wm = cfg.watermark
        self.high_ms = max(1, int(managed * wm.high))
        self.low_ms = max(1, int(managed * wm.low))
        self.min_ms = max(0, int(managed * wm.min))
        self._lock = named_lock("watermark")
        self._reclaiming = False
        # Epoch-published fast-path view: background steps and
        # slow-path allocations write these plain attributes; the fault
        # fast path reads them instead of walking free-list lengths under
        # the mp_mutex. Staleness is bounded by the publish cadence (one
        # scheduler cycle / background step / slow-path alloc). The
        # conservative direction is preserved: a published ``critical``
        # only ever *declines* the inline allocation, and the slow path
        # re-verifies with the live count before acting on it. Start
        # conservative until the first publish.
        self.published_free_ms = -1
        self.published_critical = True

    def publish(self, free_ms: int) -> int:
        """Epoch-publish the watermark view of ``free_ms`` (plain attribute
        stores -- atomic under the GIL, no lock). Returns ``free_ms``."""
        self.published_free_ms = free_ms
        self.published_critical = free_ms <= self.min_ms
        return free_ms

    # ------------------------------------------------------------- decisions
    def should_start_reclaim(self, free_ms: int) -> bool:
        """Background reclaim starts below ``low`` (or ``high`` if eager)."""
        threshold = self.high_ms if self.cfg.watermark.eager_below_high else self.low_ms
        with self._lock:
            if free_ms < threshold:
                self._reclaiming = True
            return self._reclaiming and free_ms < self.high_ms

    def should_stop_reclaim(self, free_ms: int) -> bool:
        """Reclaim stops once free memory rises above ``high``."""
        with self._lock:
            if free_ms >= self.high_ms:
                self._reclaiming = False
                return True
            return False

    def is_critical(self, free_ms: int) -> bool:
        """Below ``min``: proactive synchronous swap-out on the fault path."""
        return free_ms <= self.min_ms

    def reclaim_target(self, free_ms: int) -> int:
        """How many MSs to reclaim to get back above ``high``."""
        return max(0, self.high_ms - free_ms)

    # ----------------------------------------------------------- batch sizing
    def reclaim_batch_ms(self, free_ms: int) -> int:
        """Whole-MS batch size for one background reclaim round.

        Bounded by the configured round size and by the deficit back to
        ``high`` -- the round never picks more MSs than it needs, so the
        batched swap path doesn't overshoot the watermark band.
        """
        return max(1, min(self.cfg.watermark.reclaim_batch,
                          self.reclaim_target(free_ms)))

    def critical_batch_ms(self, free_ms: int) -> int:
        """Synchronous fault-path reclaim batch: sized by the deficit below
        ``min`` so a single fault never drags out a long reclaim."""
        deficit = self.min_ms - free_ms + 1
        return max(1, min(self.cfg.watermark.reclaim_batch, deficit))

    @property
    def reclaiming(self) -> bool:
        with self._lock:
            return self._reclaiming

    # ------------------------------------------------------------- reporting
    def zone(self, free_ms: int) -> str:
        """Watermark zone for fleet snapshots (coordination hook).

        ``ok`` above high, ``band`` inside the reclaim hysteresis band,
        ``low`` below low (reclaim definitely active), ``critical`` at or
        below min (fault-path synchronous reclaim).
        """
        if free_ms <= self.min_ms:
            return "critical"
        if free_ms < self.low_ms:
            return "low"
        if free_ms < self.high_ms:
            return "band"
        return "ok"

    def describe(self) -> dict:
        return {"high": self.high_ms, "low": self.low_ms, "min": self.min_ms}
