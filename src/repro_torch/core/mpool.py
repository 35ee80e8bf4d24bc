"""mpool -- the pinned metadata arena (paper §4.1.1).

    "we design a metadata pool (mpool) that allocates full pages and slab
     memory at various granularities. All Taiji metadata is allocated from
     this pool, whose memory is pinned and excluded from swapping, ensuring
     GPA = HPA ... Centralized metadata management also prevents
     fragmentation."

Faithfulness notes:
  * The arena is a real byte region carved out of the managed physical
    memory (the first ``mpool_reserve_ms`` sections), pinned and identity
    mapped -- the GPA=HPA contract.
  * Two allocation families, as in the paper: **full pages** (used for the
    block/EPT tables and IOMMU-analogue tables) and **slab** objects at
    power-of-two size classes (used for swap/LRU records, bitmaps, CRCs).
    Fig 13a reports the split (68.53% full pages / 31.47% slab); the
    benchmark reads the same split from :meth:`stats`.
  * Persistent metadata (bitmaps, CRC arrays, per-MP state) lives *inside*
    the arena as numpy views, which is what makes hot-upgrade inheritance
    literal: the new engine module re-attaches to the same buffers without
    any conversion (paper §4.4 "Data Plane Compatibility").
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..analysis.lock_order import named_lock
from .errors import MpoolExhaustedError

_MIN_CLASS = 32  # smallest slab object, bytes


class Handle:
    """A view into the arena. ``offset``/``nbytes`` are stable across upgrades."""

    __slots__ = ("offset", "nbytes", "_arena")

    def __init__(self, arena: "Mpool", offset: int, nbytes: int) -> None:
        self._arena = arena
        self.offset = offset
        self.nbytes = nbytes

    def view(self, dtype=np.uint8) -> np.ndarray:
        dt = np.dtype(dtype)
        count = self.nbytes // dt.itemsize
        return self._arena.buffer[self.offset : self.offset + self.nbytes].view(dt)[:count]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Handle(off={self.offset}, n={self.nbytes})"


class _SlabPage:
    """One arena page dedicated to a single size class."""

    __slots__ = ("page", "cls_bytes", "free_slots", "nslots")

    def __init__(self, page: Handle, cls_bytes: int) -> None:
        self.page = page
        self.cls_bytes = cls_bytes
        self.nslots = page.nbytes // cls_bytes
        self.free_slots: List[int] = list(range(self.nslots - 1, -1, -1))


class Mpool:
    """Pinned page + slab allocator over a fixed byte arena."""

    def __init__(self, buffer: np.ndarray, page_bytes: int) -> None:
        if buffer.dtype != np.uint8 or buffer.ndim != 1:
            raise ValueError("mpool arena must be a flat uint8 buffer")
        if len(buffer) % page_bytes:
            raise ValueError("arena size must be a multiple of page_bytes")
        self.buffer = buffer
        self.page_bytes = page_bytes
        self.n_pages = len(buffer) // page_bytes

        self._lock = named_lock("mpool")
        self._free_pages: List[int] = list(range(self.n_pages - 1, -1, -1))
        # size-class -> list of slab pages with free slots
        self._partial: Dict[int, List[_SlabPage]] = {}
        # offset -> (slab_page, slot) for frees
        self._slab_index: Dict[int, tuple] = {}

        # accounting (Fig 13a): full-page vs slab usage, peak
        self.page_bytes_used = 0
        self.slab_bytes_used = 0
        self.peak_bytes_used = 0

    # ------------------------------------------------------------ full pages
    def alloc_page(self) -> Handle:
        with self._lock:
            return self._alloc_page_locked(slab=False)

    def _alloc_page_locked(self, slab: bool) -> Handle:
        if not self._free_pages:
            raise MpoolExhaustedError(
                f"mpool exhausted: {self.n_pages} pages in use "
                "(the paper sizes the reserve with >2x headroom)")
        idx = self._free_pages.pop()
        if not slab:
            self.page_bytes_used += self.page_bytes
            self._bump_peak()
        h = Handle(self, idx * self.page_bytes, self.page_bytes)
        h.view()[:] = 0
        return h

    def free_page(self, h: Handle) -> None:
        with self._lock:
            self.page_bytes_used -= self.page_bytes
            self._free_pages.append(h.offset // self.page_bytes)

    # ------------------------------------------------------------------ slab
    @staticmethod
    def size_class(nbytes: int) -> int:
        c = _MIN_CLASS
        while c < nbytes:
            c <<= 1
        return c

    def slab_alloc(self, nbytes: int) -> Handle:
        cls = self.size_class(nbytes)
        if cls > self.page_bytes:
            raise ValueError(f"slab object {nbytes}B exceeds page size; use alloc_page")
        with self._lock:
            pages = self._partial.setdefault(cls, [])
            if not pages:
                pages.append(_SlabPage(self._alloc_page_locked(slab=True), cls))
            sp = pages[-1]
            slot = sp.free_slots.pop()
            if not sp.free_slots:
                pages.pop()          # full: drop from the partial list
            off = sp.page.offset + slot * cls
            self._slab_index[off] = (sp, slot)
            self.slab_bytes_used += cls
            self._bump_peak()
        h = Handle(self, off, cls)
        h.view()[:] = 0
        return h

    def slab_free(self, h: Handle) -> None:
        with self._lock:
            sp, slot = self._slab_index.pop(h.offset)
            was_full = not sp.free_slots
            sp.free_slots.append(slot)
            self.slab_bytes_used -= sp.cls_bytes
            if was_full:
                self._partial.setdefault(sp.cls_bytes, []).append(sp)

    # ------------------------------------------------------------ accounting
    def _bump_peak(self) -> None:
        used = self.page_bytes_used + self.slab_bytes_used
        if used > self.peak_bytes_used:
            self.peak_bytes_used = used

    def stats(self) -> Dict[str, float]:
        used = self.page_bytes_used + self.slab_bytes_used
        total = len(self.buffer)
        return {
            "reserved_bytes": total,
            "used_bytes": used,
            "peak_bytes": self.peak_bytes_used,
            "utilization": used / total if total else 0.0,
            "full_page_bytes": self.page_bytes_used,
            "slab_bytes": self.slab_bytes_used,
            "full_page_fraction": (self.page_bytes_used / used) if used else 0.0,
            "slab_fraction": (self.slab_bytes_used / used) if used else 0.0,
        }
