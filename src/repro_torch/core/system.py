"""TaijiSystem -- the assembled elastic-memory system.

Wires together the virtualization layer, mpool, backend, req tree, LRU,
watermark policy, swap engine, hv_sched and DMA registry, and exposes the
guest-facing API (allocate/free elastic MSs, read/write through the block
table). This is what the hot-switch produces from a running plain system
and what the framework integrations (elastic_kv / elastic_params) drive.

Port: the guest frames live on an explicit device (``device=``; the card
by default). :meth:`TaijiSystem.export_ms` / :meth:`TaijiSystem.import_ms`
exchange the reference's portable numpy MS image, and
:func:`import_images` loads a reference system's exported state.
"""
from __future__ import annotations

import sys
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..analysis.lock_order import named_lock
from . import scheduler as sched
from .backend import BackendStore
from .config import TaijiConfig
from .dma import DMARegistry
from .errors import InvalidStateError
from .guest import GuestSpace
from .lru import MultiLevelLRU
from .metrics import Metrics
from .mpool import Mpool
from .req import ReqTree
from .swap import SwapEngine
from .virt import NO_PFN, PhysicalMemory, VirtualizationLayer, host_u8
from .watermark import WatermarkPolicy


# once-per-site dedup for the deprecation shims: a hot loop driving a shim
# (a not-yet-migrated benchmark) must not pay -- or spam -- one warning per
# call, but distinct call sites each still get their one warning.  Keyed by
# the caller's (filename, lineno); never reset, matching the "warn once"
# contract rather than the warnings-filter lifecycle.
_warned_sites = set()


def _warn_deprecated(old: str, new: str) -> None:
    frame = sys._getframe(2)
    site = (frame.f_code.co_filename, frame.f_lineno)
    if site in _warned_sites:
        return
    _warned_sites.add(site)
    warnings.warn(f"{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


class TaijiSystem:
    def __init__(self, cfg: TaijiConfig,
                 phys: Optional[PhysicalMemory] = None,
                 device=None) -> None:
        """``device`` holds the guest frames: ``None`` means the card and
        raises when there is none; pass ``"cpu"`` to run on the CPU. An
        injected ``phys`` brings its own device."""
        cfg.validate()
        self.cfg = cfg
        self.phys = phys or PhysicalMemory(cfg, device=device)
        self.device: torch.device = self.phys.device
        self.mpool = Mpool(self.phys.mpool_arena(), cfg.mp_bytes)
        self.metrics = Metrics()
        if cfg.obs.enabled:
            # attach before any component constructs: backend/engine/guest
            # cache ``metrics.tracer`` once at their own __init__
            from ..obs.tracer import SpanTracer
            self.metrics.tracer = SpanTracer(cap=cfg.obs.ring_capacity,
                                             max_spans=cfg.obs.max_spans)
        self.virt = VirtualizationLayer(cfg, self.phys, self.mpool,
                                        tracer=self.metrics.tracer)
        self.backend = BackendStore(cfg, self.metrics, device=self.device)
        self.reqs = ReqTree(cfg, self.mpool)
        self.lru = MultiLevelLRU(cfg, self.virt.table.test_and_clear_accessed,
                                 tracer=self.metrics.tracer)
        self.watermark = WatermarkPolicy(cfg)
        self.engine = SwapEngine(cfg, self.virt, self.backend, self.reqs,
                                 self.lru, self.watermark, self.metrics)
        self.scheduler = sched.HvScheduler(cfg, tracer=self.metrics.tracer)
        # epoch publishing: every scheduler cycle refreshes the
        # watermark view the fault fast path reads and drains deferred
        # LRU joins; stepped mode gets the same refresh in step_background
        self.scheduler.add_cycle_hook(self.engine.publish_epoch)
        self.dma = DMARegistry(self.virt, self.engine, self.metrics)

        self._gfn_lock = named_lock("gfn")
        self._free_gfns: List[int] = list(
            range(cfg.n_virt_ms - 1, cfg.mpool_reserve_ms - 1, -1))
        self._background_started = False
        self.module_version = 1          # bumped by hot upgrades
        self._guest: Optional[GuestSpace] = None

    @property
    def tracer(self):
        """The system's :class:`repro_torch.obs.tracer.SpanTracer`, or ``None``
        when ``cfg.obs.enabled`` is False."""
        return self.metrics.tracer

    @property
    def guest(self) -> GuestSpace:
        """The canonical :class:`~.guest.GuestSpace` for this system --
        the one sanctioned guest-memory surface.  Lazily created so every
        caller (integrations, fleet, shims) shares one observer list."""
        if self._guest is None:
            self._guest = GuestSpace(self)
        return self._guest

    # ---------------------------------------------------------- guest alloc
    def guest_alloc_ms(self) -> int:
        """Allocate one virtual MS (elastic: may trigger reclaim)."""
        with self._gfn_lock:
            if not self._free_gfns:
                raise InvalidStateError("virtual address space exhausted")
            gfn = self._free_gfns.pop()
        pfn = self.engine._alloc_slot_critical()
        self.virt.table.map_huge(gfn, pfn)
        self.phys.ms_view(pfn).zero_()
        self.lru.track(gfn)
        return gfn

    def guest_free_ms(self, gfn: int) -> None:
        # ordering matters vs. the background reclaimer: leave the LRU
        # first (no new reclaim picks), then take the req's write lock to
        # wait out any in-flight swap task before tearing the MS down.
        # Drain the deferred fast-path LRU ring before untracking, else a
        # later drain would re-track this gfn after it is freed
        self.engine.drain_lru_pending()
        self.lru.untrack(gfn)
        req = self.reqs.lookup(gfn)
        grant = req.rwlock.acquire_write() if req is not None else None
        # the write lock quiesces locked faults and writers; the zero-page
        # fast path never takes it, so additionally invalidate the fault
        # descriptor and bounce through the MP mutex before teardown
        self.reqs.quiesce_fast_faults(gfn)
        try:
            pfn = int(self.virt.table.pfn[gfn])
            if req is not None:
                rec = req.record
                for mp in range(self.cfg.mps_per_ms):
                    if rec.is_swapped_out(mp):
                        self.backend.drop(gfn, mp, int(rec.kinds[mp]))
            if pfn != NO_PFN:
                if self.virt.table.is_split(gfn):
                    self.virt.table.merge(gfn, pfn)  # normalize before unmap
                self.virt.table.unmap(gfn)
                self.phys.free_slot(pfn)
        finally:
            if grant is not None:
                req.rwlock.release_write(grant)
        if req is not None:
            self.reqs.remove(gfn)
        # a fast fault that raced the teardown may have enqueued this gfn
        # between the drain above and the quiesce; after quiesce no new
        # notes are possible, so one more drain+untrack leaves nothing
        # stale in the LRU
        self.engine.drain_lru_pending()
        self.lru.untrack(gfn)
        with self._gfn_lock:
            self._free_gfns.append(gfn)

    # ------------------------------------------------------ export / import
    def export_ms(self, gfn: int) -> Tuple[np.ndarray, np.ndarray]:
        """Portable image of one MS: ``(rows, resident)``.

        ``rows`` is the guest-visible byte content of every MP (shape
        ``(mps_per_ms, mp_bytes)``); ``resident`` marks which MPs held a
        physical frame at export time. Non-mutating: swapped MPs are read
        through the backend's CRC-verified :meth:`~.backend.BackendStore.peek`
        without consuming their entries, so a migration that is later
        rejected (or fails read-verify) leaves this node untouched.
        Also the read-verify primitive itself -- exporting the imported
        copy yields its guest-visible bytes without faulting anything in.
        """
        cfg = self.cfg
        req = self.reqs.lookup(gfn)
        grant = req.rwlock.acquire_write() if req is not None else None
        try:
            rows = np.zeros((cfg.mps_per_ms, cfg.mp_bytes), dtype=np.uint8)
            resident = np.ones(cfg.mps_per_ms, dtype=bool)
            if req is not None:
                rec = req.record
                # snapshot record state under the MP mutex: the zero-page
                # fast path mutates bitmaps there without taking the rwlock
                with req.mp_cond:
                    swapped = rec.swapped_out_indices()
                    kinds = rec.kinds[swapped].copy()
                    crcs = rec.crc[swapped].copy()
                for j, mp in enumerate(swapped):
                    mp = int(mp)
                    resident[mp] = False
                    self.backend.peek(gfn, mp, int(kinds[j]), int(crcs[j]),
                                      rows[mp])
            pfn = int(self.virt.table.pfn[gfn])
            if pfn != NO_PFN:
                # one device-to-host copy of the frame
                frame = self.phys.ms_rows(pfn).cpu().numpy()
                res_idx = np.flatnonzero(resident)
                rows[res_idx] = frame[res_idx]
            return rows, resident
        finally:
            if grant is not None:
                req.rwlock.release_write(grant)

    def import_ms(self, rows: np.ndarray, resident: np.ndarray) -> int:
        """Admit one exported MS image; returns the new gfn.

        Allocates a fresh MS, materializes the guest-visible bytes, then
        rebuilds the source's resident/swapped split by swapping the
        non-resident MPs back out through the batched store machinery
        (store_batch extents), so a migrated MS lands with the same
        elasticity state it left with.
        """
        cfg = self.cfg
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        if rows.shape != (cfg.mps_per_ms, cfg.mp_bytes):
            raise ValueError(
                f"MS image shape {rows.shape} != "
                f"({cfg.mps_per_ms}, {cfg.mp_bytes})")
        gfn = self.guest_alloc_ms()
        pfn = int(self.virt.table.pfn[gfn])
        self.phys.ms_view(pfn).copy_(host_u8(rows))
        swapped = np.flatnonzero(~np.asarray(resident, dtype=bool))
        if len(swapped):
            self.engine.swap_out_mps(gfn, swapped)
        return gfn

    # ------------------------------------------- guest I/O (deprecated shims)
    # The sanctioned surface is ``self.guest`` (repro_torch.core.guest.GuestSpace);
    # these shims stay byte-equivalent by delegating through it, so
    # observers attached to the canonical GuestSpace still see shimmed
    # accesses (tests/test_guest_api.py pins both properties).
    def write(self, gva: int, data: bytes) -> None:
        _warn_deprecated("TaijiSystem.write(gva, data)",
                         "TaijiSystem.guest.write(gfn, data, off=...)")
        self.guest.write_gva(gva, data)

    def read(self, gva: int, nbytes: int) -> bytes:
        _warn_deprecated("TaijiSystem.read(gva, nbytes)",
                         "TaijiSystem.guest.read(gfn, nbytes, off=...)")
        return self.guest.read_gva(gva, nbytes)

    def ms_addr(self, gfn: int, mp: int = 0, off: int = 0) -> int:
        _warn_deprecated("TaijiSystem.ms_addr(gfn, mp, off)",
                         "TaijiSystem.guest.addr_of(gfn, mp, off)")
        return self.guest.addr_of(gfn, mp, off)

    # ------------------------------------------------------------ background
    def start_background(self) -> None:
        """Register LRU scan + reclaim as BACK tasks and start hv_sched."""
        if self._background_started:
            return
        self._background_started = True
        nw = self.cfg.lru.workers

        def make_scan(shard: int):
            def scan(_quantum: float) -> bool:
                self.lru.scan_shard(shard, nw)
                return True
            return scan

        for w in range(nw):
            self.scheduler.add_task(w, f"lru/{w}", sched.BACK, make_scan(w),
                                    sched.TASK_LRU_SCAN)

        def reclaim(quantum: float) -> bool:
            # the hv_sched quantum bounds the round: reclaim stops starting
            # new whole-MS batches once its BACK slice is spent
            self.engine.reclaim_round(budget_s=quantum)
            return True

        self.scheduler.add_task(0, "reclaim", sched.BACK, reclaim,
                                sched.TASK_RECLAIM)
        self.scheduler.start()

    def stop_background(self) -> None:
        if self._background_started:
            self.scheduler.stop()
            self._background_started = False

    def step_background(self, *, reclaim: bool = True) -> int:
        """One synchronous background round (deterministic stepped mode).

        The fleet layer drives many nodes from a single event loop: each
        fleet tick runs every LRU scan shard once and -- when the
        controller's stagger window says so -- one reclaim round, exactly
        what the hv_sched BACK tasks would do, minus the wall-clock
        slicing. Must not be mixed with ``start_background``.

        Returns the number of MPs reclaimed this round.
        """
        if self._background_started:
            raise InvalidStateError(
                "step_background conflicts with running hv_sched threads")
        self.engine.publish_epoch()     # drain deferred joins + re-publish
        nw = self.cfg.lru.workers
        for w in range(nw):
            self.lru.scan_shard(w, nw)
        if not reclaim:
            return 0
        return self.engine.reclaim_round()

    # ---------------------------------------------------------------- stats
    def snapshot(self) -> Dict[str, object]:
        """Structured node snapshot for the fleet control plane.

        ``deterministic`` holds only event counters/occupancy (byte-stable
        across replays of the same seeded trace); ``latency`` carries the
        timing-dependent percentiles separately.
        """
        self.metrics.sync()              # fold pending latency-ring samples
        self.engine.drain_lru_pending()  # LRU counts reflect drained state
        free = self.phys.free_count
        return {
            "deterministic": {
                "module_version": self.module_version,
                "free_ms": free,
                "zone": self.watermark.zone(free),
                "n_reqs": len(self.reqs),
                "lru": self.lru.counts(),
                "metrics": self.metrics.deterministic_snapshot(),
            },
            "latency": {
                "fault": self.metrics.fault_latency.snapshot(),
                "swap_out": self.metrics.swap_out_latency.snapshot(),
                "swap_in": self.metrics.swap_in_latency.snapshot(),
            },
        }

    def stats(self) -> Dict[str, object]:
        return {
            "module_version": self.module_version,
            "free_ms": self.phys.free_count,
            "watermarks": self.watermark.describe(),
            "lru": self.lru.counts(),
            "mpool": self.mpool.stats(),
            "metrics": self.metrics.snapshot(),
            "n_reqs": len(self.reqs),
            "backend_stored_bytes": self.backend.stored_bytes(),
            "backend": self.backend.stats(),
            "slot_alloc": self.phys.alloc_stats(),
        }

    def close(self) -> None:
        self.stop_background()
        # teardown drain hook: magazine-cached slots return to
        # their shards and deferred LRU joins apply, so anything reading
        # the carcass (chaos accounting, tests) sees exact state
        self.engine.drain_deferred()
        self.backend.close()


def import_images(system: TaijiSystem,
                  images: Mapping[int, Tuple[np.ndarray, np.ndarray]]
                  ) -> Dict[int, int]:
    """Load exported MS images into ``system``, in the mapping's order.

    ``images`` maps a source gfn to its ``(rows, resident)`` image as
    :meth:`TaijiSystem.export_ms` (the reference's or the port's) returns
    it. Returns ``{source gfn: new gfn}``. Each image goes through
    :meth:`TaijiSystem.import_ms`, so it lands with the resident/swapped
    split it left with.
    """
    return {src: system.import_ms(rows, resident)
            for src, (rows, resident) in images.items()}
