"""Hybrid virtualization layer (paper §4.1).

Address-space model, kept 1:1 with the paper's:

  * GVA -> GPA via the guest kernel page table (``init_mm``). The Taiji
    module lives inside the guest kernel, so GVA == HVA; for the managed
    region the guest mapping is the identity (kernel linear map), which we
    model with :meth:`AddressSpace.gva_to_gpa`.
  * GPA -> HPA via the **block table** (the EPT analogue), which maps a
    virtual memory section (keyed by GFN) to a physical slot (PFN) at huge
    granularity, or -- after the exactly-once *split* at first MP swap-out --
    at per-MP granularity within the slot.
  * Taiji's own accesses run in "root mode" and bypass the block table
    (single-layer translation, §4.1.1 Fourth), which is only correct for
    GPA == HPA memory: the pinned mpool arena. :meth:`root_access` asserts
    that contract.

Fault model: a guest access to a swapped MP raises :class:`EPTFault`
(= EPT violation VM exit). The swap engine's ``Fault_in`` task resolves it.
On a TPU there is no synchronous fault from inside a compiled step, so the
framework integration (elastic_kv/elastic_params) discovers misses at
step-assembly time and drives the *same* fault path proactively -- see
DESIGN.md §2.

Port: the frames are one flat ``torch.uint8`` tensor on an explicit
device -- the H100's HBM, which is the scarce memory Taiji makes
elastic, or the CPU for parity runs -- and the pinned mpool metadata
arena is a separate host numpy buffer (the fault path reads its records
at microsecond grain). Slot numbering is the reference's: slots below
``mpool_reserve_ms`` stay reserved in the frame tensor, so free counts
and snapshots match.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.lock_order import named_lock
from .config import TaijiConfig
from .errors import InvalidStateError, OutOfMemoryError, PinnedError
from .mpool import Handle, Mpool

NO_PFN = -1


class _Magazine(list):
    """Per-thread slot cache: a plain list plus the owning thread's home
    shard index, resolved once at magazine creation so the refill path
    skips a ``get_ident() %% n`` per refill."""

    __slots__ = ("home",)

# flags bits (block-table per-GFN flags)
F_SPLIT = 1 << 0      # MS mapping split to MP granularity
F_PINNED = 1 << 1     # never swap (mpool, registered DMA ranges)
F_ACCESSED = 1 << 2   # accessed since last LRU scan (EPT A-bit analogue)


def resolve_device(device=None) -> torch.device:
    """The frames' device. ``None`` means the card: with no CUDA device
    that raises rather than carrying on silently on the CPU -- a caller
    that wants the CPU says so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def host_u8(data) -> torch.Tensor:
    """A CPU uint8 tensor over ``data`` (bytes-like or ndarray), ready to
    be copied into the frames. Read-only buffers are copied first, since
    torch tensors over them would be writable."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def frame_bytes(t: torch.Tensor) -> bytes:
    """The bytes of a frame slice (a D2H copy on the card, which waits
    for the stream)."""
    return t.cpu().numpy().tobytes()


def to_host(t: torch.Tensor) -> np.ndarray:
    """An independent host copy of a frame slice (a D2H copy on the
    card, which waits for the stream)."""
    return t.to("cpu", copy=True).numpy()


class EPTFault(Exception):
    """EPT violation: guest touched a non-resident MP."""

    def __init__(self, gfn: int, mp: int) -> None:
        super().__init__(f"EPT fault gfn={gfn} mp={mp}")
        self.gfn = gfn
        self.mp = mp


class PhysicalMemory:
    """The device's physical memory: ``n_phys_ms`` sections of ``ms_bytes``.

    Slot allocation: the free-slot list is sharded into
    ``hot_path.slot_shards`` per-shard freelists (a slot's home shard is
    ``pfn % n_shards``) fronted by per-thread *magazines*. A faulting
    thread refills its magazine with up to ``magazine_size`` slots under
    ONE shard lock, then serves allocations from the magazine lock-free
    (``list.pop`` is atomic under the GIL, so each cached slot is handed
    out exactly once even while :meth:`drain_magazines` or an exhausted
    peer steals from the same magazine). Frees return to the slot's home
    shard under that shard's lock only.

    Accounting: ``free_count`` is the sum of shard and magazine lengths.
    Magazine-cached slots have not been handed to any caller, so they
    count as free; the sum is exact at quiescence (tests, snapshots,
    watermark publishes) and skews by at most one in-flight refill batch
    for a few bytecodes mid-refill -- in the conservative (undercount)
    direction.

    ``magazine_size <= 0`` collapses to the legacy single-list path
    (one global lock, identical pop order to the pre-sharding code): the
    A/B reference used by ``HotPathConfig.legacy_scalar``.
    """

    def __init__(self, cfg: TaijiConfig, device=None) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        # guest frames on the device; slots below mpool_reserve_ms keep
        # their numbers but hold no metadata (the arena lives on the host)
        self.frames = torch.zeros(cfg.n_phys_ms * cfg.ms_bytes,
                                  dtype=torch.uint8, device=self.device)
        self._arena = np.zeros(cfg.mpool_reserve_ms * cfg.ms_bytes,
                               dtype=np.uint8)
        # slots below mpool_reserve_ms are the pinned metadata arena
        slots: List[int] = list(
            range(cfg.n_phys_ms - 1, cfg.mpool_reserve_ms - 1, -1))
        self.n_managed = cfg.n_phys_ms - cfg.mpool_reserve_ms

        hp = getattr(cfg.swap, "hot_path", None)
        self._mag_size = int(getattr(hp, "magazine_size", 0) or 0)
        n_shards = int(getattr(hp, "slot_shards", 1) or 1)
        if self._mag_size <= 0:
            n_shards = 1  # legacy single-list path
        self._n_shards = max(1, min(n_shards, max(1, len(slots))))
        self._shard_locks = [named_lock("slot") for _ in range(self._n_shards)]
        if self._n_shards == 1:
            self._shards: List[List[int]] = [slots]
        else:
            self._shards = [[] for _ in range(self._n_shards)]
            for pfn in slots:
                self._shards[pfn % self._n_shards].append(pfn)
        # legacy aliases: single-list mode pops/appends through these
        self._lock = self._shard_locks[0]
        self._free_slots = self._shards[0]
        # pre-zipped (lock, shard) pairs: the free path indexes once
        self._homes = list(zip(self._shard_locks, self._shards))
        # per-thread magazines; the registry lets drain/steal walk every
        # magazine regardless of owning thread
        self._tls = threading.local()
        self._magazines: List[List[int]] = []
        self._mag_registry_lock = named_lock("slot")
        self.magazine_refills = 0  # exact: bumped under a shard lock
        if self._mag_size > 0:
            # rebind the allocation entry point per-instance: the hot
            # path then starts at the thread-local load instead of
            # re-testing the mode flag on every allocation
            self.try_alloc_slot = self._try_alloc_magazine  # type: ignore[method-assign]

    # ------------------------------------------------------------ allocation
    def _magazine(self) -> _Magazine:
        mag = getattr(self._tls, "mag", None)
        if mag is None:
            mag = self._tls.mag = _Magazine()
            mag.home = threading.get_ident() % self._n_shards
            with self._mag_registry_lock:
                self._magazines.append(mag)
        return mag

    def _refill_and_pop(self, mag: List[int]) -> Optional[int]:
        """Refill ``mag`` from a shard under one lock; return one slot.

        Exception-free: shards are peeked lock-free before
        taking their lock -- a racy non-empty peek is re-checked under
        the lock, a racy empty peek at worst defers to the next shard
        (the steal pass below still finds every cached slot), so the
        near-exhaustion tail no longer pays one lock acquire per empty
        shard per allocation.
        """
        take = self._mag_size + 1
        home = getattr(mag, "home", 0)
        shards = self._shards
        locks = self._shard_locks
        # common case first, no loop machinery: the home shard has slots
        shard = shards[home]
        if shard:
            with locks[home]:
                if shard:
                    batch = shard[-take:]
                    del shard[-take:]
                    self.magazine_refills += 1
                    slot = batch.pop()
                    if batch:
                        mag.extend(batch)
                    return slot
        n = self._n_shards
        for i in range(1, n):
            j = home + i
            if j >= n:
                j -= n
            shard = shards[j]
            if not shard:  # lock-free peek: skip drained shards
                continue
            with locks[j]:
                if shard:
                    batch = shard[-take:]
                    del shard[-take:]
                    self.magazine_refills += 1
                    slot = batch.pop()
                    if batch:
                        mag.extend(batch)
                    return slot
        # every shard empty: steal from other threads' magazines so
        # cached-but-unused slots never masquerade as exhaustion
        # (exactly-once still holds -- pop is atomic, a slot goes to the
        # stealing thread or the owner, never both). The sentinel check
        # keeps the common all-empty walk free of raised exceptions; the
        # pop can still lose a check-to-pop race, hence the guard.
        for other in self._magazines:
            if other:
                try:
                    return other.pop()
                except IndexError:
                    continue
        return None

    def alloc_slot(self) -> int:
        slot = self.try_alloc_slot()
        if slot is None:
            raise OutOfMemoryError("no free physical MS")
        return slot

    def try_alloc_slot(self) -> Optional[int]:
        # legacy single-list path; magazine instances rebind this name
        # to _try_alloc_magazine at construction
        with self._lock:
            return self._free_slots.pop() if self._free_slots else None

    def _try_alloc_magazine(self) -> Optional[int]:
        # common case is one thread-local load + one atomic pop. The
        # empty-magazine check is a sentinel test, NOT a raised
        # IndexError: raising costs ~0.2us under CPython 3.10
        # and fired on every refill entry, which is what sank the
        # single-thread number to 0.56x of the legacy freelist.
        try:
            mag = self._tls.mag
        except AttributeError:  # first alloc on this thread only
            mag = self._magazine()
        if mag:
            try:
                return mag.pop()
            except IndexError:  # lost the check-to-pop race to a
                pass            # concurrent drain/steal -- refill
        return self._refill_and_pop(mag)

    def free_slot(self, pfn: int) -> None:
        lock, shard = self._homes[pfn % self._n_shards]
        with lock:
            shard.append(pfn)

    def drain_magazines(self) -> int:
        """Return every magazine-cached slot to its home shard.

        The drain hook reclaim/teardown uses so the shard lists hold the
        complete free set (``free_count`` is exact either way -- this
        just moves slots out of thread caches). Safe concurrently with
        allocation: each pop is atomic, so a slot is drained or handed
        out, never both. Returns the number of slots drained.
        """
        if self._mag_size <= 0:
            return 0
        drained = 0
        for mag in self._magazines:
            while True:
                try:
                    pfn = mag.pop()
                except IndexError:
                    break
                self.free_slot(pfn)
                drained += 1
        return drained

    @property
    def free_count(self) -> int:
        n = sum(len(s) for s in self._shards)
        if self._mag_size > 0:
            n += sum(len(m) for m in self._magazines)
        return n

    def alloc_stats(self) -> dict:
        """Allocator observability: shard/magazine geometry and traffic."""
        return {
            "slot_shards": self._n_shards,
            "magazine_size": self._mag_size,
            "magazine_cached": (sum(len(m) for m in self._magazines)
                                if self._mag_size > 0 else 0),
            "magazine_refills": self.magazine_refills,
        }

    # ----------------------------------------------------------------- views
    def ms_view(self, pfn: int) -> torch.Tensor:
        o = pfn * self.cfg.ms_bytes
        return self.frames[o : o + self.cfg.ms_bytes]

    def ms_rows(self, pfn: int) -> torch.Tensor:
        """One MS frame as (mps_per_ms, mp_bytes) rows -- the pool the
        swap kernels gather from and scatter into."""
        return self.ms_view(pfn).view(self.cfg.mps_per_ms, self.cfg.mp_bytes)

    def mp_view(self, pfn: int, mp: int) -> torch.Tensor:
        o = pfn * self.cfg.ms_bytes + mp * self.cfg.mp_bytes
        return self.frames[o : o + self.cfg.mp_bytes]

    def mpool_arena(self) -> np.ndarray:
        """The pinned metadata arena: a host buffer of its own, not the
        head of the frames."""
        return self._arena


class BlockTable:
    """The EPT analogue: GFN -> (PFN, flags, per-MP presence).

    Backed by mpool **full pages** (the paper: "68.53% is for full pages
    (EPT and IOMMU page tables)"). Per-MP presence bitmaps for split
    mappings live in the owning req's slab allocation; the table holds the
    huge-granularity word per GFN.
    """

    def __init__(self, cfg: TaijiConfig, mpool: Mpool) -> None:
        self.cfg = cfg
        n = cfg.n_virt_ms
        self._pfn_pages: List[Handle] = []
        self._flag_pages: List[Handle] = []
        per_page = mpool.page_bytes // 4
        need = (n + per_page - 1) // per_page
        pfn_views, flag_views = [], []
        for _ in range(need):
            hp = mpool.alloc_page()
            hf = mpool.alloc_page()
            self._pfn_pages.append(hp)
            self._flag_pages.append(hf)
            pfn_views.append(hp.view(np.int32))
            flag_views.append(hf.view(np.int32))
        self.pfn = np.concatenate(pfn_views)[:n] if len(pfn_views) > 1 else pfn_views[0][:n]
        self.flags = (np.concatenate(flag_views)[:n]
                      if len(flag_views) > 1 else flag_views[0][:n])
        self.pfn[:] = NO_PFN
        self.flags[:] = 0
        self._lock = named_lock("blocktable")

    # NOTE: single-word reads/writes of int32 numpy cells are effectively
    # atomic under the GIL; multi-field transitions take the lock.
    def map_huge(self, gfn: int, pfn: int) -> None:
        with self._lock:
            self.pfn[gfn] = pfn
            self.flags[gfn] &= ~F_SPLIT

    def unmap(self, gfn: int) -> None:
        with self._lock:
            if self.flags[gfn] & F_PINNED:
                raise PinnedError(f"gfn {gfn} is pinned")
            self.pfn[gfn] = NO_PFN
            self.flags[gfn] &= ~F_SPLIT

    def split(self, gfn: int) -> None:
        """Exactly-once split at first MP swap-out (paper Fig 8 (4.1))."""
        with self._lock:
            if self.flags[gfn] & F_SPLIT:
                raise InvalidStateError(f"gfn {gfn} already split")
            self.flags[gfn] |= F_SPLIT

    def merge(self, gfn: int, pfn: int) -> None:
        """Exactly-once merge after last MP swap-in (paper Fig 8 (7))."""
        with self._lock:
            if not self.flags[gfn] & F_SPLIT:
                raise InvalidStateError(f"gfn {gfn} not split")
            self.pfn[gfn] = pfn
            self.flags[gfn] &= ~F_SPLIT

    def map_split(self, gfn: int, pfn: int) -> None:
        """Install a new physical MS for a split mapping (first MP swap-in)."""
        with self._lock:
            self.pfn[gfn] = pfn
            self.flags[gfn] |= F_SPLIT

    def set_pinned(self, gfn: int, pinned: bool) -> None:
        with self._lock:
            if pinned:
                self.flags[gfn] |= F_PINNED
            else:
                self.flags[gfn] &= ~F_PINNED

    def is_pinned(self, gfn: int) -> bool:
        return bool(self.flags[gfn] & F_PINNED)

    def is_split(self, gfn: int) -> bool:
        return bool(self.flags[gfn] & F_SPLIT)

    def mark_accessed(self, gfn: int) -> None:
        self.flags[gfn] |= F_ACCESSED

    def test_and_clear_accessed(self, gfn: int) -> bool:
        with self._lock:
            a = bool(self.flags[gfn] & F_ACCESSED)
            if a:
                self.flags[gfn] &= ~F_ACCESSED
            return a


class AddressSpace:
    """GVA->GPA (guest init_mm, identity over the managed region)."""

    def __init__(self, cfg: TaijiConfig) -> None:
        self.cfg = cfg
        self.limit = cfg.n_virt_ms * cfg.ms_bytes

    def gva_to_gpa(self, gva: int) -> int:
        if not 0 <= gva < self.limit:
            raise ValueError(f"GVA {gva:#x} outside guest address space")
        return gva  # kernel linear map: GVA == HVA, identity to GPA

    def gpa_to_gfn_mp(self, gpa: int) -> Tuple[int, int, int]:
        gfn, off = divmod(gpa, self.cfg.ms_bytes)
        mp, inner = divmod(off, self.cfg.mp_bytes)
        return gfn, mp, inner


class AccessGuard:
    """Guest accesses in flight, by gfn: the TLB shootdown's analogue.

    A guest access enters its gfn before it reads the block table and
    leaves once its frame copy is issued on the device stream. A
    swap-out marks its MPs non-present first and then drains the gfn, so
    a copy issued against a translation made before that mark reaches
    the stream ahead of the swap-out's read of the frame -- never after
    it, and never into a frame already freed and handed to another MS.
    Nothing is acquired under the lock, and a thread inside never faults
    or swaps, so a drain waits for copies to be issued and no longer.
    """

    def __init__(self) -> None:
        self._n: Dict[int, int] = {}
        self._cond = threading.Condition(named_lock("guard"))
        self._waiting = 0

    def enter(self, gfn: int) -> None:
        with self._cond:
            self._n[gfn] = self._n.get(gfn, 0) + 1

    def enter_many(self, gfns: List[int]) -> None:
        with self._cond:
            n = self._n
            for g in gfns:
                n[g] = n.get(g, 0) + 1

    def leave(self, gfn: int) -> None:
        self.leave_many((gfn,))

    def leave_many(self, gfns) -> None:
        with self._cond:
            n = self._n
            for g in gfns:
                c = n[g] - 1
                if c:
                    n[g] = c
                else:
                    del n[g]
            if self._waiting:
                self._cond.notify_all()

    def drain(self, gfn: int) -> None:
        """Return once no access that entered ``gfn`` is still inside."""
        with self._cond:
            if gfn not in self._n:
                return
            self._waiting += 1
            try:
                while gfn in self._n:
                    self._cond.wait()
            finally:
                self._waiting -= 1


class VirtualizationLayer:
    """Ties PhysicalMemory + Mpool + BlockTable + AddressSpace together.

    Created by the hot-switch (hotswitch.py). Guest accesses go through
    :meth:`guest_read` / :meth:`guest_write`; the manager's own metadata
    accesses use :meth:`root_access`.
    """

    def __init__(self, cfg: TaijiConfig, phys: PhysicalMemory, mpool: Mpool) -> None:
        self.cfg = cfg
        self.phys = phys
        self.mpool = mpool
        self.aspace = AddressSpace(cfg)
        self.table = BlockTable(cfg, mpool)
        # fault handler is installed by the swap engine; None -> faults raise
        self.fault_handler = None
        # per-MP presence probe, also installed by the engine (reads the
        # O(1) fault-descriptor table); a plain attribute so the hot
        # translate path pays one load instead of a getattr with default
        self.mp_present_probe = None
        # guest accesses in flight; the swap-out drains a gfn through it
        self.inflight = AccessGuard()

        # pin + identity-map the mpool arena (GPA == HPA contract)
        for gfn in range(cfg.mpool_reserve_ms):
            self.table.map_huge(gfn, gfn)
            self.table.set_pinned(gfn, True)

    # ---------------------------------------------------------- translation
    def translate(self, gpa: int) -> Tuple[int, int, int, int]:
        """GPA -> (gfn, mp, inner, pfn); raises EPTFault if non-resident.

        Lock-free: single-word numpy reads are atomic under the GIL. A
        caller that copies through the result holds the gfn in
        :attr:`inflight` from before this call until the copy is issued,
        so a swap-out racing it waits (see :class:`AccessGuard`).
        """
        gfn, mp, inner = self.aspace.gpa_to_gfn_mp(gpa)
        pfn = int(self.table.pfn[gfn])
        if pfn == NO_PFN:
            raise EPTFault(gfn, mp)
        if int(self.table.flags[gfn]) & F_SPLIT:
            # per-MP presence is tracked by the req; the engine installs a
            # presence probe so translation can consult it.
            probe = self.mp_present_probe
            if probe is not None and not probe(gfn, mp):
                raise EPTFault(gfn, mp)
        return gfn, mp, inner, pfn

    # -------------------------------------------------------- guest accesses
    def _enter_resolved(self, gva: int, nbytes: int) -> Tuple[int, int, int]:
        """Resolve an access of ``nbytes`` at ``gva``, faulting every MP it
        covers in; returns ``(gfn, off, pfn)`` with ``gfn`` entered in
        :attr:`inflight` (the caller issues its copy, then leaves).

        Faults are handled outside the guard. After one, the walk goes on
        from the faulted MP and then wraps round to the MPs before it, so
        the hold that returns has seen every MP present (one lost while
        another faulted comes back) at about two translations an MP."""
        gpa = self.aspace.gva_to_gpa(gva)
        gfn, mp, inner = self.aspace.gpa_to_gfn_mp(gpa)
        mp_bytes = self.cfg.mp_bytes
        off = mp * mp_bytes + inner
        if off + nbytes > self.cfg.ms_bytes:
            raise ValueError("guest access crosses an MS boundary")
        # may cross MP boundaries within the MS: every MP must be present
        first = gpa - inner - mp * mp_bytes       # MP 0 of this MS
        end_mp = max(mp, (off + nbytes - 1) // mp_bytes)
        guard = self.inflight
        translate = self.translate
        start = mp
        while True:
            guard.enter(gfn)
            try:
                pfn = translate(first + start * mp_bytes)[3]
                for m in range(start + 1, end_mp + 1):
                    translate(first + m * mp_bytes)
                for m in range(mp, start):
                    translate(first + m * mp_bytes)
            except EPTFault as f:
                guard.leave(gfn)
                if self.fault_handler is None:
                    raise
                self.fault_handler(f.gfn, f.mp)
                start = f.mp
                continue
            except BaseException:
                guard.leave(gfn)
                raise
            self.table.mark_accessed(gfn)
            return gfn, off, pfn

    def guest_read(self, gva: int, nbytes: int) -> bytes:
        gfn, off, pfn = self._enter_resolved(gva, nbytes)
        try:
            return frame_bytes(self.phys.ms_view(pfn)[off : off + nbytes])
        finally:
            self.inflight.leave(gfn)

    def guest_write(self, gva: int, data: bytes) -> None:
        gfn, off, pfn = self._enter_resolved(gva, len(data))
        try:
            self.phys.ms_view(pfn)[off : off + len(data)].copy_(host_u8(data))
        finally:
            self.inflight.leave(gfn)

    # ----------------------------------------------------------- root access
    def root_access(self, gpa: int) -> torch.Tensor:
        """Root-mode (single-layer) access: only legal for GPA == HPA
        memory. Returns the device view of the identity-mapped frame."""
        gfn = gpa // self.cfg.ms_bytes
        if not self.table.is_pinned(gfn) or int(self.table.pfn[gfn]) != gfn:
            raise InvalidStateError(
                f"root access to non-identity gfn {gfn}: GPA==HPA violated")
        return self.phys.ms_view(gfn)

    # ------------------------------------------------------------- utilities
    @property
    def free_ms(self) -> int:
        return self.phys.free_count

    def resident_gfns(self) -> List[int]:
        return [g for g in range(self.cfg.n_virt_ms)
                if int(self.table.pfn[g]) != NO_PFN and not self.table.is_pinned(g)]
