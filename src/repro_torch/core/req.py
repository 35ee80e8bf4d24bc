"""Swap request entities and their concurrency control (paper §4.2.2, Fig 8).

Four atomicity layers, reproduced 1:1:

  1. **req abstraction** -- one req per MS, unique, stored in a red-black
     tree for efficient page-fault lookup; independent MS-level locks allow
     parallel swaps of different MSs.
  2. **read-write lock** -- active tasks (Swap_out / prefetch Swap_in) are
     serialized via the write lock; passive fault-driven swap-ins take read
     locks and run in parallel. On conflict, a *cancel* mechanism makes the
     write-locked task exit promptly (Fig 8 (2.2)).
  3. **execution bitmaps** -- ``bm_out`` (already swapped out) gates what may
     swap in; ``bm_in`` (currently swapping in) gives exactly-once swap-in
     per MP when multiple faults hit the same MP (Fig 8 (3.3)).
  4. **MS/MP state control** -- exactly-once split/reclaim/alloc/merge at
     defined transitions (Fig 8 (4.1)/(7)), guarded by the per-req mutex.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..analysis.lock_order import STATE as _LOCKDEP, named_lock
from .config import TaijiConfig
from .errors import InvalidStateError
from .mpool import Mpool
from .ms import MSRecord, record_field_offsets
from .rbtree import RBTree


class WriteGrant:
    """Held by the single active writer; readers set ``cancelled``."""

    __slots__ = ("cancelled",)

    def __init__(self) -> None:
        self.cancelled = False


class RWLockWriterCancel:
    """MS-level read-write lock with writer cancellation.

    Readers (passive fault swap-ins) may always make progress: if a writer
    holds the lock, arriving readers flag it for cancellation and block
    until it exits (the writer polls :attr:`WriteGrant.cancelled` at safe
    points and aborts promptly). Writers are mutually exclusive and wait
    for all readers to drain.

    Lockdep: the grant itself is a *virtual* lock entity of class
    ``req.rwlock`` (rank below the mp_mutex -- a grant is taken before
    the mutex, never under it except by trylock). The hooks fire outside
    the internal condition lock so the witness never sees a false
    cond -> rwlock edge; with the witness off each hook costs one
    truthiness check. ``group`` links the grant to the owning req's
    mp_mutex for the gate exemption (the bailout gate).
    """

    def __init__(self, group: object = None) -> None:
        self._cond = threading.Condition(named_lock("req.rwlock.cond", group))
        self._readers = 0
        self._writer: Optional[WriteGrant] = None
        self._group = group
        self.cancel_count = 0  # stats: how often readers bumped a writer

    # --------------------------------------------------------------- readers
    def acquire_read(self) -> None:
        if _LOCKDEP.on:
            from ..analysis import witness
            witness.push_virtual(witness.RWLOCK_CLASS, self._group,
                                 id(self), write=False)
        with self._cond:
            if self._writer is not None and not self._writer.cancelled:
                self._writer.cancelled = True
                self.cancel_count += 1
            while self._writer is not None:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()
        if _LOCKDEP.on:
            from ..analysis import witness
            witness.pop_virtual(id(self))

    # --------------------------------------------------------------- writers
    def acquire_write(self, blocking: bool = True) -> Optional[WriteGrant]:
        if _LOCKDEP.on and blocking:
            from ..analysis import witness
            witness.push_virtual(witness.RWLOCK_CLASS, self._group,
                                 id(self), write=True)
        with self._cond:
            if not blocking and (self._writer is not None or self._readers > 0):
                return None
            while self._writer is not None or self._readers > 0:
                self._cond.wait()
            self._writer = WriteGrant()
            grant = self._writer
        if _LOCKDEP.on and not blocking:
            from ..analysis import witness
            witness.push_virtual(witness.RWLOCK_CLASS, self._group,
                                 id(self), write=True, trylock=True)
        return grant

    def release_write(self, grant: WriteGrant) -> None:
        with self._cond:
            if self._writer is not grant:
                raise InvalidStateError("releasing a write grant not held")
            self._writer = None
            self._cond.notify_all()
        if _LOCKDEP.on:
            from ..analysis import witness
            witness.pop_virtual(id(self))


class Req:
    """Per-MS swap request entity: record + lock + fine-grained MP mutex."""

    __slots__ = ("gfn", "record", "rwlock", "mp_mutex", "mp_cond", "fdesc")

    def __init__(self, gfn: int, record: MSRecord) -> None:
        self.gfn = gfn
        self.record = record
        self.rwlock = RWLockWriterCancel(group=gfn)
        # short mutex guarding bitmap/state transitions (word-level CAS in
        # the kernel; a tiny critical section here), plus a condition used
        # by faults waiting on an in-flight IO for the same MP (Fig 8 (3.3)).
        # The GFN group ties the mutex to the rwlock grant above: nesting
        # mp_mutex under mp_mutex is legal only with the write grant held
        self.mp_mutex = named_lock("req.mp_mutex", group=gfn)
        self.mp_cond = threading.Condition(self.mp_mutex)
        # plain-int arena offsets (header/bm_out/bm_in/kinds/crc), filled
        # by FaultDescTable.register -- the fault fast path unpacks this
        # tuple instead of chasing record attributes / numpy boxing
        self.fdesc = None

    # convenience accessors used by the virtualization layer's presence probe
    def mp_present(self, mp: int) -> bool:
        r = self.record
        return not r.is_swapped_out(mp) and not r.is_swapping_in(mp)


class FaultDescTable:
    """Flat O(1) fault descriptors, indexed by GFN.

    The page-fault path carries the paper's 10 us P90 budget (O2), so it
    cannot afford an rbtree walk plus ``Req``/``MSRecord`` attribute
    chasing per fault. This table keeps, per GFN, the *arena offsets* of
    the req's persistent record fields -- header word (state/pfn/present),
    ``bm_out``/``bm_in`` bitmap words, backend kinds and per-MP CRCs --
    plus typed views of the whole mpool arena to index with them. A fault
    reads everything it needs with a couple of array loads; the red-black
    tree remains the slow-path source of truth (and what the property
    tests check).

    The offsets live as a plain-int tuple on each :class:`Req`
    (``fdesc``: header/bm_out/bm_in/kinds/crc indexes into the typed
    views) so the hot path pays one list index + one tuple unpack instead
    of five numpy scalar boxings; the ``hdr`` column is the flat per-GFN
    validity word (also what invariant checks compare against).

    Consistency: rows are published by :meth:`register` *after* the req is
    fully constructed (``reqs[gfn]`` is the publication gate) and retired
    by :meth:`unregister` under the ReqTree lock. All *uses* that mutate
    record state happen under the owning req's ``mp_mutex``, exactly like
    the locked path, so descriptor reads are never torn.
    """

    def __init__(self, cfg: TaijiConfig, arena: np.ndarray) -> None:
        self.cfg = cfg
        n = cfg.n_virt_ms
        self.n = n
        self._off = record_field_offsets(cfg)
        # typed whole-arena views (the arena is 8-byte sized and aligned)
        self.a8 = arena
        self.i64 = arena.view(np.int64)
        self.u64 = arena.view(np.uint64)
        self.u32 = arena.view(np.uint32)
        # hdr < 0 means "no descriptor" (set last on register, first on
        # retire); the field offsets themselves ride on Req.fdesc
        self.hdr = np.full(n, -1, dtype=np.int64)     # int64 index of header
        self.reqs: List[Optional[Req]] = [None] * n
        # slab offsets are size-class aligned (>= 32B), so the 8-byte
        # fields always align; the uint32 CRC column only aligns when the
        # kinds column (mps_per_ms bytes) is a multiple of 4
        self.enabled = cfg.mps_per_ms % 4 == 0

    def register(self, gfn: int, req: Req) -> None:
        base = req.record.handle.offset
        off = self._off
        req.fdesc = (base >> 3, (base + off["bm_out"]) >> 3,
                     (base + off["bm_in"]) >> 3, base + off["kinds"],
                     (base + off["crc"]) >> 2)
        self.hdr[gfn] = base >> 3
        self.reqs[gfn] = req

    def unregister(self, gfn: int) -> None:
        self.reqs[gfn] = None
        self.hdr[gfn] = -1

    def quiesce(self, gfn: int) -> None:
        """Teardown barrier: make the GFN invisible to the lock-light
        fault fast path and wait out any in-flight fast fault.

        The fast path re-validates ``hdr[gfn]`` *after* acquiring the
        req's ``mp_mutex``, so clearing it here and then bouncing through
        the mutex guarantees no fast fault can still be touching the
        frame or record when the caller proceeds to unmap/free. The req
        row stays published for slow-path parity; :meth:`unregister`
        retires it fully.
        """
        req = self.reqs[gfn]
        self.hdr[gfn] = -1
        if req is not None:
            req.mp_mutex.acquire()
            req.mp_mutex.release()


class ReqTree:
    """All reqs, keyed by GFN in a red-black tree (paper Fig 8 (1.1-1.3))."""

    def __init__(self, cfg: TaijiConfig, mpool: Mpool) -> None:
        self.cfg = cfg
        self.mpool = mpool
        self._tree = RBTree()
        self._lock = named_lock("req.tree")
        # fast-path cache: dict lookups are O(1); the RB tree remains the
        # authoritative ordered structure (and is what property tests check)
        self._cache: Dict[int, Req] = {}
        # O(1) fault descriptors over the mpool arena (survives hot
        # upgrades with the tree: record handles are stable)
        self.table = FaultDescTable(cfg, mpool.buffer)

    def lookup(self, gfn: int) -> Optional[Req]:
        req = self._cache.get(gfn)
        if req is not None:
            return req
        with self._lock:
            return self._tree.find(gfn)

    def get_or_create(self, gfn: int, pfn: int) -> Req:
        """Fetch the req for ``gfn`` or create one on initial swap-out."""
        req = self.lookup(gfn)
        if req is not None:
            return req
        with self._lock:
            req = self._tree.find(gfn)
            if req is None:
                record = MSRecord.allocate(self.cfg, self.mpool, gfn, pfn)
                req = Req(gfn, record)
                self._tree.insert(gfn, req)
                self._cache[gfn] = req
                self.table.register(gfn, req)
            return req

    def quiesce_fast_faults(self, gfn: int) -> None:
        """See :meth:`FaultDescTable.quiesce` (called by MS teardown
        after it holds the req's write lock). Deliberately does NOT take
        the tree lock: the mutex bounce must not nest under it (reclaim
        paths acquire the tree lock while holding a req mutex), and the
        row read + validity store are GIL-atomic. This constraint is
        machine-checked: it is the declared anti-edge
        ``("req.tree", "req.mp_mutex")`` in
        :mod:`repro_torch.analysis.lock_order`, and the runtime witness raises
        on any nest that violates it (tests/test_lockdep.py)."""
        self.table.quiesce(gfn)

    def remove(self, gfn: int) -> None:
        with self._lock:
            self.table.unregister(gfn)
            req: Req = self._tree.delete(gfn)
            self._cache.pop(gfn, None)
            self.mpool.slab_free(req.record.handle)

    def __len__(self) -> int:
        return len(self._tree)

    def items(self):
        with self._lock:
            return list(self._tree.items())

    def check_invariants(self) -> None:
        with self._lock:
            self._tree.check_invariants()
            for gfn, req in self._tree.items():
                assert req.gfn == gfn == req.record.gfn
                assert self.table.reqs[gfn] is req
                assert int(self.table.hdr[gfn]) == req.record.handle.offset >> 3
                assert req.fdesc is not None and req.fdesc[0] == \
                    req.record.handle.offset >> 3
