"""GuestSpace -- the one sanctioned guest-memory surface.

Taiji's promise is elasticity that is transparent to upper-layer
applications, but transparency only composes if every upper layer talks
to the same surface. Before this module, `ElasticKVCache`,
`ElasticExpertCache` and the fleet `NodeAgent` each drove
``TaijiSystem.read/write/ms_addr/guest_alloc_ms`` through their own glue,
so cross-cutting concerns (workload capture, verification, per-tenant
accounting, policy hooks) had no seam to hook.  ``GuestSpace`` is that
seam -- tracehm records at the access layer for the same reason: one
well-placed indirection layer owns everything that wants to see guest
accesses.

The API is gfn-relative (an MS handle plus an offset) rather than raw
guest-virtual addresses: callers never do address arithmetic, and every
access is bounds-checked against one MS.  Raw-GVA entry points
(``read_gva``/``write_gva``) exist for the ``TaijiSystem`` deprecation
shims and for code that already holds a packed address.

Observers (:class:`GuestObserver`) see every alloc/free/access/tick.
``repro.fleet.trace.TraceRecorder`` is the flagship observer: it turns a
live serving workload into a replayable fleet trace (see
``repro.fleet.capture``).  The observer list is almost always empty, so
the hot path pays one truthiness check.

Port: every read is a device-to-host copy of frame bytes (which waits
for the device stream) and every write a host-to-device copy; the
semantics are the reference's.

Two access tiers:

* scalar ``read``/``write`` carry an inline fast path -- when the MS is
  resident and unsplit, the access resolves through direct block-table
  word reads and one physical-buffer slice, skipping the generic
  fault-capable walk entirely (the paper's O2: translated access must
  stay near direct-DRAM cost).
* batch primitives ``read_many``/``write_many``/``gather``/``scatter``
  amortize bounds checks, residency probes, access-bit marking and
  observer dispatch over a whole (gfn, off, nbytes) batch: one numpy
  pass over the triples, one fancy-indexed block-table probe, one
  ``on_access_batch`` observer callback.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.tracer import (ST_GUEST_ACCESS, TAG_GATHER, TAG_READ,
                          TAG_READ_MANY, TAG_SCATTER, TAG_WRITE,
                          TAG_WRITE_MANY)
from .virt import F_ACCESSED, F_SPLIT, NO_PFN, frame_bytes, host_u8

_perf_ns = time.perf_counter_ns

# one observer event: (gfn, off, nbytes, is_write, data)
AccessEvent = Tuple[int, int, int, bool, Optional[bytes]]


class GuestObserver:
    """Protocol for guest-memory event observers (no-op base class).

    ``on_access`` fires after the access succeeded; ``data`` carries the
    bytes written (writes), the bytes returned (reads), or ``None`` for
    zero-length residency hints (batched touch / pin).

    ``on_access_batch`` fires once per batch primitive call
    (``read_many``/``write_many``/``gather``/``scatter``/``touch``); the
    default implementation replays the batch through scalar
    ``on_access``, so observers that only implement the scalar hook --
    ``TraceRecorder`` included -- see event streams identical to the
    equivalent scalar access sequence (pinned by
    tests/test_hotpath_batch.py).
    """

    def on_alloc(self, gfn: int) -> None:  # pragma: no cover - no-op base
        pass

    def on_free(self, gfn: int) -> None:  # pragma: no cover - no-op base
        pass

    def on_access(self, gfn: int, off: int, nbytes: int, is_write: bool,
                  data: Optional[bytes] = None) -> None:  # pragma: no cover
        pass

    def on_access_batch(self, events: Sequence[AccessEvent]) -> None:
        for gfn, off, nbytes, is_write, data in events:
            self.on_access(gfn, off, nbytes, is_write, data)

    def on_tick(self, rounds: int) -> None:  # pragma: no cover - no-op base
        pass


class MSView:
    """Typed window onto one MS: a dtype/shape bound to (gfn, offset).

    Guest memory is elastic -- the backing frame can be swapped out and
    faulted back between accesses -- so a view cannot hand out a live
    ndarray.  ``load()`` reads (faulting as needed) and ``store()``
    writes, both through the instrumented GuestSpace path.
    """

    __slots__ = ("space", "gfn", "dtype", "shape", "off", "nbytes")

    def __init__(self, space: "GuestSpace", gfn: int, dtype, shape,
                 off: int = 0) -> None:
        self.space = space
        self.gfn = gfn
        self.dtype = np.dtype(dtype)
        self.shape = tuple(shape)
        self.off = off
        self.nbytes = int(np.prod(self.shape)) * self.dtype.itemsize
        if off < 0 or off + self.nbytes > space.cfg.ms_bytes:
            raise ValueError(
                f"view [{off}, {off + self.nbytes}) exceeds MS "
                f"({space.cfg.ms_bytes} bytes)")

    def load(self) -> np.ndarray:
        raw = self.space.read(self.gfn, self.nbytes, off=self.off)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.shape)

    def store(self, arr: np.ndarray) -> None:
        if tuple(arr.shape) != self.shape:
            raise ValueError(f"array shape {arr.shape} != view {self.shape}")
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        self.space.write(self.gfn, arr.tobytes(), off=self.off)


class GuestSpace:
    """The guest-facing elastic-memory API over one :class:`TaijiSystem`.

    alloc/free, bounds-checked read/write, typed per-MS views, batched
    touch and pin residency hints -- with an observer protocol so capture
    and policy layers see every operation without per-caller glue.
    ``TaijiSystem.guest`` returns the canonical instance for a system.
    """

    def __init__(self, system, observers: Sequence[GuestObserver] = ()) -> None:
        self.system = system
        self.cfg = system.cfg
        self._observers: List[GuestObserver] = list(observers)
        # hot-path caches: read/write sit on benchmarked access paths, so
        # pay plain locals instead of attribute chains per call
        self._ms_bytes = system.cfg.ms_bytes
        self._n_virt = system.cfg.n_virt_ms
        self._guest_read = system.virt.guest_read
        self._guest_write = system.virt.guest_write
        # fast-path state: direct views of the block table and physical
        # buffer.  A resident, unsplit MS resolves with two int32 word
        # reads and one buffer slice, inside the in-flight guard: a
        # swap-out that unmaps the MS between probe and copy waits for
        # the copy to be issued before it reads the frame (AccessGuard)
        self._guard = system.virt.inflight
        self._pfn = system.virt.table.pfn
        self._flags = system.virt.table.flags
        self._buf = system.phys.frames
        # stage-attributed tracing (repro_torch.obs): one guest_access span per
        # primitive call, tagged with the access kind; None when disabled,
        # so the benchmarked scalar paths pay one truthiness check
        self._tr = system.metrics.tracer

    # ------------------------------------------------------------ observers
    def attach(self, observer: GuestObserver) -> GuestObserver:
        self._observers.append(observer)
        return observer

    def detach(self, observer: GuestObserver) -> None:
        self._observers.remove(observer)

    # ----------------------------------------------------------- alloc/free
    def alloc_ms(self) -> int:
        """Allocate one elastic MS (may trigger reclaim); returns its gfn."""
        gfn = self.system.guest_alloc_ms()
        for obs in self._observers:
            obs.on_alloc(gfn)
        return gfn

    def free_ms(self, gfn: int) -> None:
        self.system.guest_free_ms(gfn)
        for obs in self._observers:
            obs.on_free(gfn)

    # ----------------------------------------------------------- addressing
    def addr_of(self, gfn: int, mp: int = 0, off: int = 0) -> int:
        """Packed guest-virtual address of (gfn, mp, off)."""
        return gfn * self.cfg.ms_bytes + mp * self.cfg.mp_bytes + off

    # ------------------------------------------------------------------ I/O
    def write(self, gfn: int, data: bytes, off: int = 0) -> None:
        """Write ``data`` at ``off`` within one MS (may span MPs)."""
        ms_bytes = self._ms_bytes
        nbytes = len(data)
        # off == ms_bytes would resolve (and fault!) the *next* MS even
        # for a zero-length access, so the offset itself must be in-MS
        if off < 0 or off >= ms_bytes or off + nbytes > ms_bytes:
            raise ValueError(
                f"write [{off}, {off + nbytes}) exceeds MS "
                f"({ms_bytes} bytes)")
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        # fast path: resident, unsplit MS -> direct buffer store
        fast = False
        if 0 <= gfn < self._n_virt:
            guard = self._guard
            guard.enter(gfn)
            try:
                pfn = self._pfn[gfn]
                fast = pfn != NO_PFN and not self._flags[gfn] & F_SPLIT
                if fast:
                    self._flags[gfn] |= F_ACCESSED
                    base = int(pfn) * ms_bytes + off
                    self._buf[base:base + nbytes].copy_(host_u8(data))
            finally:
                guard.leave(gfn)
        if not fast:
            self._guest_write(gfn * ms_bytes + off, data)
        if tr is not None:
            tr.push(ST_GUEST_ACCESS, t0, _perf_ns() - t0, TAG_WRITE)
        if self._observers:
            data = bytes(data)
            for obs in self._observers:
                obs.on_access(gfn, off, nbytes, True, data)

    def read(self, gfn: int, nbytes: Optional[int] = None,
             off: int = 0) -> bytes:
        """Read ``nbytes`` at ``off`` within one MS (default: to MS end),
        faulting swapped MPs back in."""
        ms_bytes = self._ms_bytes
        if nbytes is None:
            nbytes = ms_bytes - off
        if off < 0 or off >= ms_bytes or nbytes < 0 or off + nbytes > ms_bytes:
            raise ValueError(
                f"read [{off}, {off + nbytes}) exceeds MS "
                f"({ms_bytes} bytes)")
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        # fast path: resident, unsplit MS -> direct buffer slice
        fast = False
        if 0 <= gfn < self._n_virt:
            guard = self._guard
            guard.enter(gfn)
            try:
                pfn = self._pfn[gfn]
                fast = pfn != NO_PFN and not self._flags[gfn] & F_SPLIT
                if fast:
                    self._flags[gfn] |= F_ACCESSED
                    base = int(pfn) * ms_bytes + off
                    data = frame_bytes(self._buf[base:base + nbytes])
            finally:
                guard.leave(gfn)
        if not fast:
            data = self._guest_read(gfn * ms_bytes + off, nbytes)
        if tr is not None:
            tr.push(ST_GUEST_ACCESS, t0, _perf_ns() - t0, TAG_READ)
        if self._observers:
            for obs in self._observers:
                obs.on_access(gfn, off, nbytes, False, data)
        return data

    # raw-GVA entry points (deprecation shims, packed-address callers)
    def write_gva(self, gva: int, data: bytes) -> None:
        gfn, off = divmod(gva, self._ms_bytes)
        self.write(gfn, data, off=off)

    def read_gva(self, gva: int, nbytes: int) -> bytes:
        gfn, off = divmod(gva, self._ms_bytes)
        return self.read(gfn, nbytes, off=off)

    # ------------------------------------------------------ batch primitives
    def _batch_probe(self, g: np.ndarray) -> np.ndarray:
        """One fancy-indexed block-table probe for a gfn vector: returns
        the fast-row mask (in-range, resident, unsplit) and marks the
        fast rows accessed in a single vectorized pass. The caller holds
        the in-range gfns in the in-flight guard (:meth:`_enter_batch`)
        until its fast rows' copies are issued."""
        inr = (g >= 0) & (g < self._n_virt)
        gc = np.where(inr, g, 0)
        fast = inr & (self._pfn[gc] != NO_PFN) & ((self._flags[gc] & F_SPLIT) == 0)
        if fast.any():
            # |= with fancy indexing is read-or-write; duplicate gfns are
            # fine because OR-ing the same bit is idempotent (same
            # lock-free idiom as BlockTable.mark_accessed)
            self._flags[g[fast]] |= F_ACCESSED
        return fast

    def _enter_batch(self, g: np.ndarray) -> List[int]:
        """Enter the batch's in-range gfns in the in-flight guard; returns
        them for the matching ``leave_many``. The fast rows are copied
        inside, the faulting rows after it (a fault may swap out any MS,
        and the guard must not be held across one)."""
        held = g[(g >= 0) & (g < self._n_virt)].tolist()
        self._guard.enter_many(held)
        return held

    def _check_batch_bounds(self, o: np.ndarray, n: np.ndarray,
                            what: str) -> None:
        ms_bytes = self._ms_bytes
        bad = (o < 0) | (o >= ms_bytes) | (n < 0) | (o + n > ms_bytes)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"{what}[{i}]: [{int(o[i])}, {int(o[i]) + int(n[i])}) "
                f"exceeds MS ({ms_bytes} bytes)")

    def read_many(self, reqs: Sequence[Tuple[int, int, int]]) -> List[bytes]:
        """Batched read over (gfn, off, nbytes) triples.

        Byte-equivalent to ``[read(g, n, off=o) for g, o, n in reqs]``
        but amortized: one numpy bounds pass, one block-table residency
        probe, one access-bit pass, one observer dispatch.  Rows whose MS
        is swapped/split fall back to the faulting walk individually (the
        fault dominates those rows anyway).
        """
        if not len(reqs):
            return []
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        arr = np.asarray(reqs, dtype=np.int64).reshape(-1, 3)
        g, o, n = arr[:, 0], arr[:, 1], arr[:, 2]
        self._check_batch_bounds(o, n, "read_many")
        held = self._enter_batch(g)
        ms_bytes = self._ms_bytes
        buf = self._buf
        out: List[Optional[bytes]] = [None] * len(g)
        try:
            fast = self._batch_probe(g)
            base = (self._pfn[np.where(fast, g, 0)].astype(np.int64)
                    * ms_bytes + o)
            # .tolist() once: per-row numpy scalar indexing costs ~100ns a
            # touch, which would hand back most of the amortization win
            fl, bl, nl = fast.tolist(), base.tolist(), n.tolist()
            for i, b in enumerate(bl):
                if fl[i]:
                    out[i] = frame_bytes(buf[b:b + nl[i]])
        finally:
            self._guard.leave_many(held)
        for i in range(len(out)):
            if not fl[i]:
                out[i] = self._guest_read(int(g[i]) * ms_bytes + int(o[i]),
                                          nl[i])
        if tr is not None:
            tr.push(ST_GUEST_ACCESS, t0, _perf_ns() - t0, TAG_READ_MANY)
        if self._observers:
            gl, ol = g.tolist(), o.tolist()
            events = [(gl[i], ol[i], nl[i], False, out[i])
                      for i in range(len(out))]
            self._dispatch_batch(events)
        return out

    def write_many(self, items: Sequence[Tuple[int, int, bytes]]) -> None:
        """Batched write over (gfn, off, data) triples; byte-equivalent to
        the scalar ``write`` loop with the same amortizations as
        :meth:`read_many`."""
        if not len(items):
            return
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        items = list(items)
        arr = np.asarray([(gfn, off, len(data)) for gfn, off, data in items],
                         dtype=np.int64)
        g, o, n = arr[:, 0], arr[:, 1], arr[:, 2]
        self._check_batch_bounds(o, n, "write_many")
        held = self._enter_batch(g)
        ms_bytes = self._ms_bytes
        buf = self._buf
        try:
            fast = self._batch_probe(g)
            base = (self._pfn[np.where(fast, g, 0)].astype(np.int64)
                    * ms_bytes + o)
            fl, bl, nl = fast.tolist(), base.tolist(), n.tolist()
            for i, (_, _, data) in enumerate(items):
                if fl[i]:
                    b = bl[i]
                    buf[b:b + nl[i]].copy_(host_u8(data))
        finally:
            self._guard.leave_many(held)
        for i, (_, _, data) in enumerate(items):
            if not fl[i]:
                self._guest_write(int(g[i]) * ms_bytes + int(o[i]), data)
        if tr is not None:
            tr.push(ST_GUEST_ACCESS, t0, _perf_ns() - t0, TAG_WRITE_MANY)
        if self._observers:
            gl, ol = g.tolist(), o.tolist()
            events = [(gl[i], ol[i], nl[i], True, bytes(data))
                      for i, (_, _, data) in enumerate(items)]
            self._dispatch_batch(events)

    def gather(self, gfns: Sequence[int], dtype=np.uint8,
               shape: Optional[Sequence[int]] = None,
               off: int = 0) -> np.ndarray:
        """Whole-MS typed batch read: stacked ``(len(gfns), *shape)``
        array, one typed window per MS (default: the full MS as uint8).
        Equivalent to ``np.stack([view(g, dtype, shape, off).load() for g
        in gfns])`` minus the per-view dispatch."""
        dtype = np.dtype(dtype)
        if shape is None:
            shape = ((self._ms_bytes - off) // dtype.itemsize,)
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if off < 0 or off >= self._ms_bytes or off + nbytes > self._ms_bytes:
            raise ValueError(
                f"gather [{off}, {off + nbytes}) exceeds MS "
                f"({self._ms_bytes} bytes)")
        g = np.asarray(list(gfns), dtype=np.int64)
        if g.size == 0:
            return np.empty((0,) + shape, dtype)
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        ms_bytes = self._ms_bytes
        raw = np.empty((g.size, nbytes), np.uint8)
        held = self._enter_batch(g)
        try:
            fast = self._batch_probe(g)
            base = (self._pfn[np.where(fast, g, 0)].astype(np.int64)
                    * ms_bytes + off)
            fl, bl, gl = fast.tolist(), base.tolist(), g.tolist()
            for i in range(g.size):
                if fl[i]:
                    b = bl[i]
                    raw[i] = self._buf[b:b + nbytes].cpu().numpy()
        finally:
            self._guard.leave_many(held)
        for i in range(g.size):
            if not fl[i]:
                raw[i] = np.frombuffer(
                    self._guest_read(gl[i] * ms_bytes + off, nbytes),
                    np.uint8)
        if tr is not None:
            tr.push(ST_GUEST_ACCESS, t0, _perf_ns() - t0, TAG_GATHER)
        if self._observers:
            events = [(gl[i], off, nbytes, False, raw[i].tobytes())
                      for i in range(g.size)]
            self._dispatch_batch(events)
        return raw.view(dtype).reshape((g.size,) + shape)

    def scatter(self, gfns: Sequence[int], arr: np.ndarray,
                off: int = 0) -> None:
        """Whole-MS typed batch write: ``arr[i]`` is stored at ``off`` in
        ``gfns[i]``.  Equivalent to the ``view(...).store(arr[i])`` loop
        minus the per-view dispatch."""
        g = np.asarray(list(gfns), dtype=np.int64)
        arr = np.ascontiguousarray(arr)
        if len(arr) != g.size:
            raise ValueError(f"scatter: {g.size} gfns but {len(arr)} rows")
        if g.size == 0:
            return
        nbytes = arr[0].nbytes
        if off < 0 or off >= self._ms_bytes or off + nbytes > self._ms_bytes:
            raise ValueError(
                f"scatter [{off}, {off + nbytes}) exceeds MS "
                f"({self._ms_bytes} bytes)")
        rows = arr.reshape(g.size, -1).view(np.uint8).reshape(g.size, nbytes)
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        ms_bytes = self._ms_bytes
        held = self._enter_batch(g)
        try:
            fast = self._batch_probe(g)
            base = (self._pfn[np.where(fast, g, 0)].astype(np.int64)
                    * ms_bytes + off)
            fl, bl, gl = fast.tolist(), base.tolist(), g.tolist()
            for i in range(g.size):
                if fl[i]:
                    b = bl[i]
                    self._buf[b:b + nbytes].copy_(host_u8(rows[i]))
        finally:
            self._guard.leave_many(held)
        for i in range(g.size):
            if not fl[i]:
                self._guest_write(gl[i] * ms_bytes + off,
                                  rows[i].tobytes())
        if tr is not None:
            tr.push(ST_GUEST_ACCESS, t0, _perf_ns() - t0, TAG_SCATTER)
        if self._observers:
            events = [(gl[i], off, nbytes, True, rows[i].tobytes())
                      for i in range(g.size)]
            self._dispatch_batch(events)

    def _dispatch_batch(self, events: Sequence[AccessEvent]) -> None:
        for obs in self._observers:
            cb = getattr(obs, "on_access_batch", None)
            if cb is not None:
                cb(events)
            else:  # duck-typed observer without the batch hook
                for ev in events:
                    obs.on_access(*ev)

    # ---------------------------------------------------------- typed views
    def view(self, gfn: int, dtype, shape, off: int = 0) -> MSView:
        """Typed per-MS view: ``view(...).load()/store(arr)``."""
        return MSView(self, gfn, dtype, shape, off=off)

    # ------------------------------------------------- residency / pin hints
    def touch(self, gfns: Iterable[int], *, mark_accessed: bool = True) -> int:
        """Batched residency hint: swap each MS's cold MPs back in and mark
        it accessed.  Returns how many MSs actually needed a swap-in.
        Observers see one zero-length access per MS (a ``touch`` op in a
        captured trace), so replays reproduce the faulting pattern."""
        gfns = list(gfns)
        faulted = 0
        if gfns:
            g = np.asarray(gfns, dtype=np.int64)
            # vectorized residency pre-filter: only swapped (NO_PFN) or
            # split MSs can have swapped-out MPs (swap-out always splits
            # first), so resident+unsplit rows skip the req lookup
            cand = (self._pfn[g] == NO_PFN) | ((self._flags[g] & F_SPLIT) != 0)
            for gfn in (int(x) for x in g[cand]):
                req = self.system.reqs.lookup(gfn)
                if ((req is not None and req.record.swapped_out_count() > 0)
                        or int(self._pfn[gfn]) == NO_PFN):
                    self.system.engine.swap_in_ms(gfn)
                    faulted += 1
            if mark_accessed:
                self._flags[g] |= F_ACCESSED
        self._notify_touch(gfns)
        return faulted

    def hint_accessed(self, gfns: Iterable[int]) -> None:
        """Mark MSs hot for the LRU without faulting anything in (e.g. a
        router reporting which experts a batch activates)."""
        gfns = list(gfns)
        if gfns:
            self._flags[np.asarray(gfns, dtype=np.int64)] |= F_ACCESSED
        self._notify_touch(gfns)

    @contextmanager
    def pin(self, gfns: Iterable[int]):
        """Swap in + pin a working set for one in-flight step (the DMA
        no-retry contract); unpins on exit."""
        gfns = list(gfns)
        self._notify_touch(gfns)
        with self.system.dma.pin_for_step(gfns):
            yield

    def _notify_touch(self, gfns: Sequence[int]) -> None:
        if self._observers:
            self._dispatch_batch([(int(gfn), 0, 0, False, None)
                                  for gfn in gfns])

    def residency(self, gfns: Optional[Iterable[int]] = None) -> Dict[str, int]:
        """Resident/swapped MS counts over ``gfns`` (default: every
        guest-allocatable MS with a req record or a frame)."""
        table = self.system.virt.table
        if gfns is None:
            gfns = range(self.cfg.mpool_reserve_ms, self.cfg.n_virt_ms)
            resident = swapped = 0
            for gfn in gfns:
                if int(table.pfn[gfn]) != NO_PFN:
                    resident += 1
                elif self.system.reqs.lookup(gfn) is not None:
                    swapped += 1
        else:
            g = np.asarray(list(gfns), dtype=np.int64)
            resident = int(np.count_nonzero(table.pfn[g] != NO_PFN)) if g.size else 0
            swapped = int(g.size) - resident
        return {"resident": resident, "swapped": swapped,
                "total": resident + swapped}

    # ------------------------------------------------------------ background
    def step_background(self, rounds: int = 1, *, reclaim: bool = True) -> int:
        """Run deterministic background rounds (LRU scans + reclaim) and
        tell observers -- captured traces carry the tick so replays age
        and reclaim at the same workload points.  Returns MPs reclaimed."""
        reclaimed = 0
        for _ in range(rounds):
            reclaimed += self.system.step_background(reclaim=reclaim)
        for obs in self._observers:
            obs.on_tick(rounds)
        return reclaimed
