"""Parallel low-latency swap engine (paper §4.2.2, Fig 8).

Task types, as in the paper:

  * ``Fault_in``  -- passive, page-fault triggered. Read-locks the req
    (cancelling any active writer), performs an exactly-once MP swap-in
    guarded by the ``bm_in`` bitmap, and merges the MS when the last MP
    returns. Latency-critical: P90 < 10 us (O2).
  * ``Swap_out``  -- active, proactive reclamation. Write-locks the req
    (serialized, cancellable between MPs), unmaps each MP *before* copying
    it to the backend (the bm_in bit doubles as an in-flight IO latch so a
    racing fault waits rather than reading torn data), splits the mapping
    at the first MP and reclaims the physical MS after the last.
  * ``Swap_in``   -- active prefetch/compaction. Write-locked like
    Swap_out; used by the framework integration to prefetch blocks for the
    next step (beyond-paper overlap) and to re-merge fragmented MSs.

Watermark integration: the background reclaim round runs at BACK priority
under hv_sched; the min watermark triggers synchronous proactive swap-out
on the fault/allocation path (§4.2.2 end).

Port: MS frames are device tensors. Swap-out hands the frame and a
chunk's MP indices to ``BackendStore.store_batch``, which reads them
once on the device and copies only the non-zero rows to the host;
swap-in decodes on the host, uploads the
rows once and writes them into the frame in place, their extent tags
checked in the same launch (``ops.scatter_verified_rows_``) -- no
whole-frame copy. Zero-page faults are an
asynchronous device memset. All of it runs on the device's current
stream, which every thread shares, so copies issued by the hv_sched
reclaim threads and by the guest stay ordered; and a swap-out drains the
guest copies in flight to its MS (``virt.AccessGuard``) after the unmap
and before it reads the frame, so none lands after the read.
"""
from __future__ import annotations

import time
import zlib as _zlib
from typing import List, Optional

import numpy as _np

from .backend import BackendStore
from .config import TaijiConfig
from .errors import CorruptionError, OutOfMemoryError, PinnedError
from .lru import MultiLevelLRU
from ..obs.tracer import (H2D, ST_BACKEND_LOAD, ST_BACKEND_STORE,
                          ST_FAULT_ALLOC, ST_FAULT_BACKEND, ST_FAULT_COPY,
                          ST_FAULT_DESC, ST_FAULT_MUTEX, ST_FAULT_READAHEAD,
                          ST_FAULT_TOTAL, ST_READAHEAD_DECODE,
                          ST_RECLAIM_ROUND, ST_SWAP_IN, ST_SWAP_OUT)
from .metrics import (FK_COMPRESSED, FK_FAST, FK_OTHER, FK_READAHEAD,
                      FK_ZERO, Metrics)
from .ms import (H_PFN, H_PRESENT, H_STATE, K_COMPRESSED, K_FREE,
                 K_NONE, K_ZERO, MS_RESIDENT, MS_SWAPPED)
from .req import Req, ReqTree
from .virt import F_PINNED, NO_PFN, VirtualizationLayer, to_host
from .watermark import WatermarkPolicy

_perf_ns = time.perf_counter_ns
_U64 = _np.uint64
_MASK64 = 0xFFFFFFFFFFFFFFFF


class SwapEngine:
    def __init__(self, cfg: TaijiConfig, virt: VirtualizationLayer,
                 backend: BackendStore, reqs: ReqTree, lru: MultiLevelLRU,
                 watermark: WatermarkPolicy, metrics: Metrics) -> None:
        self.cfg = cfg
        self.virt = virt
        self.backend = backend
        self.reqs = reqs
        self.lru = lru
        self.watermark = watermark
        self.metrics = metrics

        # fault fast-path working set, hoisted out of the per-fault budget:
        # the O(1) descriptor table, the flat physical buffer, geometry
        # constants and the constant zero-page CRC
        self._ft = reqs.table
        # descriptor-table views hoisted one level further: the
        # arrays are built once, so the fast path loads them off self
        # instead of chasing reqs.table each fault
        self._u64 = reqs.table.u64
        self._i64 = reqs.table.i64
        self._a8 = reqs.table.a8
        self._u32 = reqs.table.u32
        self._hdr = reqs.table.hdr
        self._reqrows = reqs.table.reqs
        self._phys = virt.phys
        self._buf = virt.phys.frames
        self._flags = virt.table.flags   # stable array, built once
        self._ms_bytes = cfg.ms_bytes
        self._mp_bytes = cfg.mp_bytes
        self._mps = cfg.mps_per_ms
        self._zero_crc = backend.zero_crc
        self._crc_on = cfg.backend.crc_enabled
        self._fast = cfg.swap.fast_fault_enabled and reqs.table.enabled
        self._readahead = cfg.swap.readahead_enabled
        # contention-free admission state: the fast path reads
        # the epoch-published watermark flag instead of recomputing
        # is_critical(free_ms) under the mp_mutex, and defers LRU joins
        # into a lock-free pending ring (plain list; append/pop are
        # GIL-atomic) drained off the fault budget
        self._wm = watermark
        self._lru_pending: List[int] = []
        watermark.publish(virt.free_ms)  # first epoch: faults before the
        # first background round see the true initial zone
        # stage-attributed span tracer (repro_torch.obs); None unless
        # ObsConfig.enabled -- every traced site guards on `is not None`
        self._tr = metrics.tracer
        # deferred fast-path counters ride the ring flush; tell it whether
        # each fast fault performed a CRC compare
        metrics.fault_ring.count_crc = self._crc_on

        # install ourselves as the virtualization layer's fault handler and
        # per-MP presence probe (EPT-violation exit -> Fault_in)
        virt.fault_handler = self.fault_in
        virt.mp_present_probe = self._mp_present

    # ------------------------------------------------------------ presence
    def _mp_present(self, gfn: int, mp: int) -> bool:
        req = self._ft.reqs[gfn]
        if req is None:
            return True
        return req.mp_present(mp)

    # ========================================================== Fault_in ==
    def fault_in(self, gfn: int, mp: int) -> None:
        """Passive swap-in of one MP; parallel across MPs and MSs.

        Zero-page ultrafast path (the production-dominant 76.79% case,
        Fig 15c): descriptor-table loads + memset + constant-CRC compare +
        in-word bitmap clear under the req's short ``mp_mutex`` only. No
        rbtree walk, no read-write-lock round trip, no condition-variable
        wait, no per-fault zlib call, and the latency sample is one ring
        store. First faults into a fully swapped MS allocate their slot
        inline (exactly-once, same mutex the locked path allocates
        under). Safe without the rwlock because every writer mutation of
        record state happens inside the same ``mp_mutex`` critical
        sections (Fig 8 (3.3)/(4.1)); a fault that cannot take this exit
        (non-zero kind, in-flight IO) falls back to the locked scalar
        path, which still cancels active writers (2.2).
        """
        tr = self._tr
        t0 = _perf_ns() if tr is None else tr.begin(ST_FAULT_TOTAL)
        m = self.metrics
        m.faults += 1
        if self._flags[gfn] & F_PINNED:   # lock-free read
            # fault on a registered DMA range: intercepted DMAR exception
            m.dmar_intercepts += 1
        req = self._reqrows[gfn]
        if req is None:
            raise OutOfMemoryError(f"fault on unmanaged swapped gfn {gfn}")

        if self._fast:
            hdr, bmo, bmi, kio, cro = req.fdesc
            w = mp >> 6
            bit = 1 << (mp & 63)
            u64 = self._u64
            i64 = self._i64
            done = 0
            pfn = -1
            lock = req.mp_mutex
            if tr is not None:
                t_lk = _perf_ns()
            lock.acquire()
            try:
                if tr is not None:
                    t_in = _perf_ns()
                    tr.push(ST_FAULT_MUTEX, t_lk, t_in - t_lk)
                ow = 0
                # validity re-check under the mutex: hdr=-1 means
                # teardown quiesced the GFN, and the row must still hold
                # OUR req -- a free+realloc can re-arm the gate for a new
                # req (even at the same slab base) while we hold the old
                # one's mutex (ABA)
                if self._reqrows[gfn] is req and self._hdr[gfn] >= 0:
                    ow = int(u64[bmo + w])
                    if not ow & bit:
                        done = 2            # another fault already resolved it
                    elif (self._a8[kio + mp] == K_ZERO
                          and not int(u64[bmi + w]) & bit):
                        # pfn >= 0 here means MS_PARTIAL: with bm_out set
                        # the state cannot be RESIDENT, and SWAPPED
                        # implies pfn=-1
                        pfn = int(i64[hdr + H_PFN])
                        if pfn < 0 and i64[hdr + H_STATE] == MS_SWAPPED \
                                and not self._wm.published_critical:
                            # exactly-once first-in alloc (Fig 8 state).
                            # Only the magazine/leaf-locked slot pop is
                            # allowed here: the critical/exhausted case
                            # must reclaim through the slow path, whose
                            # rwlock read grant is what lets a concurrent
                            # reclaimer's non-blocking write acquisition
                            # skip this MS (holding mp_mutex while waiting
                            # on another req's mutex could cycle). The
                            # published critical flag is stale by at most
                            # one publish cadence, and only in the safe
                            # direction: a stale `critical` sends us to
                            # the slow path, which re-verifies against
                            # the live free count
                            if tr is not None:
                                t_al = _perf_ns()
                            slot = self._phys.try_alloc_slot()
                            if slot is not None:
                                pfn = slot
                                req.record.on_first_swap_in(pfn)
                                self.virt.table.map_split(gfn, pfn)
                                # LRU join deferred off the fault budget:
                                # drained by step_background / slow-path
                                # entry / reclaim (eventually-exact order)
                                self._lru_pending.append(gfn)
                            if tr is not None:
                                tr.push(ST_FAULT_ALLOC, t_al,
                                        _perf_ns() - t_al)
                if tr is not None:
                    t_cp = _perf_ns()
                    tr.push(ST_FAULT_DESC, t_in, t_cp - t_in)
                if pfn >= 0:
                    o = pfn * self._ms_bytes + mp * self._mp_bytes
                    # asynchronous device memset: no stream sync here
                    self._buf[o : o + self._mp_bytes].zero_()
                    if self._crc_on and self._u32[cro + mp] != self._zero_crc:
                        m.crc_checks += 1
                        m.crc_failures += 1
                        raise CorruptionError(
                            f"zero-page CRC mismatch gfn={gfn} mp={mp}")
                    u64[bmo + w] = ow & ~bit & _MASK64
                    self._a8[kio + mp] = K_NONE
                    pc = int(i64[hdr + H_PRESENT]) + 1
                    i64[hdr + H_PRESENT] = pc
                    # fault_zero_pages / fault_fast_path / crc_checks are
                    # deferred to the ring flush (FK_FAST tag); the
                    # exactly-once witness stays immediate
                    m.mp_swapped_in += 1
                    if pc == self._mps:     # last MP: merge (7)
                        # merge only when the bitmaps agree: an active
                        # writer's in-flight chunk is still counted in
                        # present_count (its decrement is deferred to
                        # chunk publish), so pc can transiently read
                        # mps_per_ms while chunk MPs sit latched -- the
                        # true last fault after the publish merges
                        rec = req.record
                        if not (rec.bm_out.any() or rec.bm_in.any()):
                            rec.on_last_swap_in()
                            self.virt.table.merge(gfn, pfn)
                            m.ms_swapped_in += 1
                            req.mp_cond.notify_all()
                    done = 1
                    if tr is not None:
                        tr.push(ST_FAULT_COPY, t_cp, _perf_ns() - t_cp)
            finally:
                lock.release()
            if done:
                fk = FK_ZERO | FK_FAST if done == 1 else FK_OTHER
                dur = _perf_ns() - t0
                m.fault_ring.push(dur, fk)
                if tr is not None:
                    tr.end(ST_FAULT_TOTAL, t0, fk, dur)
                return

        # slow path: locked scalar reference (cancels any active writer, 2.2)
        if self._lru_pending:
            # drain deferred fast-path LRU joins at slow-path entry so any
            # reclaim decision made below sees current ordering
            self.drain_lru_pending()
        if tr is not None:
            t_rw = _perf_ns()
        req.rwlock.acquire_read()
        try:
            if tr is not None:
                tr.push(ST_FAULT_MUTEX, t_rw, _perf_ns() - t_rw)
            fk = self._fault_in_locked(req, gfn, mp)
        finally:
            req.rwlock.release_read()
        dur = _perf_ns() - t0
        m.fault_ring.push(dur, fk)
        if tr is not None:
            tr.end(ST_FAULT_TOTAL, t0, fk, dur)

    def _fault_in_locked(self, req: Req, gfn: int, mp: int) -> int:
        """Locked scalar fault path. Returns the fault-kind code (FK_*)."""
        rec = req.record
        # inlined bitmap ops: the fault path carries the 10us-P90 budget
        # (O2), so word read-modify-writes act directly on the arena words
        # instead of going through per-bit helper calls
        w = mp >> 6
        bit = 1 << (mp & 63)
        tr = self._tr
        if tr is not None:
            t_lk = _perf_ns()
        with req.mp_cond:
            # wait out any in-flight IO on this MP (exactly-once, Fig 8 3.3)
            while int(rec.bm_in[w]) & bit:
                req.mp_cond.wait()
            if tr is not None:
                # mutex stage covers cond acquire + the IO-latch wait
                t_d0 = _perf_ns()
                tr.push(ST_FAULT_MUTEX, t_lk, t_d0 - t_lk)
            if not int(rec.bm_out[w]) & bit:
                if tr is not None:
                    tr.push(ST_FAULT_DESC, t_d0, _perf_ns() - t_d0)
                return FK_OTHER             # another fault already resolved it
            first_in = rec.state == MS_SWAPPED
            if first_in:
                if tr is not None:
                    t_al = _perf_ns()
                pfn = self._alloc_slot_critical()
                rec.on_first_swap_in(pfn)   # exactly-once alloc (Fig 8 state)
                self.virt.table.map_split(gfn, pfn)
                # the MS holds a physical slot again: it joins the hot set
                # now (Fig 14d) so partially-resident MSs stay reclaimable
                self.lru.note_swapped_in(gfn)
                if tr is not None:
                    # attribute slot allocation (and any synchronous
                    # critical reclaim inside it) to its own child stage
                    tr.push(ST_FAULT_ALLOC, t_al, _perf_ns() - t_al)
            else:
                pfn = rec.pfn
            kind = int(rec.kinds[mp])
            crc = int(rec.crc[mp])

            if kind == K_ZERO:
                # zero-page fast path (76.79% of production swap-ins,
                # Fig 15c): memset + constant-CRC check under the mutex --
                # no IO-latch round trip, no backend call
                if tr is not None:
                    t_cp = _perf_ns()
                    tr.push(ST_FAULT_DESC, t_d0, t_cp - t_d0)
                self.virt.phys.mp_view(pfn, mp).zero_()
                if self.cfg.backend.crc_enabled:
                    self.metrics.crc_checks += 1
                    if crc != self.backend.zero_crc:
                        self.metrics.crc_failures += 1
                        raise CorruptionError(
                            f"zero-page CRC mismatch gfn={gfn} mp={mp}")
                self.metrics.fault_zero_pages += 1
                rec.bm_out[w] = _U64(int(rec.bm_out[w]) & ~bit & _MASK64)
                rec.kinds[mp] = K_NONE
                rec.present_count += 1
                self.metrics.mp_swapped_in += 1
                if rec.present_count == self.cfg.mps_per_ms:
                    rec.on_last_swap_in()
                    self.virt.table.merge(gfn, rec.pfn)       # (7)
                    self.metrics.ms_swapped_in += 1
                req.mp_cond.notify_all()
                if tr is not None:
                    tr.push(ST_FAULT_COPY, t_cp, _perf_ns() - t_cp)
                return FK_ZERO

            rec.bm_in[w] = _U64(int(rec.bm_in[w]) | bit)
            ra = None
            if self._readahead and kind == K_COMPRESSED:
                # extent readahead (paper §3.3/Fig 8 parallel swapping):
                # the first fault into a compressed extent decompresses
                # the whole stream anyway -- claim every still-swapped
                # sibling MP (bm_in latch, exactly-once) so one pass
                # materializes them all and N future faults never happen
                ra = self._claim_extent_readahead(rec, gfn, mp)
            if tr is not None:
                tr.push(ST_FAULT_DESC, t_d0, _perf_ns() - t_d0)

        if ra is not None:
            return self._readahead_fill(req, gfn, mp, crc, pfn, ra)

        # backend IO outside the mutex (readers of other MPs stay parallel)
        if tr is not None:
            t_b = _perf_ns()
        ok = False
        try:
            self.backend.load(gfn, mp, kind, crc, self.virt.phys.mp_view(pfn, mp))
            ok = True
        finally:
            if tr is not None:
                t_p = _perf_ns()
                tr.push(ST_FAULT_BACKEND, t_b, t_p - t_b)
                if ok and kind != K_FREE:       # a free page is a memset
                    tr.copy(ST_FAULT_BACKEND, H2D, self._mp_bytes)
            with req.mp_cond:
                rec.bm_in[w] = _U64(int(rec.bm_in[w]) & ~bit & _MASK64)
                if ok:
                    rec.bm_out[w] = _U64(int(rec.bm_out[w]) & ~bit & _MASK64)
                    rec.kinds[mp] = K_NONE
                    rec.present_count += 1
                    self.metrics.mp_swapped_in += 1
                    if rec.present_count == self.cfg.mps_per_ms:
                        rec.on_last_swap_in()
                        self.virt.table.merge(gfn, rec.pfn)   # (7)
                        self.metrics.ms_swapped_in += 1
                req.mp_cond.notify_all()
            if tr is not None:
                tr.push(ST_FAULT_COPY, t_p, _perf_ns() - t_p)
        if kind == K_COMPRESSED:
            return FK_COMPRESSED
        return FK_ZERO if kind == K_FREE else FK_OTHER

    # ------------------------------------------------------ extent readahead
    def _claim_extent_readahead(self, rec, gfn: int, mp: int):
        """Claim the faulting extent's still-swapped sibling MPs.

        Called under ``mp_cond``. Returns ``(eid, my_row, idxs, rows,
        crcs)`` with ``idxs`` the claimed sibling MP index vector (bm_in
        latched here) and ``rows`` their extent rows, or ``None`` when the
        entry is a standalone blob. Only siblings whose live backend entry
        still references this extent are eligible (a consumed-then-re-
        swapped MP may appear in the stored member list with stale rows).
        """
        probe = self.backend.extent_members(gfn, mp)
        if probe is None:
            return None
        eid, my_row, live = probe
        # pure-int word math: numpy scatter ufuncs (np.bitwise_or.at) cost
        # tens of us per call on the target box, so eligibility and the
        # bm_in latch are computed on Python ints over the few (<= 8)
        # bitmap words and stored back one word at a time
        bm_out, bm_in = rec.bm_out, rec.bm_in
        nw = len(bm_out)
        ow = [int(x) for x in bm_out]
        iw = [int(x) for x in bm_in]
        claim: List[tuple] = []
        cw = [0] * nw                           # claimed-bit mask per word
        for mpj, row in live:
            if mpj == mp:
                continue
            wj = mpj >> 6
            b = 1 << (mpj & 63)
            if ow[wj] & b and not iw[wj] & b:
                claim.append((mpj, row))
                cw[wj] |= b
        if not claim:
            return eid, my_row, None, None
        for wj in range(nw):
            if cw[wj]:
                bm_in[wj] = _U64(iw[wj] | cw[wj])    # IO latch (Fig 8 3.3)
        return eid, my_row, claim, cw

    def _readahead_fill(self, req: Req, gfn: int, mp: int, crc: int,
                        pfn: int, ra) -> int:
        """Materialize the faulting MP and its claimed extent siblings.

        One decompress, one scatter into the resident MS frame. CRCs are
        verified per row before any backend entry is consumed. Readahead
        must not change observable semantics: a corrupt *sibling* row is
        simply left swapped out (it keeps failing detectably when it is
        actually faulted) while the good rows publish; only a corrupt
        *faulting* row raises.
        """
        eid, my_row, claim, cw = ra
        rec = req.record
        m = self.metrics
        mb = self._mp_bytes
        n_extra = 0 if claim is None else len(claim)
        my_ok = False
        good: List[int] = []
        tr = self._tr
        if tr is not None:
            t_ra = tr.begin(ST_FAULT_READAHEAD)
        try:
            # one decompress + ONE whole-extent CRC (per-row crc32 calls
            # cost more than the check is worth; the record CRCs remain
            # the scalar path's per-row guarantee)
            if tr is not None:
                t_dec = _perf_ns()
            raw, crc_ok = self.backend.extent_payload(
                gfn, eid, verify=self._crc_on)
            if tr is not None:
                tr.push(ST_READAHEAD_DECODE, t_dec, _perf_ns() - t_dec)
            # CRCs are checked on the host rows before anything reaches
            # the device; only the rows that publish are copied
            arr = _np.frombuffer(raw, dtype=_np.uint8).reshape(-1, mb)
            # (mp, row) pairs ascend together (extents store ascending MP
            # order)
            pairs = sorted(([] if claim is None else claim) + [(mp, my_row)])
            if not self._crc_on:
                my_ok = True
                good = [p[0] for p in pairs if p[0] != mp]
            elif crc_ok:
                m.crc_checks += 1 + n_extra
                my_ok = True
                good = [p[0] for p in pairs if p[0] != mp]
            else:
                # whole-extent CRC failed: salvage row by row against the
                # record CRCs -- corrupt siblings stay swapped out (they
                # keep failing detectably when actually faulted)
                m.crc_checks += 1 + n_extra
                for mpj, rowj in pairs:
                    want = crc if mpj == mp else int(rec.crc[mpj])
                    row_ok = _zlib.crc32(arr[rowj]) == want
                    if not row_ok:
                        m.crc_failures += 1
                    elif mpj == mp:
                        my_ok = True
                    else:
                        good.append(mpj)
            ok_mps = set(good)
            if my_ok:
                ok_mps.add(mp)
            copy = [p for p in pairs if p[0] in ok_mps]
            if copy:
                # one upload of the verified rows from a reused staging
                # buffer, one in-place scatter, indices by value
                self.backend.write_rows(self.virt.phys.ms_rows(pfn),
                                        _np.array([p[0] for p in copy]),
                                        arr[[p[1] for p in copy]])
                if tr is not None:
                    tr.copy(ST_FAULT_READAHEAD, H2D, len(copy) * mb)
            consumed = ([mp] if my_ok else []) + good
            if consumed:
                self.backend.consume_extent_rows(gfn, eid, consumed)
        finally:
            with req.mp_cond:
                # release every latch (ours + claimed) and publish the
                # verified rows, all with per-word int stores
                nw = len(rec.bm_in)
                rel = list(cw) if claim is not None else [0] * nw
                rel[mp >> 6] |= 1 << (mp & 63)
                bm_in = rec.bm_in
                for wj in range(nw):
                    if rel[wj]:
                        bm_in[wj] = _U64(int(bm_in[wj]) & ~rel[wj] & _MASK64)
                publish = ([mp] if my_ok else []) + good
                if publish:
                    pw = [0] * nw
                    kinds = rec.kinds
                    for mpj in publish:
                        pw[mpj >> 6] |= 1 << (mpj & 63)
                        kinds[mpj] = K_NONE
                    bm_out = rec.bm_out
                    for wj in range(nw):
                        if pw[wj]:
                            bm_out[wj] = _U64(
                                int(bm_out[wj]) & ~pw[wj] & _MASK64)
                    rec.present_count += len(publish)
                    m.mp_swapped_in += len(publish)
                    if my_ok:
                        m.fault_compressed_pages += 1
                    if good:
                        m.readahead_extents += 1
                        m.fault_readahead_mps += len(good)
                    if rec.present_count == self.cfg.mps_per_ms:
                        rec.on_last_swap_in()
                        self.virt.table.merge(gfn, rec.pfn)   # (7)
                        m.ms_swapped_in += 1
                req.mp_cond.notify_all()
        if not my_ok:
            raise CorruptionError(
                f"CRC mismatch gfn={gfn} mp={mp} (extent {eid})")
        if tr is not None:
            # tag 1 = sibling MPs were actually materialized
            tr.end(ST_FAULT_READAHEAD, t_ra, 1 if good else 0)
        return FK_READAHEAD if good else FK_COMPRESSED

    # ========================================================== Swap_out ==
    def swap_out_ms(self, gfn: int, *, blocking_lock: bool = True,
                    batched: Optional[bool] = None) -> int:
        """Active swap-out of all resident MPs of one MS.

        Returns MPs swapped out. Aborts promptly when cancelled by a
        reader (returns partial progress; the MS remains consistent).
        ``batched=None`` follows ``cfg.swap.batch_enabled``; the scalar
        per-MP path is kept for A/B benchmarking and as the semantic
        reference the equivalence tests compare against.
        """
        if self.virt.table.is_pinned(gfn):
            raise PinnedError(f"gfn {gfn} is pinned (mpool/DMA)")
        pfn = int(self.virt.table.pfn[gfn])
        if pfn == NO_PFN:
            return 0
        req = self.reqs.get_or_create(gfn, pfn)      # (1.1)/(1.2)
        grant = req.rwlock.acquire_write(blocking=blocking_lock)  # (2)
        if grant is None:
            return 0
        t0 = _perf_ns()
        if batched is None:
            batched = self.cfg.swap.batch_enabled
        try:
            if batched:
                done = self._swap_out_batched(req, gfn, grant)
            else:
                done = self._swap_out_scalar(req, gfn, grant)
        finally:
            req.rwlock.release_write(grant)
        self.metrics.swap_out_latency.record(_perf_ns() - t0)
        return done

    def swap_out_mps(self, gfn: int, mps, *, blocking_lock: bool = True,
                     batched: Optional[bool] = None) -> int:
        """Active swap-out restricted to the given MP indices.

        Same state machine as :meth:`swap_out_ms`, but only the listed
        MPs move to the backend; MPs already swapped out or mid-IO are
        skipped. The migration import path uses this to rebuild the
        source MS's resident/swapped split on the destination through
        the batched store machinery (store_batch extents).
        """
        idxs = _np.asarray(mps, dtype=_np.int64)
        if len(idxs) == 0:
            return 0
        if self.virt.table.is_pinned(gfn):
            raise PinnedError(f"gfn {gfn} is pinned (mpool/DMA)")
        pfn = int(self.virt.table.pfn[gfn])
        if pfn == NO_PFN:
            return 0
        req = self.reqs.get_or_create(gfn, pfn)
        grant = req.rwlock.acquire_write(blocking=blocking_lock)
        if grant is None:
            return 0
        t0 = _perf_ns()
        if batched is None:
            batched = self.cfg.swap.batch_enabled
        try:
            if batched:
                done = self._swap_out_batched(req, gfn, grant, todo=idxs)
            else:
                done = self._swap_out_scalar(req, gfn, grant,
                                             mps=[int(i) for i in idxs])
        finally:
            req.rwlock.release_write(grant)
        self.metrics.swap_out_latency.record(_perf_ns() - t0)
        return done

    def _swap_out_scalar(self, req: Req, gfn: int, grant,
                         mps: Optional[List[int]] = None) -> int:
        rec = req.record
        done = 0
        for mp in (range(self.cfg.mps_per_ms) if mps is None else mps):
            if grant.cancelled:                   # reader bumped us (2.2)
                self.metrics.writer_cancels += 1
                break
            with req.mp_cond:
                if rec.is_swapped_out(mp) or rec.is_swapping_in(mp):
                    continue
                if rec.state == MS_RESIDENT:      # first MP: split (4.1)
                    self.virt.table.split(gfn)
                    rec.on_first_swap_out()
                # unmap before copy: bm_out makes the MP non-present,
                # bm_in latches the in-flight IO so faults wait
                rec.set_swapped_out(mp, True)
                rec.set_swapping_in(mp, True)
                pfn_now = rec.pfn

            # a guest copy translated before the unmap is issued first
            self.virt.inflight.drain(gfn)
            data = to_host(self.virt.phys.mp_view(pfn_now, mp))
            kind, crc = self.backend.store(gfn, mp, data)     # (5)

            with req.mp_cond:
                rec.kinds[mp] = kind
                rec.crc[mp] = crc
                rec.set_swapping_in(mp, False)
                rec.present_count -= 1
                done += 1
                self.metrics.mp_swapped_out += 1
                if rec.present_count == 0:        # last MP: reclaim
                    rec.on_last_swap_out()
                    self.virt.table.unmap(gfn)
                    self.virt.phys.free_slot(pfn_now)
                    self.lru.note_swapped_out(gfn)
                    self.metrics.ms_swapped_out += 1
                req.mp_cond.notify_all()
        return done

    def _swap_out_batched(self, req: Req, gfn: int, grant,
                          todo: Optional[_np.ndarray] = None) -> int:
        """Swap out in MP index-vector chunks (tentpole data path).

        Each chunk runs the scalar path's exact state transitions, but on
        a whole index vector at once: one bitmap scatter marks the chunk
        non-present + IO-latched, one ``store_batch`` call reads it from
        the frame and zero-detects/CRCs/compresses it, and one scatter
        publishes the kinds/CRCs. Cancellation (Fig 8 (2.2)) is
        honoured between chunks, so ``cfg.swap.batch_mps`` bounds a
        racing reader's wait.
        """
        rec = req.record
        cfg = self.cfg
        chunk = max(1, cfg.swap.batch_mps)
        done = 0
        tr = self._tr
        if tr is not None:
            t_so = tr.begin(ST_SWAP_OUT)
        # the write lock excludes faults and other writers, so the resident
        # set is fixed for the whole task: derive the MP index vector once
        # and walk it in cancellation-checked chunks (an explicit ``todo``
        # subset is intersected with it, so already-swapped MPs are inert)
        with req.mp_cond:
            resident = rec.resident_indices()
            todo = resident if todo is None else todo[
                _np.isin(todo, resident)]
        for lo in range(0, len(todo), chunk):
            if grant.cancelled:
                self.metrics.writer_cancels += 1
                break
            idxs = todo[lo:lo + chunk]
            with req.mp_cond:
                if rec.state == MS_RESIDENT:      # first MP: split (4.1)
                    self.virt.table.split(gfn)
                    rec.on_first_swap_out()
                # unmap before copy, latch in-flight IO (scalar semantics)
                rec.set_swapped_out_batch(idxs, True)
                rec.set_swapping_in_batch(idxs, True)
                pfn_now = rec.pfn

            # a guest copy translated before the unmap is issued first
            self.virt.inflight.drain(gfn)
            if tr is not None:
                t_st = tr.begin(ST_BACKEND_STORE)
            # the chunk's rows, read from the frame on the device (5): on
            # the stream of every guest write, after the latch above and
            # after every copy already in flight to this MS
            kinds, crcs = self.backend.store_batch(
                gfn, idxs, self.virt.phys.ms_rows(pfn_now), rows=idxs)
            if tr is not None:
                tr.end(ST_BACKEND_STORE, t_st)

            with req.mp_cond:
                rec.kinds[idxs] = kinds
                rec.crc[idxs] = crcs
                rec.set_swapping_in_batch(idxs, False)
                rec.present_count -= len(idxs)
                done += len(idxs)
                self.metrics.mp_swapped_out += len(idxs)
                self.metrics.mp_swapped_out_batched += len(idxs)
                self.metrics.swap_out_batches += 1
                if rec.present_count == 0:        # last MP: reclaim
                    rec.on_last_swap_out()
                    self.virt.table.unmap(gfn)
                    self.virt.phys.free_slot(pfn_now)
                    self.lru.note_swapped_out(gfn)
                    self.metrics.ms_swapped_out += 1
                req.mp_cond.notify_all()
        if tr is not None:
            tr.end(ST_SWAP_OUT, t_so)
        return done

    # =========================================================== Swap_in ==
    def swap_in_ms(self, gfn: int, *, batched: Optional[bool] = None) -> int:
        """Active prefetch swap-in of all swapped MPs of one MS."""
        req = self.reqs.lookup(gfn)
        if req is None:
            return 0
        grant = req.rwlock.acquire_write()
        t0 = _perf_ns()
        if batched is None:
            batched = self.cfg.swap.batch_enabled
        done = 0
        try:
            if batched:
                done = self._swap_in_batched(req, gfn, grant)
            else:
                done = self._swap_in_scalar(req, gfn, grant)
        finally:
            req.rwlock.release_write(grant)
        self.metrics.swap_in_latency.record(_perf_ns() - t0)
        return done

    def _swap_in_scalar(self, req: Req, gfn: int, grant) -> int:
        rec = req.record
        done = 0
        for mp in range(self.cfg.mps_per_ms):
            if grant.cancelled:
                self.metrics.writer_cancels += 1
                break
            with req.mp_cond:
                if not rec.is_swapped_out(mp) or rec.is_swapping_in(mp):
                    continue
            # delegate to the fault path's exactly-once machinery
            self._fault_in_locked(req, gfn, mp)
            done += 1
        return done

    def _swap_in_batched(self, req: Req, gfn: int, grant) -> int:
        """Prefetch swap-in in MP index-vector chunks.

        Mirrors ``_fault_in_locked`` chunk-wise: exactly-once first-in
        allocation, the bm_in IO latch held across the bulk backend load,
        and the merge on the last MP. Zero rows are memset vectorized
        inside ``load_batch`` (no per-MP backend round trip).
        """
        rec = req.record
        cfg = self.cfg
        chunk = max(1, cfg.swap.batch_mps)
        done = 0
        tr = self._tr
        if tr is not None:
            t_si = tr.begin(ST_SWAP_IN)
        # swapped-out set is fixed while we hold the write lock (faults
        # block; the IO latch below covers the store side): scan once
        with req.mp_cond:
            todo = rec.swapped_out_indices()
        for lo in range(0, len(todo), chunk):
            if grant.cancelled:
                self.metrics.writer_cancels += 1
                break
            idxs = todo[lo:lo + chunk]
            with req.mp_cond:
                # re-filter under the mutex: the zero-page fast path does
                # not take the rwlock, so an MP from the once-scanned todo
                # list may have been fault-resolved between chunks
                idxs = idxs[[rec.is_swapped_out(int(i))
                             and not rec.is_swapping_in(int(i))
                             for i in idxs]]
                if len(idxs) == 0:
                    continue
                if rec.state == MS_SWAPPED:
                    pfn = self._alloc_slot_critical()
                    rec.on_first_swap_in(pfn)     # exactly-once alloc
                    self.virt.table.map_split(gfn, pfn)
                    self.lru.note_swapped_in(gfn)
                pfn = rec.pfn
                kinds = rec.kinds[idxs].copy()
                crcs = rec.crc[idxs].copy()
                rec.set_swapping_in_batch(idxs, True)   # IO latch (3.3)

            ms = self.virt.phys.ms_rows(pfn)
            ok = False
            try:
                if tr is not None:
                    t_bl = tr.begin(ST_BACKEND_LOAD)
                # straight into the MS frame, in place: only the latched
                # rows are written, so a racing guest write to another MP
                # of this frame stays
                self.backend.load_batch(gfn, idxs, kinds, crcs, ms, rows=idxs)
                if tr is not None:
                    tr.end(ST_BACKEND_LOAD, t_bl)
                ok = True
            finally:
                with req.mp_cond:
                    rec.set_swapping_in_batch(idxs, False)
                    if ok:
                        rec.set_swapped_out_batch(idxs, False)
                        rec.kinds[idxs] = K_NONE
                        rec.present_count += len(idxs)
                        done += len(idxs)
                        self.metrics.mp_swapped_in += len(idxs)
                        self.metrics.swap_in_batches += 1
                        if rec.present_count == cfg.mps_per_ms:
                            rec.on_last_swap_in()
                            self.virt.table.merge(gfn, rec.pfn)   # (7)
                            self.metrics.ms_swapped_in += 1
                    req.mp_cond.notify_all()
        if tr is not None:
            tr.end(ST_SWAP_IN, t_si)
        return done

    # ===================================================== reclaim rounds ==
    def reclaim_round(self, budget_s: Optional[float] = None) -> int:
        """One background reclaim round (BACK priority task body), one
        ``reclaim_round`` span where traced; returns the MPs reclaimed."""
        tr = self._tr
        if tr is None:
            return self._reclaim_round(budget_s)
        t0 = tr.begin(ST_RECLAIM_ROUND)
        try:
            return self._reclaim_round(budget_s)
        finally:
            tr.end(ST_RECLAIM_ROUND, t0)

    def _reclaim_round(self, budget_s: Optional[float]) -> int:
        """The round's body.

        The round issues whole-MS batches: the watermark policy sizes the
        candidate pick from the distance back to ``high`` (never more MSs
        than the deficit), and each MS moves through the batched swap-out
        path. ``budget_s`` is the hv_sched quantum handed to the BACK
        task; the round stops starting new MS batches once it is spent,
        so batch sizing composes with the scheduler's time slicing.
        """
        # drain deferred fast-path LRU joins first so pick_cold sees every
        # resident MS, then epoch-publish the zone the fast path reads
        if self._lru_pending:
            self.drain_lru_pending()
        free = self._wm.publish(self.virt.free_ms)
        if not self.watermark.should_start_reclaim(free):
            return 0
        deadline = (time.monotonic() + budget_s) if budget_s else None
        batch = self.watermark.reclaim_batch_ms(free)
        candidates = self.lru.pick_cold(batch)
        if not candidates:
            # §4.2.2: "halting reclaim between low and high if no cold
            # pages exist" -- fall back to cold-intermediate only when the
            # pressure is real (below low)
            if free < self.watermark.low_ms:
                candidates = self.lru.pick_cold(batch, include_cold_int=True)
            if not candidates:
                return 0
        reclaimed = 0
        for gfn in candidates:
            if self.watermark.should_stop_reclaim(self.virt.free_ms):
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            try:
                reclaimed += self.swap_out_ms(gfn, blocking_lock=False)
            except PinnedError:
                continue
        self.metrics.reclaim_rounds += 1
        self._wm.publish(self.virt.free_ms)  # round raised free: re-publish
        return reclaimed

    def _alloc_slot_critical(self) -> int:
        """Allocate a physical MS; below the min watermark (or on
        exhaustion), proactively swap out cold MSs synchronously.

        This is the slow path that re-verifies the epoch-published
        critical flag against the LIVE free count (exact, conservative
        direction) -- and re-publishes, so a stale flag heals
        on the first slow-path visit.
        """
        slot = self.virt.phys.try_alloc_slot()
        if slot is not None and not self.watermark.is_critical(
                self._wm.publish(self.virt.free_ms)):
            return slot
        if slot is not None:
            # critical but not exhausted: kick a synchronous reclaim too,
            # sized by the watermark deficit (whole-MS batches)
            self.metrics.proactive_reclaims += 1
            n = self.watermark.critical_batch_ms(self.virt.free_ms)
            for gfn in self.lru.pick_cold(n, include_cold_int=True):
                try:
                    self.swap_out_ms(gfn, blocking_lock=False)
                except PinnedError:
                    pass
            return slot
        # exhausted: must reclaim synchronously until a slot frees up;
        # prefer cold pages but force relatively-cold ones if none aged yet
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            self.metrics.proactive_reclaims += 1
            # a resident MS whose fast-path LRU join is still pending is
            # invisible to the pickers: drain first so exhaustion never
            # misses reclaimable memory (try_alloc_slot already stole any
            # magazine-cached slots before reporting None)
            if self._lru_pending:
                self.drain_lru_pending()
            cands = self.lru.pick_cold(4, include_cold_int=True)
            if not cands:
                cands = self.lru.pick_coldest_any(4)
            for gfn in cands:
                try:
                    self.swap_out_ms(gfn, blocking_lock=False)
                except PinnedError:
                    continue
            slot = self.virt.phys.try_alloc_slot()
            if slot is not None:
                return slot
            if not cands:
                time.sleep(0.001)
        raise OutOfMemoryError("no physical MS and no cold pages to reclaim")

    # ----------------------------------------------- deferred-work drains --
    def drain_lru_pending(self) -> None:
        """Apply deferred fast-path ``note_swapped_in`` joins.

        The fast path appends GFNs to a plain list (GIL-atomic); the
        drain pops from the SAME list object, so a racing append is never
        lost and each note is applied exactly once. Drained at
        ``step_background``, slow-path fault entry, reclaim-round start
        and exhaustion -- LRU ordering is eventually-exact, never paid on
        the fault budget.
        """
        pend = self._lru_pending
        batch: List[int] = []
        while True:
            try:
                batch.append(pend.pop())
            except IndexError:
                break
        if batch:
            self.lru.note_swapped_in_batch(batch)

    def publish_epoch(self) -> None:
        """Background-cadence refresh: drain deferred LRU joins and
        epoch-publish the watermark view the fault fast path reads.
        Registered as an hv_sched cycle hook and called from
        ``step_background``."""
        if self._lru_pending:
            self.drain_lru_pending()
        self._wm.publish(self.virt.free_ms)

    def drain_deferred(self) -> int:
        """Full drain hook for reclaim/teardown: apply pending
        LRU joins AND return every magazine-cached slot to its home
        shard, then re-publish. Returns the number of slots drained."""
        self.drain_lru_pending()
        drained = self.virt.phys.drain_magazines()
        self._wm.publish(self.virt.free_ms)
        return drained

    # ------------------------------------------------------------ utilities
    def ms_fully_swapped(self, gfn: int) -> bool:
        """``True`` when every MP of ``gfn`` lives in the backend.

        The remote-peer tier replicates exactly this population: a
        fully-swapped MS has no physical frame to lose, so its entire
        guest-visible content is a backend export -- the cheapest and
        highest-value unit to place on a peer. A point-in-time
        read under the MP mutex; the fleet's stepped mode is
        single-threaded, so for the controller it is exact.
        """
        req = self.reqs.lookup(gfn)
        if req is None:
            return False
        rec = req.record
        with req.mp_cond:
            return rec.state == MS_SWAPPED and rec.present_count == 0
