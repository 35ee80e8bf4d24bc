"""Parallel multi-level LRU (paper §4.2.1, Fig 7).

Six sets from hot end to cold end:

    HOT -- HOT_INT -- ACTIVE -- INACTIVE -- COLD_INT -- COLD

  * Accessed pages move one level toward HOT (transient single-MP accesses
    inside a huge page cannot jump a page straight to HOT -- the
    intermediate sets smooth fluctuations, "time-based stabilization").
  * Pages whose state is unchanged for ``stabilize_scans`` consecutive
    scans drift one level toward COLD.
  * Within each set, elements are ordered by arrival time: the head of the
    COLD set is the coldest page and is reclaimed first.
  * One LRU task per shard (per-PCPU in the paper) scans its own slice of
    the GFN space; a per-worker **scan cache** buffers results and applies
    them to the shared sets in one short critical section, reducing lock
    contention.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ..analysis.lock_order import named_lock
from ..obs.tracer import ST_LRU_SCAN
from .config import TaijiConfig

HOT, HOT_INT, ACTIVE, INACTIVE, COLD_INT, COLD = range(6)
N_LEVELS = 6
LEVEL_NAMES = ("HOT", "HOT_INT", "ACTIVE", "INACTIVE", "COLD_INT", "COLD")


class MultiLevelLRU:
    def __init__(self, cfg: TaijiConfig,
                 accessed_probe: Callable[[int], bool], tracer=None) -> None:
        """``accessed_probe(gfn)`` test-and-clears the access bit (EPT A-bit);
        ``tracer`` (repro_torch.obs, ``None`` when disabled) gets one
        ``lru_scan`` span per :meth:`scan_shard`."""
        self.cfg = cfg
        self.accessed_probe = accessed_probe
        self._tr = tracer
        self._lock = named_lock("lru")
        # level -> OrderedDict[gfn -> unchanged_scan_count]
        self._sets: List[OrderedDict] = [OrderedDict() for _ in range(N_LEVELS)]
        self._level_of: Dict[int, int] = {}
        self.scan_rounds = 0

    # ------------------------------------------------------------- tracking
    def track(self, gfn: int, level: int = ACTIVE) -> None:
        with self._lock:
            if gfn in self._level_of:
                return
            self._sets[level][gfn] = 0
            self._level_of[gfn] = level

    def untrack(self, gfn: int) -> None:
        with self._lock:
            lvl = self._level_of.pop(gfn, None)
            if lvl is not None:
                self._sets[lvl].pop(gfn, None)

    def note_swapped_out(self, gfn: int) -> None:
        """Swapped pages leave the LRU until they come back."""
        self.untrack(gfn)

    def note_swapped_in(self, gfn: int) -> None:
        """Fault-driven swap-ins join the hot set (paper Fig 14d)."""
        with self._lock:
            old = self._level_of.pop(gfn, None)
            if old is not None:
                self._sets[old].pop(gfn, None)
            self._sets[HOT][gfn] = 0
            self._level_of[gfn] = HOT

    def note_swapped_in_batch(self, gfns: List[int]) -> None:
        """Apply a batch of deferred fast-path swap-in notes.

        One lock acquisition for the whole drained pending ring; entries
        join HOT in drain order, so LRU ordering is eventually-exact but
        the per-fault cost never lands on the fault budget.
        """
        with self._lock:
            sets, level_of = self._sets, self._level_of
            hot = sets[HOT]
            for gfn in gfns:
                old = level_of.pop(gfn, None)
                if old is not None:
                    sets[old].pop(gfn, None)
                hot[gfn] = 0
                level_of[gfn] = HOT

    # ---------------------------------------------------------------- scans
    def scan_shard(self, shard: int, n_shards: int) -> int:
        """One scan round over this shard's slice. Returns pages moved.

        Phase 1 (lock-free): probe access bits into the scan cache.
        Phase 2 (one short critical section): apply buffered moves.
        """
        tr = self._tr
        if tr is not None:
            t0 = tr.begin(ST_LRU_SCAN)
        with self._lock:
            shard_gfns = [g for g in self._level_of if g % n_shards == shard]

        cache: List[tuple] = []
        limit = self.cfg.lru.scan_cache_size
        moved = 0
        for gfn in shard_gfns:
            cache.append((gfn, self.accessed_probe(gfn)))
            if len(cache) >= limit:
                moved += self._apply(cache)
                cache = []
        moved += self._apply(cache)
        self.scan_rounds += 1
        if tr is not None:
            tr.end(ST_LRU_SCAN, t0, shard & 7)
        return moved

    def _apply(self, cache: List[tuple]) -> int:
        if not cache:
            return 0
        moved = 0
        stab = self.cfg.lru.stabilize_scans
        with self._lock:
            for gfn, accessed in cache:
                lvl = self._level_of.get(gfn)
                if lvl is None:          # raced with swap-out
                    continue
                if accessed:
                    new = max(HOT, lvl - 1)
                    if new != lvl:
                        self._move(gfn, lvl, new)
                        moved += 1
                    else:
                        self._sets[lvl][gfn] = 0
                else:
                    count = self._sets[lvl][gfn] + 1
                    if count >= stab and lvl < COLD:
                        self._move(gfn, lvl, lvl + 1)
                        moved += 1
                    else:
                        self._sets[lvl][gfn] = min(count, stab)
        return moved

    def _move(self, gfn: int, src: int, dst: int) -> None:
        self._sets[src].pop(gfn)
        self._sets[dst][gfn] = 0          # arrival-time order: append at tail
        self._level_of[gfn] = dst

    # ------------------------------------------------------------ selection
    def pick_cold(self, n: int, include_cold_int: bool = False) -> List[int]:
        """Coldest-first reclaim candidates (head of the COLD set first)."""
        out: List[int] = []
        with self._lock:
            for lvl in ([COLD, COLD_INT] if include_cold_int else [COLD]):
                it = iter(self._sets[lvl])
                while len(out) < n:
                    try:
                        out.append(next(it))
                    except StopIteration:
                        break
                if len(out) >= n:
                    break
        return out

    def pick_coldest_any(self, n: int) -> List[int]:
        """Forced reclaim under critical pressure: walk from the cold end
        toward the hot end and take the relatively coldest pages (the min
        watermark's proactive swap-out must always make progress)."""
        out: List[int] = []
        with self._lock:
            for lvl in range(COLD, HOT - 1, -1):
                for gfn in self._sets[lvl]:
                    out.append(gfn)
                    if len(out) >= n:
                        return out
        return out

    # ------------------------------------------------------------- counters
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {LEVEL_NAMES[i]: len(s) for i, s in enumerate(self._sets)}

    def level_of(self, gfn: int) -> Optional[int]:
        with self._lock:
            return self._level_of.get(gfn)

    def tracked(self) -> int:
        with self._lock:
            return len(self._level_of)

    def check_invariants(self) -> None:
        with self._lock:
            seen = set()
            for lvl, s in enumerate(self._sets):
                for gfn in s:
                    assert gfn not in seen, f"gfn {gfn} in two sets"
                    seen.add(gfn)
                    assert self._level_of[gfn] == lvl
            assert seen == set(self._level_of)
