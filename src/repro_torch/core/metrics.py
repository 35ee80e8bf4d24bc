"""Runtime metrics for the elastic-memory core.

The paper evaluates Taiji with fault-latency percentiles (Fig 14f / 15d),
hot/cold page counts (Fig 14c/d, 15b), backend composition (Fig 15c) and
metadata utilization (Fig 13a).
This module provides the counters/histograms those benchmarks read.

The fault path is latency-critical (P90 < 10 us), so ``LatencyHistogram``
records with integer bucket math only -- no allocation, no locking beyond
the GIL (single bytecode ops on ints are atomic in CPython).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..analysis.lock_order import named_lock

# fault-kind codes recorded alongside each latency sample (3 tag bits in
# the ring encoding: 2 kind bits + the fast-path flag)
FK_ZERO, FK_COMPRESSED, FK_READAHEAD, FK_OTHER = 0, 1, 2, 3
FK_NAMES = ("zero", "compressed", "readahead", "other")
# fast-path zero faults push FK_ZERO | FK_FAST and defer their pure-stat
# counter increments (fault_zero_pages / fault_fast_path / crc_checks) to
# the vectorized ring flush -- three attribute read-modify-writes off the
# 10us budget; the exactly-once witnesses (faults, mp_swapped_in) stay
# immediate
FK_FAST = 4


class LatencyHistogram:
    """Fixed-bucket nanosecond latency histogram.

    Buckets are powers of two from 256 ns to ~67 ms plus an overflow bucket.
    """

    _BASE_SHIFT = 8          # first bucket: < 2**8 ns
    _NBUCKETS = 20
    _RESERVOIR = 200_000     # exact samples kept for precise percentiles
    # bucket upper bounds for the vectorized LatencyRing fold: searchsorted
    # (side="right") over these reproduces record()'s bit_length bucketing
    _bounds = np.int64(1) << (np.arange(20, dtype=np.int64) + 8)

    def __init__(self) -> None:
        self.buckets = [0] * (self._NBUCKETS + 1)
        self.count = 0
        self.total_ns = 0
        self.max_ns = 0
        self.samples = []    # bounded exact reservoir (list.append ~50ns)

    def record(self, ns: int) -> None:
        idx = max(0, ns.bit_length() - self._BASE_SHIFT)
        if idx > self._NBUCKETS:
            idx = self._NBUCKETS
        self.buckets[idx] += 1
        self.count += 1
        self.total_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns
        if len(self.samples) < self._RESERVOIR:
            self.samples.append(ns)

    def percentile(self, p: float) -> float:
        """Percentile in ns: exact from the reservoir when available."""
        if self.count == 0:
            return 0.0
        if self.samples:
            s = sorted(self.samples)
            return float(s[min(len(s) - 1, int(p * len(s)))])
        target = p * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= target:
                return float(1 << (i + self._BASE_SHIFT))
        return float(self.max_ns)

    def fraction_below(self, ns: int) -> float:
        """Fraction of samples below ``ns``."""
        if self.count == 0:
            return 1.0
        if self.samples:
            return sum(1 for s in self.samples if s < ns) / len(self.samples)
        seen = 0
        for i, c in enumerate(self.buckets):
            upper = 1 << (i + self._BASE_SHIFT)
            if upper > ns:
                break
            seen += c
        return seen / self.count

    @property
    def mean_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` into this histogram (fleet-wide aggregation).

        Exact reservoirs are kept only while every sample fits; once any
        source overflows, the merged reservoir would over-weight whichever
        node merged first (``percentile`` prefers samples whenever
        present), so it is dropped and percentiles fall back to the
        unbiased bucket math.
        """
        both_complete = (len(self.samples) == self.count
                         and len(other.samples) == other.count
                         and self.count + other.count <= self._RESERVOIR)
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.count += other.count
        self.total_ns += other.total_ns
        if other.max_ns > self.max_ns:
            self.max_ns = other.max_ns
        if both_complete:
            self.samples.extend(other.samples)
        else:
            self.samples = []

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_us": self.mean_ns / 1e3,
            "p50_us": self.percentile(0.50) / 1e3,
            "p90_us": self.percentile(0.90) / 1e3,
            "p99_us": self.percentile(0.99) / 1e3,
            "max_us": self.max_ns / 1e3,
        }


class LatencyRing:
    """Preallocated numpy ring in front of latency histograms.

    ``LatencyHistogram.record`` costs ~1 us of Python bucket math per
    sample -- on a 10 us fault budget the measurement inflates the thing
    being measured. The ring's :meth:`push` is a single encoded int64
    store (``(ns + 1) << 3 | tag``, where tag is 2 kind bits plus the
    ``FK_FAST`` flag; the +1 makes 0 an empty-slot sentinel); bucketing,
    totals and the exact reservoir are folded in vectorized batches by
    :meth:`flush` (when the ring fills, and from ``Metrics.sync()``
    before any read).

    Concurrency: pushes are GIL-serialized single stores; :meth:`flush`
    zeroes the slots it copied, so a push racing a flush can never be
    folded twice. A racing push can at worst land in a slot the flush
    already copied and be dropped -- an accepted stats-only loss, which
    for a dropped fast-path sample also undercounts the deferred
    ``fault_zero_pages``/``fault_fast_path``/``crc_checks`` stats by
    one. The exactly-once witnesses (``faults``, ``mp_swapped_in``) are
    incremented on the fault path itself and stay exact; deterministic
    (single-threaded, stepped) replays lose nothing.
    """

    __slots__ = ("_buf", "_pos", "_cap", "_lock", "hist", "by_kind",
                 "metrics", "count_crc")

    def __init__(self, hist: "LatencyHistogram",
                 by_kind: Dict[str, "LatencyHistogram"],
                 metrics: "Metrics" = None, cap: int = 4096) -> None:
        self._buf = np.zeros(cap, dtype=np.int64)
        self._pos = 0
        self._cap = cap
        self._lock = named_lock("metrics")
        self.hist = hist
        self.by_kind = by_kind
        self.metrics = metrics       # deferred fast-path counter target
        self.count_crc = True        # engine clears when CRC is disabled

    def push(self, ns: int, kind: int) -> None:
        p = self._pos
        if p >= self._cap:
            self.flush()
            p = self._pos
            if p >= self._cap:           # racing pushers refilled the ring
                p = self._cap - 1        # overwrite the tail (stats-only)
        self._buf[p] = ((ns + 1) << 3) | kind
        self._pos = p + 1

    def flush(self) -> None:
        with self._lock:
            n = self._pos
            if n == 0:
                return
            enc = self._buf[:n].copy()
            self._buf[:n] = 0            # stale-slot guard vs racing pushes
            self._pos = 0
        enc = enc[enc != 0]              # skip empty/already-folded slots
        if len(enc) == 0:
            return
        ns = (enc >> 3) - 1
        kinds = enc & 3
        self._fold(self.hist, ns)
        for code, name in enumerate(FK_NAMES):
            sel = ns[kinds == code]
            if len(sel):
                self._fold(self.by_kind[name], sel)
        m = self.metrics
        if m is not None:
            fast = int(np.count_nonzero(enc & FK_FAST))
            if fast:
                m.fault_zero_pages += fast
                m.fault_fast_path += fast
                if self.count_crc:
                    m.crc_checks += fast

    @staticmethod
    def _fold(hist: "LatencyHistogram", ns: np.ndarray) -> None:
        """Vectorized equivalent of ``hist.record`` over a batch."""
        # bucket index = max(0, bit_length - BASE_SHIFT), computed exactly
        # via searchsorted over the power-of-two bucket upper bounds
        bounds = hist._bounds
        idx = np.searchsorted(bounds, ns, side="right")
        counts = np.bincount(idx, minlength=hist._NBUCKETS + 1)
        for i in np.flatnonzero(counts):
            hist.buckets[int(i)] += int(counts[i])
        hist.count += len(ns)
        hist.total_ns += int(ns.sum())
        mx = int(ns.max())
        if mx > hist.max_ns:
            hist.max_ns = mx
        room = hist._RESERVOIR - len(hist.samples)
        if room > 0:
            hist.samples.extend(ns[:room].tolist())


class Metrics:
    """All counters for one Taiji instance."""

    def __init__(self) -> None:
        # fault path (passive swap-in) latency -- the paper's headline
        # metric. Stored privately; the public ``fault_latency`` /
        # ``fault_latency_by_kind`` properties sync the ring first so
        # direct readers always see settled histograms.
        self._fault_latency = LatencyHistogram()
        # per-kind split (zero / compressed / extent-readahead / other) for
        # the latency-budget breakdown in benchmarks/fault_latency.py
        self._fault_latency_by_kind: Dict[str, LatencyHistogram] = {
            name: LatencyHistogram() for name in FK_NAMES}
        # the fault path records through this ring (one int64 store per
        # fault); flushed on reads and by sync()
        self.fault_ring = LatencyRing(self._fault_latency,
                                      self._fault_latency_by_kind, self)
        # active-task latencies
        self.swap_out_latency = LatencyHistogram()
        self.swap_in_latency = LatencyHistogram()

        # counters (GIL-atomic int += in single ops is fine for stats)
        self.faults = 0
        self.fault_zero_pages = 0
        self.fault_compressed_pages = 0
        self.fault_fast_path = 0         # zero faults resolved lock-light
        self.readahead_extents = 0       # extents materialized by readahead
        self.fault_readahead_mps = 0     # sibling MPs materialized (beyond 1)
        self.ms_swapped_out = 0
        self.ms_swapped_in = 0
        self.mp_swapped_out = 0
        self.mp_swapped_in = 0
        # batched data path (one batch == one store_batch/load_batch chunk)
        self.swap_out_batches = 0
        self.swap_in_batches = 0
        self.mp_swapped_out_batched = 0  # numerator for mean batch size
        self.backend_batch_stores = 0
        self.backend_batch_loads = 0
        self.writer_cancels = 0          # rw-lock cancel events (paper Fig 8 (2.2))
        self.crc_checks = 0
        self.crc_failures = 0
        self.dmar_intercepts = 0         # faults on registered DMA ranges (paper §7.1)
        self.reclaim_rounds = 0
        self.proactive_reclaims = 0      # min-watermark synchronous reclaims

        # backend composition (paper Fig 15c)
        self.backend_zero_mps = 0
        self.backend_compressed_mps = 0
        self.backend_raw_bytes = 0
        self.backend_stored_bytes = 0

        # stage-attributed span tracer (repro_torch.obs) -- None unless
        # ObsConfig.enabled; instrumented call sites cache this and guard
        # with a single `is not None` branch. Wall-clock telemetry only:
        # never part of deterministic_snapshot().
        self.tracer = None

    @property
    def fault_latency(self) -> LatencyHistogram:
        """Fault-latency histogram, with pending ring samples folded in."""
        self.fault_ring.flush()
        return self._fault_latency

    @property
    def fault_latency_by_kind(self) -> Dict[str, LatencyHistogram]:
        """Per-kind fault histograms, with pending ring samples folded in."""
        self.fault_ring.flush()
        return self._fault_latency_by_kind

    def sync(self) -> None:
        """Fold pending latency-ring samples into the histograms and the
        deferred fast-path stat counters."""
        self.fault_ring.flush()

    def reset_fault_latency(self) -> None:
        """Discard fault-latency samples (benchmark warmup separation).

        Event counters are untouched -- only the timing histograms and
        their ring restart, so a benchmark can measure steady state
        without cold-start samples."""
        count_crc = self.fault_ring.count_crc
        self._fault_latency = LatencyHistogram()
        self._fault_latency_by_kind = {
            name: LatencyHistogram() for name in FK_NAMES}
        self.fault_ring = LatencyRing(self._fault_latency,
                                      self._fault_latency_by_kind, self)
        self.fault_ring.count_crc = count_crc

    def render_prom(self, tracer=None, prefix: str = "taiji") -> str:
        """Prometheus text exposition of counters/gauges/histograms (and
        per-stage span aggregates when tracing is enabled). Lazy import:
        ``repro_torch.obs.prom`` reads this object duck-typed, so core keeps no
        hard dependency on the obs package."""
        from ..obs.prom import render_prom as _render
        return _render(self, tracer if tracer is not None else self.tracer,
                       prefix=prefix)

    def compression_ratio(self) -> float:
        """stored/raw over the compressed population (paper: 47.63%)."""
        if self.backend_raw_bytes == 0:
            return 1.0
        return self.backend_stored_bytes / self.backend_raw_bytes

    def deterministic_snapshot(self) -> Dict[str, int]:
        """Pure event counters -- no wall-clock derived values.

        Syncs the latency ring first: fast-path faults defer their stat
        counters to the flush (the deferred *counts* are deterministic
        even though the latency values are not).

        Replaying the same seeded trace through a stepped (round-based)
        fleet must produce byte-identical snapshots; latency histograms
        and timelines are inherently timing-dependent, so fleet replay
        determinism is asserted over exactly this view.
        """
        self.sync()
        return {
            "faults": self.faults,
            "fault_zero_pages": self.fault_zero_pages,
            "fault_compressed_pages": self.fault_compressed_pages,
            "fault_fast_path": self.fault_fast_path,
            "readahead_extents": self.readahead_extents,
            "fault_readahead_mps": self.fault_readahead_mps,
            "ms_swapped_out": self.ms_swapped_out,
            "ms_swapped_in": self.ms_swapped_in,
            "mp_swapped_out": self.mp_swapped_out,
            "mp_swapped_in": self.mp_swapped_in,
            "swap_out_batches": self.swap_out_batches,
            "swap_in_batches": self.swap_in_batches,
            "mp_swapped_out_batched": self.mp_swapped_out_batched,
            "backend_batch_stores": self.backend_batch_stores,
            "backend_batch_loads": self.backend_batch_loads,
            "writer_cancels": self.writer_cancels,
            "crc_checks": self.crc_checks,
            "crc_failures": self.crc_failures,
            "dmar_intercepts": self.dmar_intercepts,
            "reclaim_rounds": self.reclaim_rounds,
            "proactive_reclaims": self.proactive_reclaims,
            "backend_zero_mps": self.backend_zero_mps,
            "backend_compressed_mps": self.backend_compressed_mps,
            "backend_raw_bytes": self.backend_raw_bytes,
            "backend_stored_bytes": self.backend_stored_bytes,
        }

    def snapshot(self) -> Dict[str, object]:
        self.sync()
        return {
            "faults": self.faults,
            "fault_latency": self.fault_latency.snapshot(),
            "fault_latency_by_kind": {
                name: h.snapshot()
                for name, h in self.fault_latency_by_kind.items()},
            "fault_fast_path": self.fault_fast_path,
            "readahead_extents": self.readahead_extents,
            "fault_readahead_mps": self.fault_readahead_mps,
            "ms_swapped_out": self.ms_swapped_out,
            "ms_swapped_in": self.ms_swapped_in,
            "mp_swapped_out": self.mp_swapped_out,
            "mp_swapped_in": self.mp_swapped_in,
            "swap_out_batches": self.swap_out_batches,
            "swap_in_batches": self.swap_in_batches,
            "mean_swap_out_batch_mps": (
                self.mp_swapped_out_batched / self.swap_out_batches
                if self.swap_out_batches else 0.0),
            "writer_cancels": self.writer_cancels,
            "crc_failures": self.crc_failures,
            "zero_mps": self.backend_zero_mps,
            "compressed_mps": self.backend_compressed_mps,
            "compression_ratio": self.compression_ratio(),
        }
