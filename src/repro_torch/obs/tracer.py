"""Stage-attributed span tracing for the swap path.

The benchmark's end-to-end numbers (``taiji_bench``) say *what* the
fault/swap path, hv_sched's background work and the decode step cost;
this module says *where*. A :class:`SpanTracer`
is a ``LatencyRing``-style preallocated ring: the hot path records one
span with a single encoded int64 store plus two companion stores
(``t_start_ns`` and thread id) and no allocation; bucketing into
per-(stage, tag) aggregates and the bounded retained-span store happen
in vectorized batches at :meth:`SpanTracer.flush`.

Discipline when disabled: every instrumented call site caches
``metrics.tracer`` (``None`` unless ``ObsConfig.enabled``) and guards
with ``if tr is not None:`` -- the same single-truthiness-branch cost as
the empty-observer check in ``GuestSpace``. Spans are wall-clock
telemetry and never enter ``deterministic_snapshot``; capture/replay and
chaos determinism are untouched by tracing.

Stages form a *static* tree (``STAGES`` below): self-time rollup
subtracts each stage's declared children from its total instead of
reconstructing nesting from timestamps at runtime. For fan-out stages
(the compress pool) the instrumented span covers the fan-out's wall time
on the issuing thread, so child totals cannot exceed the parent through
parallelism.

Copies across PCIe are counted beside the spans: a count and a byte
total per (stage, direction) (:meth:`SpanTracer.copy`), as the card's
path issues them whatever device the frames are on.

One clock with the device trace: while ``torch.profiler`` records, each
span of a ``MIRRORED`` stage opened with :meth:`SpanTracer.begin` is
also a host range ``taiji::<stage>`` in the profiler's timeline, from
the span's start to its end, so the profiler's events name the program's
stages. The tracer keeps one anchor pair (``perf_counter_ns``,
``time_ns``) that maps its spans onto the profiler's wall clock
(:func:`export_chrome` with ``profiler_base_ns``).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch.autograd.profiler as _prof
from torch._C._profiler import _RecordFunctionFast

from ..analysis.lock_order import named_lock

_perf_ns = time.perf_counter_ns

# --------------------------------------------------------------- stages
# (name, parent-name-or-None). The tree is static: self_time(stage) =
# total(stage) - sum(total(child) for declared children), clamped at 0.
# Instrumentation must keep child spans physically inside one parent
# span of the declared parent stage (on any thread) for the rollup to
# telescope: sum of self-times over a subtree == the root stage's total.
STAGES: Tuple[Tuple[str, Optional[str]], ...] = (
    # fleet NodeAgent wrapper entry (read_at/write_at/read_many/write_many)
    ("node_call", None),
    # one GuestSpace access call (scalar or batch)
    ("guest_access", "node_call"),
    # the frame copy of an access (tag = the access op)
    ("guest_copy", "guest_access"),
    # passive swap-in: whole fault, same interval the fault_ring records
    ("fault_total", "guest_access"),
    ("fault_mutex", "fault_total"),        # mp_mutex / rwlock / cond wait
    ("fault_desc", "fault_total"),         # descriptor lookup + admission
    ("fault_alloc", "fault_desc"),         # first-in slot alloc (+ critical
                                           # sync reclaim when below min)
    ("fault_copy", "fault_total"),         # memset / CRC / bitmap publish
    ("fault_backend", "fault_total"),      # backend decode + copy-in
    ("fault_readahead", "fault_total"),    # whole-extent sibling fill
    ("readahead_decode", "fault_readahead"),   # extent payload decompress
    # SwapEngine batched swap-out pipeline
    ("swap_out", None),
    ("backend_store", "swap_out"),         # store_batch wall time
    ("swap_compress", "backend_store"),    # compress fan-out (issuer wall)
    ("kernel_store", "backend_store"),     # pallas zero-scan / extent tags
    ("backend_remote_put", "backend_store"),   # remote-peer tier replica put
    # SwapEngine batched swap-in pipeline
    ("swap_in", None),
    ("backend_load", "swap_in"),           # load_batch wall time
    ("swap_decompress", "backend_load"),   # extent/blob decompress
    ("kernel_load", "backend_load"),       # pallas scatter dispatch
    ("backend_remote_get", "backend_load"),    # remote-peer tier replica get
    # hv_sched's background work: one LRU scan of a shard (tag = shard & 7)
    # and one reclaim round (its swap-outs are swap_out roots: swap_out
    # also runs outside reclaim)
    ("lru_scan", None),
    ("reclaim_round", None),
    # hv_sched task execution (tag = task kind, scheduler.TASK_*)
    ("sched_task", None),
    # one models.model.decode_step call: the host's dispatch of the step
    ("decode_step", None),
    # inside an eager decode step: one latent attention layer (absorbed
    # MLA over the latent pool) and one MoE FFN (moe_ffn's dispatch)
    ("mla_attn", "decode_step"),
    ("moe_ffn", "decode_step"),
    # fleet control plane
    ("fleet_tick", None),
    ("fleet_recovery", "fleet_tick"),      # dead-node re-placement
    ("fleet_step", "fleet_tick"),          # staggered node background rounds
    ("fleet_upgrade", "fleet_tick"),       # rolling-upgrade driving
    ("fleet_admission", None),
    ("fleet_placement", "fleet_admission"),
)

STAGE_NAMES: Tuple[str, ...] = tuple(name for name, _ in STAGES)
N_STAGES = len(STAGES)
N_TAGS = 8                               # 3 tag bits (fault kind / op / kind)

_IDX = {name: i for i, (name, _) in enumerate(STAGES)}
PARENT: Tuple[int, ...] = tuple(
    _IDX[parent] if parent is not None else -1 for _, parent in STAGES)
CHILDREN: Tuple[Tuple[int, ...], ...] = tuple(
    tuple(c for c, p in enumerate(PARENT) if p == s) for s in range(N_STAGES))

# stage-id constants for instrumented call sites
ST_NODE_CALL = _IDX["node_call"]
ST_GUEST_ACCESS = _IDX["guest_access"]
ST_GUEST_COPY = _IDX["guest_copy"]
ST_FAULT_TOTAL = _IDX["fault_total"]
ST_FAULT_MUTEX = _IDX["fault_mutex"]
ST_FAULT_DESC = _IDX["fault_desc"]
ST_FAULT_ALLOC = _IDX["fault_alloc"]
ST_FAULT_COPY = _IDX["fault_copy"]
ST_FAULT_BACKEND = _IDX["fault_backend"]
ST_FAULT_READAHEAD = _IDX["fault_readahead"]
ST_READAHEAD_DECODE = _IDX["readahead_decode"]
ST_SWAP_OUT = _IDX["swap_out"]
ST_BACKEND_STORE = _IDX["backend_store"]
ST_SWAP_COMPRESS = _IDX["swap_compress"]
ST_KERNEL_STORE = _IDX["kernel_store"]
ST_BACKEND_REMOTE_PUT = _IDX["backend_remote_put"]
ST_SWAP_IN = _IDX["swap_in"]
ST_BACKEND_LOAD = _IDX["backend_load"]
ST_SWAP_DECOMPRESS = _IDX["swap_decompress"]
ST_KERNEL_LOAD = _IDX["kernel_load"]
ST_BACKEND_REMOTE_GET = _IDX["backend_remote_get"]
ST_LRU_SCAN = _IDX["lru_scan"]
ST_RECLAIM_ROUND = _IDX["reclaim_round"]
ST_SCHED_TASK = _IDX["sched_task"]
ST_DECODE_STEP = _IDX["decode_step"]
ST_MLA_ATTN = _IDX["mla_attn"]
ST_MOE_FFN = _IDX["moe_ffn"]
ST_FLEET_TICK = _IDX["fleet_tick"]
ST_FLEET_RECOVERY = _IDX["fleet_recovery"]
ST_FLEET_STEP = _IDX["fleet_step"]
ST_FLEET_UPGRADE = _IDX["fleet_upgrade"]
ST_FLEET_ADMISSION = _IDX["fleet_admission"]
ST_FLEET_PLACEMENT = _IDX["fleet_placement"]

# access-op tags for node_call / guest_access / guest_copy spans;
# fault_total spans reuse the FK kind codes (metrics.FK_*) as tags, with
# bit 2 carrying FK_FAST
TAG_READ, TAG_WRITE, TAG_READ_MANY, TAG_WRITE_MANY, TAG_GATHER, TAG_SCATTER = \
    range(6)
# decode_step tags: how the step ran (models.model.decode_step) -- its
# body eagerly, a replay of its CUDA graph, or the capture of that graph
# followed by its first replay
DECODE_EAGER, DECODE_REPLAY, DECODE_CAPTURE = range(3)

# stages whose spans, opened with SpanTracer.begin, are also host ranges
# in torch.profiler's timeline while it records
MIRRORED = frozenset((
    "guest_access", "guest_copy", "fault_total", "fault_readahead",
    "swap_out", "swap_in", "backend_store", "backend_load", "swap_compress",
    "swap_decompress", "lru_scan", "reclaim_round", "sched_task",
    "decode_step", "mla_attn", "moe_ffn"))
_MIRROR = tuple(name in MIRRORED for name in STAGE_NAMES)
_RANGE_NAMES = tuple(f"taiji::{name}" for name in STAGE_NAMES)

# directions of a counted copy (SpanTracer.copy)
H2D, D2H = 0, 1
COPY_DIRS = ("h2d", "d2h")

_ENC_SHIFT = 16          # enc = ((dur_ns + 1) << 16) | (stage << 8) | tag


class SpanTracer:
    """Ring-buffered span recorder (``LatencyRing`` discipline).

    ``push(stage, t0_ns, dur_ns, tag)`` is three int64 stores; no lock,
    no allocation. Pushes are GIL-serialized; a push racing a flush can
    at worst be dropped (stats-only loss), never double-folded, because
    flush zeroes the encoded slots it copied and skips ``enc == 0``.
    A span of a ``MIRRORED`` stage starts with :meth:`begin` and ends
    with :meth:`end` (a push, and the profiler range closed).

    Aggregates (count / total / max per (stage, tag)) and a bounded
    retained-span store (for Chrome-trace export) are folded under
    ``_lock`` in :meth:`flush`; the copy counters are bumped under it.
    """

    __slots__ = ("_enc", "_t0", "_tid", "_pos", "_cap", "_lock",
                 "_count", "_total", "_max", "_copies",
                 "_chunks", "_kept", "max_spans", "pid", "anchor",
                 "_ranges", "_mirrored")

    def __init__(self, cap: int = 4096, max_spans: int = 200_000,
                 pid: int = 0) -> None:
        self._enc = np.zeros(cap, dtype=np.int64)
        self._t0 = np.zeros(cap, dtype=np.int64)
        self._tid = np.zeros(cap, dtype=np.int64)
        self._pos = 0
        self._cap = cap
        self._lock = named_lock("metrics")
        self._count = np.zeros((N_STAGES, N_TAGS), dtype=np.int64)
        self._total = np.zeros((N_STAGES, N_TAGS), dtype=np.int64)
        self._max = np.zeros((N_STAGES, N_TAGS), dtype=np.int64)
        # copies across PCIe: [count, bytes] at (stage * 2 + direction) * 2
        self._copies = [0] * (N_STAGES * 2 * 2)
        # retained decoded spans for export: (stage, t0, dur, tag, tid)
        self._chunks: List[Tuple[np.ndarray, ...]] = []
        self._kept = 0
        self.max_spans = max_spans
        self.pid = pid                     # Chrome-trace process id (node id)
        # (perf_counter_ns, time_ns) read together: a span's start on the
        # wall clock torch.profiler stamps its events with
        p0 = _perf_ns()
        wall = time.time_ns()
        self.anchor = ((p0 + _perf_ns()) // 2, wall)
        # open profiler ranges of this thread: [(stage, range)], innermost
        # last; _mirrored turns True with the first range ever opened
        self._ranges = threading.local()
        self._mirrored = False

    # ------------------------------------------------------------ hot path
    def push(self, stage: int, t0_ns: int, dur_ns: int, tag: int = 0) -> None:
        p = self._pos
        if p >= self._cap:
            self.flush()
            p = self._pos
            if p >= self._cap:           # racing pushers refilled the ring
                p = self._cap - 1        # overwrite the tail (stats-only)
        self._enc[p] = ((dur_ns + 1) << _ENC_SHIFT) | (stage << 8) | tag
        self._t0[p] = t0_ns
        self._tid[p] = threading.get_ident() & 0x7FFFFFFF
        self._pos = p + 1

    def begin(self, stage: int) -> int:
        """A span's start, ``perf_counter_ns``. While ``torch.profiler``
        records, a mirrored stage's span also opens its ``taiji::<stage>``
        range here, which :meth:`end` closes."""
        if _prof._is_profiler_enabled and _MIRROR[stage]:
            rf = _RecordFunctionFast(_RANGE_NAMES[stage])
            rf.__enter__()
            stack = getattr(self._ranges, "stack", None)
            if stack is None:
                stack = self._ranges.stack = []
            stack.append((stage, rf))
            self._mirrored = True
        return _perf_ns()

    def end(self, stage: int, t0_ns: int, tag: int = 0,
            dur_ns: Optional[int] = None) -> None:
        """Record the span :meth:`begin` started (``dur_ns``: its length,
        where the caller has read the clock) and close its range."""
        if dur_ns is None:
            dur_ns = _perf_ns() - t0_ns
        self.push(stage, t0_ns, dur_ns, tag)
        if self._mirrored:
            stack = getattr(self._ranges, "stack", None)
            if stack:
                # the innermost open range of this stage, and any range an
                # exception left open inside it; none where the profiler
                # started after this span did
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][0] == stage:
                        for _, rf in reversed(stack[i:]):
                            rf.__exit__(None, None, None)
                        del stack[i:]
                        break

    def copy(self, stage: int, direction: int, nbytes: int,
             n: int = 1) -> None:
        """Count ``n`` copies of ``nbytes`` in all across PCIe in
        ``stage``, ``direction`` ``H2D`` or ``D2H``."""
        i = (stage * 2 + direction) * 2
        with self._lock:
            self._copies[i] += n
            self._copies[i + 1] += nbytes

    # -------------------------------------------------------------- folding
    def flush(self) -> None:
        with self._lock:
            n = self._pos
            if n == 0:
                return
            enc = self._enc[:n].copy()
            t0 = self._t0[:n].copy()
            tid = self._tid[:n].copy()
            self._enc[:n] = 0            # stale-slot guard vs racing pushes
            self._pos = 0
            keep = enc != 0              # skip empty/already-folded slots
            if not keep.all():
                enc, t0, tid = enc[keep], t0[keep], tid[keep]
            if len(enc) == 0:
                return
            dur = (enc >> _ENC_SHIFT) - 1
            stage = (enc >> 8) & 0xFF
            tag = enc & 0xFF
            np.add.at(self._count, (stage, tag), 1)
            np.add.at(self._total, (stage, tag), dur)
            np.maximum.at(self._max, (stage, tag), dur)
            room = self.max_spans - self._kept
            if room > 0:
                k = min(room, len(enc))
                self._chunks.append((stage[:k], t0[:k], dur[:k],
                                     tag[:k], tid[:k]))
                self._kept += k

    # ------------------------------------------------------------ accessors
    @property
    def span_count(self) -> int:
        """Spans folded into aggregates so far (flushes first)."""
        self.flush()
        return int(self._count.sum())

    def stage_count(self, stage: str) -> int:
        self.flush()
        return int(self._count[_IDX[stage]].sum())

    def totals(self) -> Dict[str, Dict[str, object]]:
        """Per-stage aggregate view: count, total/max ns, per-tag split."""
        self.flush()
        out: Dict[str, Dict[str, object]] = {}
        for sid, name in enumerate(STAGE_NAMES):
            cnt = int(self._count[sid].sum())
            if cnt == 0:
                continue
            tags = {
                int(t): {"count": int(self._count[sid, t]),
                         "total_ns": int(self._total[sid, t]),
                         "max_ns": int(self._max[sid, t])}
                for t in np.flatnonzero(self._count[sid])}
            out[name] = {"count": cnt,
                         "total_ns": int(self._total[sid].sum()),
                         "max_ns": int(self._max[sid].max()),
                         "by_tag": tags}
        return out

    def copies(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """``{stage: {"h2d" | "d2h": {"count", "bytes"}}}`` for every
        stage with a counted copy."""
        with self._lock:
            c = list(self._copies)
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for sid, name in enumerate(STAGE_NAMES):
            for d, dname in enumerate(COPY_DIRS):
                i = (sid * 2 + d) * 2
                if c[i]:
                    out.setdefault(name, {})[dname] = {"count": c[i],
                                                       "bytes": c[i + 1]}
        return out

    def wall_ns(self, t_ns: int) -> int:
        """``perf_counter_ns`` time ``t_ns`` on the wall clock
        (``time_ns``), the clock of torch.profiler's events."""
        return t_ns - self.anchor[0] + self.anchor[1]

    def spans(self) -> Iterable[Tuple[int, int, int, int, int]]:
        """Decoded retained spans: (stage_id, t0_ns, dur_ns, tag, tid)."""
        self.flush()
        for stage, t0, dur, tag, tid in self._chunks:
            for i in range(len(stage)):
                yield (int(stage[i]), int(t0[i]), int(dur[i]),
                       int(tag[i]), int(tid[i]))


# ------------------------------------------------------- multi-tracer views
def aggregate(tracers: Iterable[SpanTracer]) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
    """Summed (count, total, max) arrays across tracers (flushes each)."""
    count = np.zeros((N_STAGES, N_TAGS), dtype=np.int64)
    total = np.zeros((N_STAGES, N_TAGS), dtype=np.int64)
    mx = np.zeros((N_STAGES, N_TAGS), dtype=np.int64)
    for tr in tracers:
        tr.flush()
        count += tr._count
        total += tr._total
        np.maximum(mx, tr._max, out=mx)
    return count, total, mx


def stage_tree(tracers: Iterable[SpanTracer]) -> Dict[str, Dict[str, object]]:
    """Aggregated stage tree with self-time rollup.

    Returns ``{stage: {count, total_ns, self_ns, max_ns, parent,
    by_tag}}`` for every stage with at least one span. ``self_ns`` is the
    stage total minus its declared children's totals, clamped at zero
    (a fan-out child running on pool threads can exceed the parent's
    wall time; the clamp keeps the rollup a partition, slightly
    under-attributing the parent in that case).
    """
    count, total, mx = aggregate(list(tracers))
    cnt_s = count.sum(axis=1)
    tot_s = total.sum(axis=1)
    out: Dict[str, Dict[str, object]] = {}
    for sid, (name, parent) in enumerate(STAGES):
        if cnt_s[sid] == 0:
            continue
        child_ns = int(sum(tot_s[c] for c in CHILDREN[sid]))
        out[name] = {
            "count": int(cnt_s[sid]),
            "total_ns": int(tot_s[sid]),
            "self_ns": max(0, int(tot_s[sid]) - child_ns),
            "max_ns": int(mx[sid].max()),
            "parent": parent,
            "by_tag": {int(t): {"count": int(count[sid, t]),
                                "total_ns": int(total[sid, t])}
                       for t in np.flatnonzero(count[sid])},
        }
    return out


def export_chrome(path: str, tracers: Iterable[SpanTracer],
                  profiler_base_ns: Optional[int] = None) -> int:
    """Write retained spans as Chrome-trace-event JSON (Perfetto/
    chrome://tracing loadable). Returns the number of events written.

    Events are complete-duration (``ph == "X"``) with microsecond ``ts``,
    ``pid`` = tracer pid (fleet node id) and ``tid`` = recording thread.
    ``ts`` counts from the earliest retained span; with
    ``profiler_base_ns`` (the ``baseTimeNanoseconds`` of a
    ``torch.profiler`` Chrome trace of the same run) it is on that
    trace's clock instead, each span mapped through its tracer's anchor,
    so the two files line up in one view.
    """
    tracers = list(tracers)
    for tr in tracers:
        tr.flush()
    base = min((int(t0.min()) for tr in tracers
                for _, t0, _, _, _ in tr._chunks if len(t0)), default=0)
    events = []
    for tr in tracers:
        for stage, t0, dur, tag, tid in tr._chunks:
            names = [STAGE_NAMES[s] for s in stage]
            ts = ((t0 - base) if profiler_base_ns is None
                  else (tr.wall_ns(t0) - profiler_base_ns)) / 1e3
            dur_us = dur / 1e3
            for i, name in enumerate(names):
                events.append({
                    "name": name, "cat": "taiji", "ph": "X",
                    "ts": float(ts[i]), "dur": float(dur_us[i]),
                    "pid": int(tr.pid), "tid": int(tid[i]),
                    "args": {"tag": int(tag[i])},
                })
    events.sort(key=lambda e: e["ts"])
    doc = {"traceEvents": events, "displayTimeUnit": "ns"}
    if profiler_base_ns is not None:
        doc["baseTimeNanoseconds"] = profiler_base_ns
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)
