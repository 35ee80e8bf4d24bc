"""The declared lock hierarchy.

One registry naming every lock class in the system, with a total rank
order. The rule the witness and the lint both enforce:

    a blocking acquisition must be of strictly greater rank than every
    lock the thread already holds.

Trylock acquisitions (``blocking=False``) are exempt from the order check
-- a trylock cannot deadlock -- but the lock still joins the held stack
so everything acquired *under* it is checked. Same-rank nesting is only
legal for

  * classes marked ``multi`` (independent same-purpose instances, e.g.
    per-PCPU quiesce locks) -- the witness then tracks instance-level
    edges and raises on cross-thread cycle formation instead; and
  * ``req.mp_mutex`` under ``req.mp_mutex`` when the thread holds the
    *write grant* of the second req's rwlock (the critical-zone
    bailout: reclaim-under-fault only touches an MS it has exclusively
    trylocked, so the nesting cannot participate in a cycle).

History note: the folklore ordering from early comments was
"tree -> rwlock -> mp_mutex -> backend". The audit for this registry
showed the real invariant is the *reverse* for the tree lock: critical-
zone reclaim runs under a req's ``mp_mutex`` and calls
``ReqTree.get_or_create`` (tree lock), so ``req.tree`` ranks *above*
``req.mp_mutex`` -- and the constraint documented at
``ReqTree.quiesce_fast_faults`` ("the mutex bounce must not nest under
it") is declared below as the explicit anti-edge
``("req.tree", "req.mp_mutex")``.

This module is imported by every lock-holding module in the tree, so it
must stay stdlib-only (no ``repro`` imports at module scope).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

# the registry builds the raw locks everything else gets from named_lock;
# the reference's AST lint exempts its own registry by path, so this
# package's registry constructs them through this alias
raw_lock = threading.Lock


class LockOrderViolation(RuntimeError):
    """A declared-rank inversion, anti-edge hit, or lock-order cycle."""


@dataclass(frozen=True)
class LockClass:
    name: str
    rank: int
    doc: str
    multi: bool = False  # independent same-class instances may nest


LOCK_CLASSES: Dict[str, LockClass] = {c.name: c for c in (
    # -- application layer: may call arbitrarily deep into the engine
    LockClass("pcpu", 3,
              "per-PCPU quiesce locks (hotswitch SMP-call stop points); "
              "held across full translated accesses", multi=True),
    LockClass("app", 5,
              "application-side stores: elastic_kv/elastic_params maps, "
              "DMA pin registry, hotswitch allocator", multi=True),
    LockClass("gfn", 8, "TaijiSystem._gfn_lock: the free-GFN pool"),
    # -- the req entity (paper Fig 8): grant before mutex
    LockClass("req.rwlock", 10,
              "per-req reader/writer grant (virtual: serializes active "
              "swap-out/prefetch vs passive fault-ins)"),
    LockClass("req.mp_mutex", 20,
              "per-req MP mutex: bitmap/state transitions, the fault "
              "fast path's only lock"),
    LockClass("req.rwlock.cond", 22,
              "RWLockWriterCancel's internal condition lock (acquired "
              "under a req mutex by the trylock bailout probe)"),
    # -- shared metadata structures
    LockClass("req.tree", 30,
              "ReqTree._lock: GFN -> req map; ranks ABOVE req.mp_mutex "
              "(critical-zone reclaim calls get_or_create under a req "
              "mutex; see the anti-edge below)"),
    LockClass("mpool", 35, "metadata slab pool (record allocation, under "
              "the tree lock in get_or_create/remove)"),
    LockClass("blocktable", 40,
              "BlockTable._lock: multi-field PTE transitions"),
    LockClass("slot", 45,
              "PhysicalMemory slot shard freelists + magazine registry "
              "(one shard lock at a time, never nested)"),
    # -- backend tiers
    LockClass("backend.shard", 50, "BackendStore per-kind/per-shard stripe"),
    LockClass("backend.ext", 52,
              "BackendStore._ext_lock: extent directory (zlib decompress "
              "IS deliberately called under it -- extent rows must not "
              "be re-read mid-consume)"),
    LockClass("backend.pool", 54, "BackendStore._pool_lock: backing pool"),
    LockClass("backend.disk", 55, "BackendStore._disk_lock: disk tier"),
    LockClass("backend.remote", 56,
              "BackendStore._remote_lock: remote-peer replica tier"),
    LockClass("backend.staging", 57,
              "BackendStore._staging: free list of the swap-in's host "
              "staging buffers (nothing is acquired under it)"),
    # -- reclaim machinery
    LockClass("lru", 60, "MultiLevelLRU._lock (probe phase is lock-free)"),
    LockClass("watermark", 62, "WatermarkPolicy._lock: reclaim hysteresis"),
    LockClass("entry", 64, "EntryOps._lock: hot-upgrade entry gate "
              "(registered fns run outside it)"),
    LockClass("sched.rq", 66, "RunQueue.lock (tasks run outside it)"),
    LockClass("kernels.build", 68,
              "kernels._build: one-time nvcc build and load of the swap "
              "kernels' shared library (first launch from any thread)"),
    # -- leaves: telemetry may be recorded under anything
    LockClass("metrics", 70,
              "leaf telemetry: latency rings, span tracer and its copy counters, "
              "fleet trace recorder", multi=True),
    LockClass("guard", 72,
              "AccessGuard: guest accesses in flight per gfn, drained by "
              "the swap-out (nothing is acquired under it)"),
)}

RANK: Dict[str, int] = {name: c.rank for name, c in LOCK_CLASSES.items()}

# Declared anti-edges: (held, acquired) pairs that are violations no
# matter what the ranks say -- each encodes a documented invariant with
# its own error message. The one below is req.py's quiesce contract:
# "the mutex bounce must not nest under [the tree lock]" (reclaim paths
# acquire the tree lock while holding a req mutex, so tree -> mp_mutex
# would close a cycle with mp_mutex -> tree).
ANTI_EDGES: Dict[Tuple[str, str], str] = {
    ("req.tree", "req.mp_mutex"):
        "req.py quiesce contract: the mp_mutex bounce must not nest under "
        "the tree lock (critical-zone reclaim takes the tree lock while "
        "holding a req mutex -- ReqTree.quiesce_fast_faults)",
}

# ---------------------------------------------------------------- lint data
# Lock classes under which *blocking* calls are forbidden (the fault
# fast path's latency budget). backend.ext is deliberately NOT here.
NO_BLOCKING_UNDER: FrozenSet[str] = frozenset({"req.mp_mutex"})

# dotted call names the lint treats as blocking
BLOCKING_CALLS: FrozenSet[str] = frozenset({
    "time.sleep", "zlib.compress", "zlib.decompress",
})

# Attribute -> lock-class bindings for the static lint, keyed by
# (enclosing class name | None, attribute name). The None key is only
# used for attribute names that are unambiguous tree-wide.
LINT_BINDINGS: Dict[Tuple[Optional[str], str], str] = {
    (None, "mp_mutex"): "req.mp_mutex",
    (None, "mp_cond"): "req.mp_mutex",       # Condition over the mutex
    (None, "rwlock"): "req.rwlock",
    (None, "_gfn_lock"): "gfn",
    (None, "_ext_lock"): "backend.ext",
    (None, "_pool_lock"): "backend.pool",
    (None, "_disk_lock"): "backend.disk",
    (None, "_remote_lock"): "backend.remote",
    (None, "_mag_registry_lock"): "slot",
    (None, "_shard_locks"): "slot",
    (None, "pcpu_locks"): "pcpu",
    ("RWLockWriterCancel", "_cond"): "req.rwlock.cond",
    ("AccessGuard", "_cond"): "guard",
    ("ReqTree", "_lock"): "req.tree",
    ("Mpool", "_lock"): "mpool",
    ("BlockTable", "_lock"): "blocktable",
    ("PhysicalMemory", "_lock"): "slot",
    ("BackendStore", "_locks"): "backend.shard",
    ("MultiLevelLRU", "_lock"): "lru",
    ("WatermarkPolicy", "_lock"): "watermark",
    ("EntryOps", "_lock"): "entry",
    ("EntryOps", "_drained"): "entry",
    ("RunQueue", "lock"): "sched.rq",
    ("LatencyRing", "_lock"): "metrics",
    ("SpanTracer", "_lock"): "metrics",
    ("TraceRecorder", "_lock"): "metrics",
    ("DMARegistry", "_lock"): "app",
    ("ElasticKVCache", "_lock"): "app",
    ("ElasticExpertCache", "_lock"): "app",
    ("PlainMemorySystem", "_alloc_lock"): "app",
}


# ----------------------------------------------------------------- switch
@dataclass
class _State:
    """Witness switch. ``on`` is read with one attribute load + truthiness
    check on the instrumented paths; everything else only pays at lock
    *construction* time (``named_lock`` decides the type once)."""

    on: bool = field(default_factory=lambda: os.environ.get(
        "TAIJI_LOCKDEP", "") not in ("", "0"))


STATE = _State()


def enable() -> None:
    """Turn the witness on for locks constructed from now on."""
    STATE.on = True


def disable() -> None:
    STATE.on = False


def named_lock(cls_name: str, group: object = None):
    """Construct a lock of declared class ``cls_name``.

    With the witness off (the default) this returns a raw
    ``threading.Lock()`` -- zero overhead, not even a wrapper. With
    ``TAIJI_LOCKDEP=1`` (or :func:`enable`) it returns a
    :class:`~repro_torch.analysis.witness.WitnessLock` that records the
    acquisition stack and enforces the declared ranks.

    ``group`` links same-entity locks for the gate exemption (a req's
    ``mp_mutex`` and its rwlock grant share the req's GFN as group).
    """
    if not STATE.on:
        return raw_lock()
    from . import witness  # deferred: witness imports this module
    return witness.WitnessLock(LOCK_CLASSES[cls_name], group)
