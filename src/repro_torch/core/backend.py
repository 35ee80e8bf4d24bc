"""Swap backend stores (paper §4.2.2 "backend", §7.2, Fig 15c).

    "Taiji uses in-memory zero pages and compression, prioritizing zero
     pages to minimize backend latency."  (§4.2.2)
    "Taiji's backend storage supports zero, compressed, free pages, remote
     memory, and disks."  (§7.2)

Store selection per MP on swap-out:
  1. zero page  -- store nothing but the kind tag; swap-in is a memset.
  2. free page  -- guest-reported free pages: drop content, rebuild zeroed
     on swap-in (disabled by default, as in production, §7.2).
  3. compressed -- lossless (zlib level 1 ~ lz4-class latency); the paper
     reports a 47.63% compressed/raw ratio over this population.
  4. disk       -- optional fallback tier for bursts beyond elasticity.

All stores are exact (lossless): CRC32 over the original MP guards the
round trip (§7.1). The *lossy* int8 KV-cache backend used by the device
integration is a beyond-paper option and lives in kernels/compress.py.

Concurrency: the former single global lock is split per kind and per
shard -- the compressed tier stripes its lock by ``(gfn, mp)`` hash
(``cfg.backend.lock_shards``), the disk tier has its own lock -- so
parallel swaps of different MSs no longer serialize on one mutex. The
batched entry points (:meth:`store_batch` / :meth:`load_batch`) move a
whole MP index vector per call: one vectorized zero scan, CRCs only for
non-zero rows (the zero-page CRC is a constant), and one lock acquisition
per touched shard instead of one per MP.

Extents: a batch's non-zero rows are concatenated and compressed as ONE
zlib stream (an *extent*); per-MP map entries are ``("x", extent_id,
row)`` references. One zlib call amortizes the per-call setup cost that
dominates 4 KiB-page compression, and cross-row redundancy compresses
better than row-at-a-time. A scalar fault on an extent row decompresses
the extent once and caches it raw so sibling faults are slice-only; with
``SwapConfig.readahead_enabled`` the swap engine goes further and
materializes every still-swapped sibling row on the first fault
(:meth:`extent_members` / :meth:`consume_extent_rows`). The map format
is process-local (never in the mpool arena), so none of this changes a
persistent ABI.

Entry tagging: every in-memory map value carries an explicit kind
subcode -- ``("z", blob)`` zlib-compressed, ``("v", raw)`` verbatim
(incompressible), ``("x", eid, row)`` extent reference -- instead of the
old ``len(blob) < len(out)`` sniffing, which silently double-decoded a
verbatim page whose bytes happened to look short.

Port: the batched entry points take rows on the frames' device.
:meth:`store_batch` reads its rows there once (``ops.gather_nonzero_rows``
flags the zero rows and compacts the non-zero ones) and tags the non-zero
rows (``ops.fletcher_rows``); only those rows and tags are copied to the
host -- once per batch -- for ``zlib.crc32``/``zlib.compress``.
Loads decode into a reused host staging buffer (pinned on the card),
verify the CRCs there, then upload the rows once; one launch
(``ops.scatter_verified_rows_``) re-checks the extent tags on the device
and writes the rows into ``out`` in place -- or nothing, where a tag
differs -- and one 4-byte verdict comes back.
Stored bytes, kinds, CRCs, extent tags and :meth:`stats` are the
reference's.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.lock_order import named_lock
from ..kernels import ops
from ..obs.tracer import (D2H, H2D, ST_BACKEND_LOAD, ST_BACKEND_REMOTE_GET,
                          ST_BACKEND_REMOTE_PUT, ST_BACKEND_STORE,
                          ST_KERNEL_LOAD, ST_KERNEL_STORE, ST_SWAP_COMPRESS,
                          ST_SWAP_DECOMPRESS)
from .config import TaijiConfig
from .errors import CorruptionError
from .metrics import Metrics
from .ms import K_COMPRESSED, K_DISK, K_FREE, K_NONE, K_ZERO
from .virt import resolve_device

_perf_ns = time.perf_counter_ns

# ------------------------------------------------- modeled tier latency
# Per-tier service times as *data, not measurement* (the tracehm/flatmem
# discipline: `Memory(capacity, read_lat, write_lat)` accrues a declared
# latency per access, so placement policies are comparable on a laptop
# before any real transport exists). Values are per-MP figures for the
# in-production tiers the paper names (§7.2): a zero fill is a memset, a
# compressed load is one lz4-class decompress share, disk is an NVMe
# read, and the remote tier is one RTT on a DPU-to-DPU RDMA fabric
# (DxPU-class fabrics measure 10-20us round trips at 4KiB). `load_batch`
# accrues these into `modeled_load_ns`; the remote put/get paths accrue
# `REMOTE_*_LAT_NS` into `remote_modeled_ns`.
TIER_READ_LAT_NS = {K_ZERO: 500, K_FREE: 500, K_COMPRESSED: 2_500,
                    K_DISK: 100_000}
REMOTE_READ_LAT_NS = 12_000    # peer DRAM fetch: one RTT + payload
REMOTE_WRITE_LAT_NS = 18_000   # replica placement: RTT + remote store


def modeled_policy_ns(n_local: int, n_remote: int, policy: str) -> int:
    """Modeled total swap-in service time under a placement policy.

    flatmem's FastSwap/SlowSwap/SmartSwap trio, recast for the
    zero-copy-free world of modeled latencies: ``fast`` keeps every
    payload in local compressed DRAM (cheapest loads, no durability),
    ``slow`` pushes everything to the remote peer tier (every load pays
    the RTT), ``smart`` is the deployed split -- locals load locally and
    only the replicated fully-swapped population pays remote latency
    when (and only when) recovery actually needs a peer copy.
    """
    local = TIER_READ_LAT_NS[K_COMPRESSED]
    total = n_local + n_remote
    if policy == "fast":
        return total * local
    if policy == "slow":
        return total * REMOTE_READ_LAT_NS
    if policy == "smart":
        return n_local * local + n_remote * REMOTE_READ_LAT_NS
    raise ValueError(f"unknown placement policy {policy!r}")


class _Extent:
    """One batch-compressed extent: a joint zlib stream over N MP rows.

    ``mps[row]`` maps each row back to its MP index (the readahead path
    materializes siblings through it); ``remaining`` counts live rows;
    ``dropped`` counts rows discarded via :meth:`BackendStore.drop` so
    their integer-spread share of ``stored_len`` can be returned to the
    compression accounting exactly.
    """

    __slots__ = ("payload", "is_raw", "remaining", "stored_len", "mps",
                 "total", "dropped", "crc", "verified", "tags")

    def __init__(self, payload: bytes, stored_len: int, mps: List[int],
                 crc: int, tags: Optional[np.ndarray] = None) -> None:
        self.payload = payload       # zlib stream, or raw once cached
        self.is_raw = False
        self.remaining = len(mps)
        self.stored_len = stored_len
        self.mps = mps               # row -> MP index
        self.total = len(mps)
        self.dropped = 0
        # whole-extent CRC over the raw concatenation: readahead verifies
        # the decompressed buffer with ONE crc32 call instead of one per
        # row (verified latches so sibling materializations skip recheck)
        self.crc = crc
        self.verified = False
        # device-side per-row Fletcher tags (ops.fletcher_rows); None
        # for extents that were not stored through store_batch
        self.tags = tags


class _Staging:
    """Reused staging buffers for the swap-in's uploads: a lock-guarded
    free list of (host, device, event), each at least ``nbytes``
    (``batch_mps * mp_bytes``) and grown on demand. Where the frames are
    on the card the host buffer is pinned (an asynchronous upload is one
    DMA; the CPU-only build cannot pin) and has a device twin of the same
    size, whose reuse the stream orders. A pair given back with its
    upload still in flight carries a recorded event, and is handed out
    again only after it."""

    def __init__(self, device: torch.device, nbytes: int) -> None:
        self.device = device
        self.nbytes = nbytes
        self._free: List[tuple] = []
        self._lock = named_lock("backend.staging")

    def take(self, nbytes: int) -> tuple:
        """``(host, device or None, event or None)``, free to overwrite."""
        with self._lock:
            for j, entry in enumerate(self._free):
                if entry[0].numel() >= nbytes:
                    del self._free[j]
                    break
            else:
                entry = None
        if entry is None:
            size = max(nbytes, self.nbytes)
            if self.device.type == "cuda":
                return (torch.empty(size, dtype=torch.uint8, pin_memory=True),
                        torch.empty(size, dtype=torch.uint8, device=self.device),
                        torch.cuda.Event())
            return torch.empty(size, dtype=torch.uint8), None, None
        if entry[2] is not None:
            entry[2].synchronize()        # its last upload has been read
        return entry

    def give(self, entry: tuple, in_flight: bool) -> None:
        """Return a pair; ``in_flight``: an upload from it may still be
        running on the current stream."""
        if in_flight and entry[2] is not None:
            entry[2].record()
        with self._lock:
            self._free.append(entry)


class BackendStore:
    """Unified backend over the zero/free/compressed/disk tiers."""

    def __init__(self, cfg: TaijiConfig, metrics: Metrics,
                 device=None) -> None:
        self.cfg = cfg
        self.metrics = metrics
        # where store_batch/load_batch rows live and the tag check runs
        # (``None``: the card, as every entry point)
        self.device = resolve_device(device)
        # per-shard lock stripe over the compressed map; each (gfn, mp) key
        # maps to exactly one stripe, so per-key ops never race. Values are
        # explicitly tagged tuples: ("z", blob) zlib, ("v", raw) verbatim,
        # ("x", eid, row) extent reference into self._extents.
        self._locks: List[threading.Lock] = [
            named_lock("backend.shard")
            for _ in range(max(1, cfg.backend.lock_shards))]
        self._compressed: Dict[Tuple[int, int], tuple] = {}
        # batch extents: (gfn, eid) -> _Extent; the payload is the zlib
        # stream until the first partial load caches it raw, stored_len
        # stays the compressed size so accounting is unaffected
        self._ext_lock = named_lock("backend.ext")
        self._extents: Dict[Tuple[int, int], _Extent] = {}
        self._ext_seq = 0
        # per-kind lock: the disk tier appends through its own mutex
        self._disk_lock = named_lock("backend.disk")
        self._disk_offsets: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._disk_file = None
        self._disk_tail = 0
        if cfg.backend.disk_fallback_path:
            self._disk_file = open(cfg.backend.disk_fallback_path, "w+b")
        self._free_page_probe = None  # guest free-page detector hook (§7.2)
        # CRC of an all-zero MP is constant: the zero-page fault fast path
        # compares against it instead of recomputing a CRC per fault
        self.zero_crc = zlib.crc32(bytes(cfg.mp_bytes))
        hp = getattr(cfg.swap, "hot_path", None)
        # extent (de)compression worker pool (HotPathConfig.compress_workers):
        # zlib releases the GIL, so extents compress in parallel; results
        # always merge in submission order so the stored bytes are
        # identical for any worker count. Lazily created: most systems in
        # tests never swap enough to need it.
        self._pool = None
        self._pool_lock = named_lock("backend.pool")
        self._pool_workers = int(hp.compress_workers) if hp is not None else 0
        # decoded-extent LRU: bounded cache of decompressed
        # extent payloads keyed (gfn, eid), guarded by _ext_lock. With it
        # enabled, extents keep their compressed payload and sibling-MP
        # faults / readahead serve decoded bytes from here -- skipping
        # zlib entirely on a hit -- while decoded retention stays bounded
        # at `extent_cache_entries` buffers instead of one raw buffer per
        # live extent. Inserts verify against the stored whole-extent CRC
        # (a corrupt stream never enters the cache); entries die with
        # their extent (drop / consume_extent_rows) or by LRU eviction.
        # 0 keeps the legacy decompress-in-place behavior.
        self._ext_cache_cap = (int(getattr(hp, "extent_cache_entries", 0) or 0)
                               if hp is not None else 0)
        from collections import OrderedDict as _OD
        self._ext_cache: "Dict[Tuple[int, int], bytes]" = _OD()
        self.ext_cache_hits = 0
        self.ext_cache_misses = 0
        # remote-peer tier: replica blobs this store holds ON
        # BEHALF OF other nodes, keyed (owner_node_id, gfn). The fleet
        # controller brokers placement (leases) and calls remote_put /
        # remote_get / remote_drop through the owning NodeAgent; a
        # single-node system never touches this map. Blobs are opaque
        # (zlib over the owner's export image) with their own CRC, so a
        # peer can hand back bytes it cannot interpret.
        self._remote_lock = named_lock("backend.remote")
        self._remote: Dict[Tuple[int, int], Tuple[bytes, int]] = {}
        self.remote_puts = 0
        self.remote_gets = 0
        self.remote_drops = 0
        self.remote_held_bytes = 0
        self.remote_modeled_ns = 0     # accrued REMOTE_*_LAT_NS (data)
        self.modeled_load_ns = 0       # accrued TIER_READ_LAT_NS (data)
        # stage-attributed tracing (repro_torch.obs): spans for the compress
        # fan-out and the device kernel calls; None when disabled
        self._tr = metrics.tracer
        # host buffers the swap-in stages its rows in before their upload
        self._staging = _Staging(self.device,
                                 max(1, cfg.swap.batch_mps) * cfg.mp_bytes)

    def _compress_pool(self):
        """The lazy extent-compression pool, or ``None`` for the serial
        path (``compress_workers <= 1``)."""
        if self._pool_workers <= 1:
            return None
        if self._pool is None:
            with self._pool_lock:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._pool = ThreadPoolExecutor(
                        max_workers=self._pool_workers,
                        thread_name_prefix="taiji-ext")
        return self._pool

    def _shard_idx(self, gfn: int, mp: int) -> int:
        return (gfn * 1000003 + mp) % len(self._locks)

    def _shard(self, gfn: int, mp: int) -> threading.Lock:
        return self._locks[self._shard_idx(gfn, mp)]

    # ------------------------------------------------------------- swap-out
    def store(self, gfn: int, mp: int, data: np.ndarray) -> Tuple[int, int]:
        """Store one MP. Returns (backend_kind, crc32-of-original)."""
        bk = self.cfg.backend
        crc = zlib.crc32(data) if bk.crc_enabled else 0
        raw = data.tobytes()

        if bk.free_page_enabled and self._free_page_probe is not None \
                and self._free_page_probe(gfn, mp):
            # guest says the page is free: drop content entirely
            return K_FREE, crc

        if bk.zero_page_enabled and not np.any(data):
            self.metrics.backend_zero_mps += 1
            return K_ZERO, crc

        if bk.compression_enabled:
            blob = zlib.compress(raw, bk.compression_level)
            if len(blob) < len(raw):
                with self._shard(gfn, mp):
                    self._compressed[(gfn, mp)] = ("z", blob)
                self.metrics.backend_compressed_mps += 1
                self.metrics.backend_raw_bytes += len(raw)
                self.metrics.backend_stored_bytes += len(blob)
                return K_COMPRESSED, crc

        if self._disk_file is not None:
            with self._disk_lock:
                off = self._disk_tail
                self._disk_file.seek(off)
                self._disk_file.write(raw)
                self._disk_tail += len(raw)
                self._disk_offsets[(gfn, mp)] = (off, len(raw))
            return K_DISK, crc

        # incompressible and no disk tier: store verbatim in the
        # compressed map (zswap does the same for incompressible pages)
        with self._shard(gfn, mp):
            self._compressed[(gfn, mp)] = ("v", raw)
        self.metrics.backend_compressed_mps += 1
        self.metrics.backend_raw_bytes += len(raw)
        self.metrics.backend_stored_bytes += len(raw)
        return K_COMPRESSED, crc

    # -------------------------------------------------------------- swap-in
    def _read_entry(self, gfn: int, mp: int, kind: int,
                    out: np.ndarray) -> Optional[tuple]:
        """Materialize one stored MP into ``out`` without consuming it.

        Shared by the consuming :meth:`load` (fault path) and the
        non-consuming :meth:`peek` (migration export). Returns the
        compressed-map entry -- ``load`` needs it to release an extent
        row -- or ``None`` for zero/free/disk kinds.
        """
        if kind == K_ZERO or kind == K_FREE:
            out[:] = 0
            return None
        if kind == K_COMPRESSED:
            with self._shard(gfn, mp):
                entry = self._compressed.get((gfn, mp))
            if entry is None:
                raise CorruptionError(
                    f"no backend entry for gfn={gfn} mp={mp}")
            tag = entry[0]
            if tag == "x":                        # extent reference
                n = self.cfg.mp_bytes
                row = entry[2]
                raw = self._ext_peek(gfn, entry[1])[row * n:(row + 1) * n]
            elif tag == "z":                      # zlib blob
                raw = zlib.decompress(entry[1])
            else:                                 # "v": stored verbatim
                raw = entry[1]
            out[:] = np.frombuffer(raw, dtype=np.uint8)
            return entry
        if kind == K_DISK:
            with self._disk_lock:
                loc = self._disk_offsets.get((gfn, mp))
                if loc is None:
                    raise CorruptionError(
                        f"no disk entry for gfn={gfn} mp={mp}")
                self._disk_file.seek(loc[0])
                raw = self._disk_file.read(loc[1])
            out[:] = np.frombuffer(raw, dtype=np.uint8)
            return None
        if kind == K_NONE:
            raise CorruptionError(f"no backend entry for gfn={gfn} mp={mp}")
        raise CorruptionError(f"unknown backend kind {kind}")

    def peek(self, gfn: int, mp: int, kind: int, crc: int,
             out: np.ndarray) -> None:
        """Non-consuming :meth:`load`: fill ``out`` with the stored MP and
        verify its CRC, leaving the backend entry and the compression
        accounting untouched.

        The migration export path reads a source MS's swapped state
        through this, so a rejected or failed migration leaves the source
        exactly as it was. Not a fault: the fault_* page counters are not
        bumped (CRC checks still are).
        """
        self._read_entry(gfn, mp, kind, out)
        if self.cfg.backend.crc_enabled:
            self.metrics.crc_checks += 1
            actual = zlib.crc32(out)
            if actual != crc:
                self.metrics.crc_failures += 1
                raise CorruptionError(
                    f"CRC mismatch gfn={gfn} mp={mp}: {actual:#x} != {crc:#x}")

    def load(self, gfn: int, mp: int, kind: int, crc: int,
             out: torch.Tensor) -> None:
        """Load one MP into ``out`` (a device view of the physical MS).

        Verifies the CRC *before* consuming the backend entry, so a
        corrupt MP keeps failing detectably on every retry instead of
        losing its data to the first failed attempt. The MP is decoded
        and checked on the host and reaches ``out`` in one copy.
        """
        host = np.empty(self.cfg.mp_bytes, dtype=np.uint8)
        entry = self._read_entry(gfn, mp, kind, host)
        if kind == K_ZERO or kind == K_FREE:
            self.metrics.fault_zero_pages += 1
        elif kind == K_COMPRESSED:
            self.metrics.fault_compressed_pages += 1

        if self.cfg.backend.crc_enabled:
            self.metrics.crc_checks += 1
            actual = zlib.crc32(host)
            if actual != crc:
                self.metrics.crc_failures += 1
                raise CorruptionError(
                    f"CRC mismatch gfn={gfn} mp={mp}: {actual:#x} != {crc:#x}")
        if kind == K_ZERO or kind == K_FREE:
            out.zero_()
        else:
            out.copy_(torch.from_numpy(host))

        # verified: consume the entry
        if kind == K_COMPRESSED:
            with self._shard(gfn, mp):
                self._compressed.pop((gfn, mp), None)
            if entry[0] == "x":
                self._ext_release(gfn, entry[1], 1)
        elif kind == K_DISK:
            with self._disk_lock:
                self._disk_offsets.pop((gfn, mp), None)

    def drop(self, gfn: int, mp: int, kind: int) -> None:
        """Discard a stored MP without loading (e.g. MS freed by the guest).

        Dropped pages leave the compression accounting too: they exit the
        swapped population without a round trip, so keeping their bytes in
        ``backend_raw_bytes``/``backend_stored_bytes`` would skew
        ``compression_ratio`` ever further on long runs with guest frees.
        Extent rows return an exact integer-spread share of the extent's
        compressed size.
        """
        if kind == K_COMPRESSED:
            with self._shard(gfn, mp):
                entry = self._compressed.pop((gfn, mp), None)
            if entry is None:
                return
            m = self.metrics
            tag = entry[0]
            if tag == "x":
                with self._ext_lock:
                    ext = self._extents.get((gfn, entry[1]))
                    if ext is not None:
                        d = ext.dropped
                        share = (ext.stored_len * (d + 1) // ext.total
                                 - ext.stored_len * d // ext.total)
                        ext.dropped = d + 1
                        ext.remaining -= 1
                        if ext.remaining == 0:
                            del self._extents[(gfn, entry[1])]
                            self._ext_cache.pop((gfn, entry[1]), None)
                        m.backend_raw_bytes -= self.cfg.mp_bytes
                        m.backend_stored_bytes -= share
            else:                                 # "z" or "v" blob
                m.backend_raw_bytes -= self.cfg.mp_bytes
                m.backend_stored_bytes -= len(entry[1])
        elif kind == K_DISK:
            with self._disk_lock:
                self._disk_offsets.pop((gfn, mp), None)

    # ----------------------------------------------------------------- extents
    def _ext_cache_insert(self, key: Tuple[int, int], ext: _Extent,
                          raw: bytes) -> None:
        """Insert decoded bytes into the bounded LRU (caller holds
        ``_ext_lock``). Verifies against the stored whole-extent CRC
        first -- an unverifiable stream is served to the caller (whose
        own salvage path handles corruption) but never cached."""
        if self.cfg.backend.crc_enabled and not ext.verified:
            if zlib.crc32(raw) != ext.crc:
                return
            ext.verified = True
        cache = self._ext_cache
        cache[key] = raw
        while len(cache) > self._ext_cache_cap:
            cache.popitem(last=False)

    def _ext_raw(self, key: Tuple[int, int], ext: _Extent,
                 count: bool = True) -> bytes:
        """Raw payload of one extent. Callers hold ``_ext_lock``.

        Legacy mode (``extent_cache_entries == 0``): decompress + cache
        in place on the extent exactly once, so sibling rows are
        slice-only but the raw buffer lives as long as the extent. Cache
        mode: decoded payloads live in the bounded LRU instead -- a hit
        skips zlib entirely; after eviction the extent re-decompresses
        from its (still-compressed) payload."""
        if ext.is_raw:
            return ext.payload
        if self._ext_cache_cap <= 0:
            ext.payload = zlib.decompress(ext.payload)
            ext.is_raw = True
            return ext.payload
        cache = self._ext_cache
        raw = cache.get(key)
        if raw is not None:
            cache.move_to_end(key)
            if count:
                self.ext_cache_hits += 1
            return raw
        if count:
            self.ext_cache_misses += 1
        raw = zlib.decompress(ext.payload)
        self._ext_cache_insert(key, ext, raw)
        return raw

    def _ext_peek(self, gfn: int, eid: int, count: bool = True) -> bytes:
        """Return the whole raw buffer of an extent without consuming any
        rows (decompresses on first touch; cached raw thereafter).
        ``count=False`` skips the hit/miss counters -- used by
        :meth:`load_batch` right after :meth:`_ext_prefetch_raw` already
        charged this extent, so each touch is counted exactly once."""
        with self._ext_lock:
            return self._ext_raw((gfn, eid), self._extents[(gfn, eid)],
                                 count=count)

    def _ext_prefetch_raw(self, gfn: int, eids: List[int]) -> None:
        """Decompress several extents' payloads concurrently through the
        worker pool, then install the raw buffers under ``_ext_lock``.

        Purely an optimization of :meth:`_ext_peek`: installation
        rechecks ``is_raw`` so a racing decompress (scalar fault, other
        batch) simply wins the cache; the bytes are identical either way.
        """
        pool = self._compress_pool()
        with self._ext_lock:
            todo = []
            for eid in eids:
                ext = self._extents.get((gfn, eid))
                if ext is None or ext.is_raw:
                    continue
                if self._ext_cache_cap > 0:
                    if (gfn, eid) in self._ext_cache:
                        # readahead served from the decoded-extent LRU:
                        # count the hit and refresh recency, exactly as a
                        # scalar fault through _ext_raw would
                        self._ext_cache.move_to_end((gfn, eid))
                        self.ext_cache_hits += 1
                        continue
                    self.ext_cache_misses += 1
                todo.append((eid, ext.payload))
        if not todo:
            return
        if pool is not None and len(todo) > 1:
            raws = list(pool.map(zlib.decompress, [p for _, p in todo]))
        else:
            raws = [zlib.decompress(p) for _, p in todo]
        with self._ext_lock:
            for (eid, _), raw in zip(todo, raws):
                ext = self._extents.get((gfn, eid))
                if ext is None or ext.is_raw:
                    continue
                if self._ext_cache_cap > 0:
                    if (gfn, eid) not in self._ext_cache:
                        self._ext_cache_insert((gfn, eid), ext, raw)
                else:
                    ext.payload = raw
                    ext.is_raw = True

    def _ext_release(self, gfn: int, eid: int, count: int) -> None:
        """Consume ``count`` rows of an extent, freeing it on the last."""
        with self._ext_lock:
            ext = self._extents.get((gfn, eid))
            if ext is None:
                return
            ext.remaining -= count
            if ext.remaining <= 0:
                del self._extents[(gfn, eid)]
                self._ext_cache.pop((gfn, eid), None)

    # ------------------------------------------------- extent readahead API
    def extent_members(self, gfn: int, mp: int):
        """Probe whether ``(gfn, mp)`` is stored as an extent row.

        Returns ``(eid, row, live)`` where ``live`` is the list of
        ``(mp, row)`` pairs whose *current* map entry still references
        this extent -- a member that was consumed and later re-swapped
        points at a different entry and must not be materialized from the
        stale row. ``None`` for standalone blobs. Nothing is consumed;
        the swap engine claims sibling MPs under the req's MP mutex (its
        ``bm_in`` latch makes the later :meth:`consume_extent_rows` safe).
        """
        with self._shard(gfn, mp):
            entry = self._compressed.get((gfn, mp))
        if entry is None or entry[0] != "x":
            return None
        eid = entry[1]
        with self._ext_lock:
            ext = self._extents.get((gfn, eid))
            if ext is None:
                return None
            members = list(ext.mps)
        live = []
        for row, mpj in enumerate(members):
            # plain dict read: per-key mutations happen under the caller's
            # req mutex / bm latches, so this view is stable for the caller
            if self._compressed.get((gfn, mpj)) == ("x", eid, row):
                live.append((mpj, row))
        return eid, entry[2], live

    def extent_payload(self, gfn: int, eid: int, verify: bool = False):
        """Whole raw extent buffer for readahead (decompressed exactly once).

        Returns ``(raw, crc_ok)``. With ``verify`` the raw buffer is
        checked against the whole-extent CRC -- one crc32 call covers
        every row, and the result latches so sibling materializations
        skip the recheck. ``crc_ok=False`` tells the engine to fall back
        to per-row salvage against the record CRCs.
        """
        with self._ext_lock:
            ext = self._extents[(gfn, eid)]
            raw = self._ext_raw((gfn, eid), ext)
            if not verify or ext.verified:
                return raw, True
            want = ext.crc
        ok = zlib.crc32(raw) == want
        if ok:
            with self._ext_lock:
                cur = self._extents.get((gfn, eid))
                if cur is ext:
                    ext.verified = True
        return raw, ok

    def consume_extent_rows(self, gfn: int, eid: int, mps: List[int]) -> None:
        """Retire ``mps`` rows of one extent after a verified readahead.

        Callers must hold every row's ``bm_in`` latch (exactly-once per
        MP), so each key is popped at most once. One lock acquisition per
        touched shard, not one per MP.
        """
        by_shard: Dict[int, List[int]] = {}
        for mp in mps:
            by_shard.setdefault(self._shard_idx(gfn, mp), []).append(mp)
        for shard, shard_mps in by_shard.items():
            with self._locks[shard]:
                for mp in shard_mps:
                    self._compressed.pop((gfn, mp), None)
        self._ext_release(gfn, eid, len(mps))

    # ================================================= remote-peer tier ==
    def remote_put(self, owner: int, gfn: int, blob: bytes,
                   crc: int) -> bool:
        """Hold a replica blob for ``(owner, gfn)`` on behalf of a peer.

        Idempotent overwrite: a re-replication after partial progress
        replaces the held bytes and re-counts the space exactly. Returns
        ``True`` (placement admission -- zone checks -- is the
        controller's job, not the store's).
        """
        tr = self._tr
        t0 = _perf_ns() if tr is not None else 0
        with self._remote_lock:
            prev = self._remote.get((owner, gfn))
            if prev is not None:
                self.remote_held_bytes -= len(prev[0])
            self._remote[(owner, gfn)] = (blob, crc)
            self.remote_puts += 1
            self.remote_held_bytes += len(blob)
            self.remote_modeled_ns += REMOTE_WRITE_LAT_NS
        if tr is not None:
            tr.push(ST_BACKEND_REMOTE_PUT, t0, _perf_ns() - t0)
        return True

    def remote_get(self, owner: int, gfn: int) -> Optional[bytes]:
        """Fetch (without consuming) the replica held for ``(owner,
        gfn)``. Verifies the blob against its put-time CRC -- a bit-rot
        replica returns ``None`` rather than corrupt bytes, and the
        caller treats it like a missing copy."""
        tr = self._tr
        t0 = _perf_ns() if tr is not None else 0
        with self._remote_lock:
            entry = self._remote.get((owner, gfn))
            self.remote_gets += 1
            self.remote_modeled_ns += REMOTE_READ_LAT_NS
        if tr is not None:
            tr.push(ST_BACKEND_REMOTE_GET, t0, _perf_ns() - t0)
        if entry is None:
            return None
        blob, crc = entry
        if zlib.crc32(blob) != crc:
            self.metrics.crc_failures += 1
            return None
        return blob

    def remote_drop(self, owner: int, gfn: int) -> bool:
        """Release the replica held for ``(owner, gfn)`` (lease broken:
        owner wrote the MS, freed it, or the lease moved elsewhere)."""
        with self._remote_lock:
            entry = self._remote.pop((owner, gfn), None)
            if entry is None:
                return False
            self.remote_drops += 1
            self.remote_held_bytes -= len(entry[0])
        return True

    def remote_held(self) -> int:
        """Number of peer replicas currently held by this store."""
        with self._remote_lock:
            return len(self._remote)

    # ================================================== batched data path ==
    def store_batch(self, gfn: int, mps: np.ndarray, data: torch.Tensor,
                    rows: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Store row ``rows[i]`` of ``data`` (uint8 rows on the frames'
        device; ``rows`` defaults to ``arange(len(mps))``) as MP ``mps[i]``
        of ``gfn``.

        Returns ``(kinds, crcs)`` aligned with ``mps``. Observationally
        identical to ``store`` called per row: same kind selection, same
        zlib CRCs, same round-trip bytes. The on-backend representation
        may differ -- without a disk tier, non-zero rows are stored as one
        joint extent rather than per-row blobs. One device pass
        (``ops.gather_nonzero_rows``) reads the batch's rows once, flags
        the zero ones and compacts the non-zero ones; only those cross to
        the host, with their Fletcher tags, in one more transfer. Zero
        rows reuse the constant zero-page CRC and tag, and their bytes
        never leave the device.
        """
        bk = self.cfg.backend
        k = len(mps)
        n = self.cfg.mp_bytes
        rows = np.arange(k) if rows is None else np.asarray(rows)
        assert len(rows) == k and data.shape[1:] == (n,)
        kinds = np.full(k, K_NONE, dtype=np.uint8)
        crcs = np.zeros(k, dtype=np.uint32)
        tr = self._tr

        if tr is not None:
            t_k = _perf_ns()
        zero_t, nz_dev = ops.gather_nonzero_rows(data, rows)
        zero = zero_t.numpy()
        if tr is not None:
            tr.push(ST_KERNEL_STORE, t_k, _perf_ns() - t_k)
            tr.copy(ST_BACKEND_STORE, D2H, 4 + k)   # the count and zero flags

        free_rows: List[int] = []
        if bk.free_page_enabled and self._free_page_probe is not None:
            free_rows = [i for i in range(k)
                         if self._free_page_probe(gfn, int(mps[i]))]
        if free_rows:
            kinds[free_rows] = K_FREE

        zero_rows = np.flatnonzero(zero) if bk.zero_page_enabled else np.empty(0, int)
        zero_rows = [i for i in zero_rows if kinds[i] == K_NONE]
        kinds[zero_rows] = K_ZERO
        self.metrics.backend_zero_mps += len(zero_rows)

        rest = np.flatnonzero(kinds == K_NONE)
        # the extent fast path only applies without a disk tier: with one
        # configured, kind selection must stay scalar-identical (each
        # incompressible row spills to disk, not into a resident extent)
        use_extent = bk.compression_enabled and self._disk_file is None
        # host bytes are needed for the non-zero rows' CRCs and for every
        # row that is compressed or stored, the zero ones written on the
        # host; with extents the device also tags the non-zero rows (a zero
        # row's tag is 0). Rows and tags come over in one transfer
        nz = np.flatnonzero(~zero) if bk.crc_enabled else rest[:0]
        host, tags = np.empty((0, n), np.uint8), []
        if len(nz_dev):
            if tr is not None:
                t_k = _perf_ns()
            tags = ([ops.fletcher_rows(nz_dev)] if len(rest) and use_extent
                    else [])
            host, *tags = (t.numpy() for t in ops.copy_to_host(nz_dev, *tags))
            if tr is not None:
                tr.push(ST_KERNEL_STORE, t_k, _perf_ns() - t_k)
                tr.copy(ST_BACKEND_STORE, D2H,
                        host.nbytes + sum(t.nbytes for t in tags), 1 + len(tags))
        rank = np.cumsum(~zero) - 1      # batch row -> row of ``host``
        row_tags = np.zeros(k, dtype=np.uint32)
        if tags:
            row_tags[~zero] = tags[0]

        def host_rows(sub: np.ndarray) -> np.ndarray:
            """The bytes of batch rows ``sub``; zero rows written here."""
            live = ~zero[sub]
            if live.all():
                return host[rank[sub]]
            out = np.zeros((len(sub), n), dtype=np.uint8)
            out[live] = host[rank[sub[live]]]
            return out

        if bk.crc_enabled:
            # an all-zero row's CRC is the constant zero-page CRC, so only
            # non-zero rows pay a crc32 pass
            crcs[:] = self.zero_crc
            if len(nz):
                crcs[nz] = [zlib.crc32(host[p]) for p in rank[nz].tolist()]

        # compress the remainder as extents: one zlib stream over a run of
        # concatenated rows amortizes the per-call setup that dominates
        # small-page compression and exploits cross-row redundancy.
        # ``extent_max_rows`` caps each stream so the first fault into an
        # extent (which decompresses it whole) has a bounded latency.
        raw_total = stored_total = compressed_n = 0
        pending: Dict[int, List[Tuple[Tuple[int, int], object]]] = {}
        disk_rows: List[Tuple[int, bytes]] = []
        if len(rest) and use_extent:
            max_rows = max(1, bk.extent_max_rows)
            leftovers: List[np.ndarray] = []
            # chunk boundaries are fixed by extent_max_rows, zlib.compress
            # is deterministic, and the pool merges in submission order:
            # the stored bytes are identical for any worker count
            chunks = [rest[lo:lo + max_rows]
                      for lo in range(0, len(rest), max_rows)]
            raw_cats = [host_rows(sub).tobytes() for sub in chunks]
            level = bk.compression_level
            pool = self._compress_pool() if len(chunks) > 1 else None
            # one swap_compress span covers the whole fan-out's wall time
            # on the issuing thread (per-worker spans would overlap and
            # sum past the enclosing backend_store span)
            if tr is not None:
                t_z = tr.begin(ST_SWAP_COMPRESS)
            if pool is not None:
                ext_blobs = list(pool.map(
                    lambda rc: zlib.compress(rc, level), raw_cats))
            else:
                ext_blobs = [zlib.compress(rc, level) for rc in raw_cats]
            if tr is not None:
                tr.end(ST_SWAP_COMPRESS, t_z)
            for sub, raw_cat, ext_blob in zip(chunks, raw_cats, ext_blobs):
                if len(ext_blob) >= len(raw_cat):
                    leftovers.append(sub)     # incompressible: per-row path
                    continue
                ext_mps = [int(mps[i]) for i in sub]
                ext_crc = zlib.crc32(raw_cat) if bk.crc_enabled else 0
                tags = row_tags[sub].copy()
                with self._ext_lock:
                    eid = self._ext_seq
                    self._ext_seq += 1
                    self._extents[(gfn, eid)] = _Extent(
                        ext_blob, len(ext_blob), ext_mps, ext_crc, tags)
                for row, i in enumerate(sub):
                    kinds[i] = K_COMPRESSED
                    mp = ext_mps[row]
                    pending.setdefault(self._shard_idx(gfn, mp), []).append(
                        (((gfn, mp)), ("x", eid, row)))
                compressed_n += len(sub)
                raw_total += len(raw_cat)
                stored_total += len(ext_blob)
            rest = (np.concatenate(leftovers) if leftovers
                    else rest[:0])
        if tr is not None and len(rest):
            t_z = tr.begin(ST_SWAP_COMPRESS)
        for i, raw_row in zip(rest, host_rows(rest)):
            # per-row fallback: same tier order as the scalar store()
            raw = raw_row.tobytes()
            blob = None
            if bk.compression_enabled:
                z = zlib.compress(raw, bk.compression_level)
                if len(z) < len(raw):
                    blob = z
            if blob is None and self._disk_file is not None:
                disk_rows.append((int(i), raw))
                kinds[i] = K_DISK
                continue
            # verbatim ("v") when incompressible, like the scalar store()
            entry = ("z", blob) if blob is not None else ("v", raw)
            kinds[i] = K_COMPRESSED
            compressed_n += 1
            raw_total += len(raw)
            stored_total += len(entry[1])
            mp = int(mps[i])
            pending.setdefault(self._shard_idx(gfn, mp), []).append(
                ((gfn, mp), entry))
        if tr is not None and len(rest):
            tr.end(ST_SWAP_COMPRESS, t_z)

        # one lock acquisition per touched shard, not one per MP
        for shard, entries in pending.items():
            with self._locks[shard]:
                for key, entry in entries:
                    self._compressed[key] = entry
        if disk_rows:
            with self._disk_lock:
                for i, raw in disk_rows:
                    off = self._disk_tail
                    self._disk_file.seek(off)
                    self._disk_file.write(raw)
                    self._disk_tail += len(raw)
                    self._disk_offsets[(gfn, int(mps[i]))] = (off, len(raw))

        self.metrics.backend_compressed_mps += compressed_n
        self.metrics.backend_raw_bytes += raw_total
        self.metrics.backend_stored_bytes += stored_total
        self.metrics.backend_batch_stores += 1
        return kinds, crcs

    def load_batch(self, gfn: int, mps: np.ndarray, kinds: np.ndarray,
                   crcs: np.ndarray, out: torch.Tensor, *,
                   rows: Optional[np.ndarray] = None) -> None:
        """Load MP ``mps[i]`` into row ``rows[i]`` of ``out`` (uint8 rows
        on the frames' device; by default ``out`` has the batch's rows,
        ``rows = arange(len(mps))``); verifies CRCs and extent tags.

        Zero/free rows have their CRCs checked against the constant
        zero-page CRC without touching the data. Compressed/disk rows read
        their blobs with one lock acquisition per touched shard and decode
        into one host staging buffer, beside every other row of each
        touched extent that carries Fletcher tags; their CRCs are checked
        there. Then one upload, one launch (``ops.scatter_verified_rows_``:
        the extent rows' tags checked on the device, the data rows written
        and the zero rows zeroed only if all of them match) and one 4-byte
        verdict back: one host wait.

        All-or-nothing: backend entries are only consumed -- and ``out``
        only written -- after every row's CRC and tag verify, so one
        corrupted MP doesn't take the rest of the chunk's data with it:
        the caller can retry or fault the good rows individually, and the
        bad row keeps failing detectably. The checks fail in the
        reference's order: the zero-page CRCs, then the extent tags in the
        order the batch first names each extent, then the CRCs of the data
        rows.
        """
        bk = self.cfg.backend
        k = len(mps)
        n = self.cfg.mp_bytes
        if rows is None:
            assert tuple(out.shape) == (k, n)
            rows = np.arange(k)
        rows = np.asarray(rows, dtype=np.int64)
        assert len(rows) == k and out.shape[1:] == (n,)
        kinds = np.asarray(kinds)
        crcs = np.asarray(crcs)

        if np.any(kinds == K_NONE):
            i = int(np.flatnonzero(kinds == K_NONE)[0])
            raise CorruptionError(
                f"no backend entry for gfn={gfn} mp={int(mps[i])}")
        if np.any(kinds > K_DISK):        # kinds are dense 0..K_DISK
            raise CorruptionError(
                f"unknown backend kind {int(kinds.max())}")

        zero_mask = (kinds == K_ZERO) | (kinds == K_FREE)
        zero_rows = np.flatnonzero(zero_mask)
        if len(zero_rows):
            self.metrics.fault_zero_pages += len(zero_rows)
            if bk.crc_enabled:
                self.metrics.crc_checks += len(zero_rows)
                bad = zero_rows[crcs[zero_rows] != self.zero_crc]
                if len(bad):
                    self.metrics.crc_failures += len(bad)
                    raise CorruptionError(
                        f"zero-page CRC mismatch gfn={gfn} "
                        f"mp={int(mps[int(bad[0])])}")

        data_rows = np.flatnonzero(~zero_mask)   # compressed + disk rows
        comp_rows = np.flatnonzero(kinds == K_COMPRESSED)
        disk_rows = np.flatnonzero(kinds == K_DISK)
        by_shard: Dict[int, List[int]] = {}
        by_ext: Dict[int, List[Tuple[int, int]]] = {}
        blob_rows: List[Tuple[int, tuple]] = []   # ("z" | "v") entries
        for i in comp_rows:
            by_shard.setdefault(
                self._shard_idx(gfn, int(mps[i])), []).append(int(i))
        blobs: Dict[int, tuple] = {}
        for shard, shard_rows in by_shard.items():
            with self._locks[shard]:
                for i in shard_rows:
                    blobs[i] = self._compressed[(gfn, int(mps[i]))]
        for i in comp_rows.tolist():
            entry = blobs[i]
            if entry[0] == "x":               # extent ref: staged below
                by_ext.setdefault(entry[1], []).append((i, entry[2]))
            else:
                blob_rows.append((i, entry))

        # the staging plan: every row of each extent that has tags (its
        # rows are checked whole, as the store tagged them), then the
        # loaded rows of the other extents, then the blob and disk rows.
        # dst: the row of ``out`` a staged row goes to (-1: verified
        # only); tag: its expected Fletcher tag (-1: none)
        plan = []
        n_staged = 0
        for eid, pairs in by_ext.items():
            with self._ext_lock:
                ext = self._extents.get((gfn, eid))
                tags = ext.tags if ext is not None else None
            plan.append((eid, pairs, tags, n_staged))
            n_staged += len(tags) if tags is not None else len(pairs)
        others = [i for i, _ in blob_rows] + disk_rows.tolist()
        other_base = n_staged
        n_staged += len(others)
        pos = np.zeros(k, dtype=np.int64)       # batch row -> staged row
        dst = np.full(n_staged, -1, dtype=np.int64)
        tag = np.full(n_staged, -1, dtype=np.int64)
        ext_of = []                             # tagged extents' (base, eid)
        for eid, pairs, tags, base in plan:
            if tags is not None:
                tag[base:base + len(tags)] = tags
                ext_of.append((base, eid))
                for i, row in pairs:
                    pos[i] = base + row
            else:
                for j, (i, _) in enumerate(pairs):
                    pos[i] = base + j
        pos[others] = other_base + np.arange(len(others))
        dst[pos[data_rows]] = rows[data_rows]

        # one staging pair: the rows, then (16-byte aligned) the verdict
        voff = -(-n_staged * n // 16) * 16
        staging = self._staging.take(voff + 16)
        in_flight = False
        try:
            stage = staging[0].numpy()[:n_staged * n].reshape(n_staged, n)
            tr = self._tr
            if tr is not None:
                t_dz = tr.begin(ST_SWAP_DECOMPRESS)
            for i, entry in blob_rows:
                if entry[0] == "z":
                    stage[pos[i]] = np.frombuffer(zlib.decompress(entry[1]),
                                                  dtype=np.uint8)
                else:                         # "v": stored verbatim
                    stage[pos[i]] = np.frombuffer(entry[1], dtype=np.uint8)
            prefetched = len(by_ext) > 1
            if prefetched:
                # decompress the batch's extents in parallel (zlib drops
                # the GIL); each payload installs idempotently under the
                # extent lock, so racing a concurrent scalar fault is safe
                self._ext_prefetch_raw(gfn, list(by_ext))
            if tr is not None:
                tr.end(ST_SWAP_DECOMPRESS, t_dz)
            for eid, pairs, tags, base in plan:
                # one decompress + one copy for the rows of this extent
                if tr is not None:
                    t_p = tr.begin(ST_SWAP_DECOMPRESS)
                raw = self._ext_peek(gfn, eid, count=not prefetched)
                if tr is not None:
                    # near-zero when the prefetch above already cached raw
                    tr.end(ST_SWAP_DECOMPRESS, t_p)
                arr = np.frombuffer(raw, dtype=np.uint8).reshape(-1, n)
                if tags is not None:
                    stage[base:base + len(tags)] = arr
                else:
                    stage[base:base + len(pairs)] = arr[[p[1] for p in pairs]]
            if len(disk_rows):
                with self._disk_lock:
                    for i in disk_rows:
                        off, nb = self._disk_offsets[(gfn, int(mps[i]))]
                        self._disk_file.seek(off)
                        stage[pos[i]] = np.frombuffer(self._disk_file.read(nb),
                                                      dtype=np.uint8)

            crc_bad = None
            if bk.crc_enabled:
                want = crcs.tolist()
                for i, p in zip(data_rows.tolist(), pos[data_rows].tolist()):
                    actual = zlib.crc32(stage[p])
                    if actual != want[i]:
                        crc_bad = (i, actual, want[i])
                        break

            # the device step: with a CRC failure only the tags are
            # checked (verify only: the tag error comes first, as in the
            # reference); else the write, all or nothing
            if tr is not None:
                t_k = _perf_ns()
            bad_row = -1
            if crc_bad is None or ext_of:
                in_flight = out.device.type != "cpu"
                bad_row = ops.scatter_staged_rows_(
                    out, staging[0], staging[1], n_staged,
                    dst if crc_bad is None else np.full_like(dst, -1), tag,
                    rows[zero_rows] if crc_bad is None else None)
                in_flight = False                 # the verdict came back
                if tr is not None:
                    # the staged rows up, the 4-byte verdict back
                    tr.copy(ST_BACKEND_LOAD, H2D, n_staged * n)
                    tr.copy(ST_BACKEND_LOAD, D2H, 4)
            if tr is not None:
                tr.push(ST_KERNEL_LOAD, t_k, _perf_ns() - t_k)
            if bad_row >= 0:
                base, eid = max(e for e in ext_of if e[0] <= bad_row)
                self.metrics.crc_failures += 1
                raise CorruptionError(
                    f"extent tag mismatch gfn={gfn} eid={eid} "
                    f"row={bad_row - base}")
            if len(comp_rows):
                self.metrics.fault_compressed_pages += len(comp_rows)
            if bk.crc_enabled:
                self.metrics.crc_checks += len(data_rows)
            if crc_bad is not None:
                i, actual, want_i = crc_bad
                self.metrics.crc_failures += 1
                raise CorruptionError(
                    f"CRC mismatch gfn={gfn} mp={int(mps[i])}: "
                    f"{actual:#x} != {want_i:#x}")
        finally:
            self._staging.give(staging, in_flight)

        # consume the entries (single pass per shard)
        for shard, shard_rows in by_shard.items():
            with self._locks[shard]:
                for i in shard_rows:
                    self._compressed.pop((gfn, int(mps[i])), None)
        for eid, pairs in by_ext.items():
            self._ext_release(gfn, eid, len(pairs))
        if len(disk_rows):
            with self._disk_lock:
                for i in disk_rows:
                    self._disk_offsets.pop((gfn, int(mps[i])), None)
        self.metrics.backend_batch_loads += 1
        # per-tier modeled service delay (data, not measurement): the
        # declared TIER_READ_LAT_NS figures accrue per row so placement
        # policies compare on modeled time regardless of host speed
        self.modeled_load_ns += (
            len(zero_rows) * TIER_READ_LAT_NS[K_ZERO]
            + len(comp_rows) * TIER_READ_LAT_NS[K_COMPRESSED]
            + len(disk_rows) * TIER_READ_LAT_NS[K_DISK])

    def write_rows(self, pool: torch.Tensor, idx: np.ndarray,
                   rows: np.ndarray) -> None:
        """``pool[idx[i]] = rows[i]`` from host rows (already verified):
        one upload from a reused staging pair, one plain scatter with the
        indices by value, and no host wait -- the pair is handed out again
        only once its upload has run."""
        k, n = rows.shape
        staging = self._staging.take(k * n)
        try:
            staging[0].numpy()[:k * n].reshape(k, n)[:] = rows
            ops.scatter_staged_rows_(pool, staging[0], staging[1], k, idx,
                                     verify=False)
        finally:
            self._staging.give(staging, pool.device.type != "cpu")

    # ------------------------------------------------------------- accounting
    def stored_bytes(self) -> int:
        # lock stripes guard per-key mutation; summing a point-in-time
        # snapshot of the values only needs the GIL
        standalone = sum(len(e[1]) for e in list(self._compressed.values())
                         if e[0] != "x")
        extents = sum(e.stored_len for e in list(self._extents.values()))
        return standalone + extents

    def stats(self) -> Dict[str, int]:
        """Point-in-time operational counters: decoded-extent LRU
        hit/miss and the remote-peer tier's held
        replicas and modeled latency totals."""
        with self._ext_lock:
            ext_entries = len(self._ext_cache)
        with self._remote_lock:
            remote_held = len(self._remote)
            remote_bytes = self.remote_held_bytes
        return {
            "ext_cache_hits": self.ext_cache_hits,
            "ext_cache_misses": self.ext_cache_misses,
            "ext_cache_entries": ext_entries,
            "remote_puts": self.remote_puts,
            "remote_gets": self.remote_gets,
            "remote_drops": self.remote_drops,
            "remote_held": remote_held,
            "remote_held_bytes": remote_bytes,
            "remote_modeled_ns": self.remote_modeled_ns,
            "modeled_load_ns": self.modeled_load_ns,
        }

    def set_free_page_probe(self, probe) -> None:
        self._free_page_probe = probe

    def close(self) -> None:
        with self._ext_lock:
            self._ext_cache.clear()
        with self._remote_lock:
            self._remote.clear()
            self.remote_held_bytes = 0
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._disk_file is not None:
            path = self._disk_file.name
            self._disk_file.close()
            if os.path.exists(path):
                os.unlink(path)
