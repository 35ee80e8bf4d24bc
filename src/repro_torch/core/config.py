"""Configuration for the Taiji elastic-memory core.

Mirrors the paper's deployed configuration by default:
  * MS ("memory section") = 2 MiB huge page, MP ("memory page") = 4 KiB,
    i.e. 512 MPs per MS (paper §4.2.2).
  * 32 GB physical + 16 GB virtual elastic memory = +50% elasticity
    (paper §5.3.2) -- expressed here as a ratio so tests can scale down.
  * high/low/min watermarks (paper §4.2.2, Fig 14e).
  * scheduler shares for FRONT/FCPU/BACK/IDLE (paper §4.3, Fig 9).

Everything is a plain dataclass: configs are hashable/serializable and carry
an ABI version so hot-upgrade can verify compatibility (paper §4.4 "Data
Plane Compatibility").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ABI_VERSION = 1


@dataclasses.dataclass(frozen=True)
class LRUConfig:
    """Multi-level hot/cold set parameters (paper §4.2.1, Fig 7)."""

    scan_interval_s: float = 0.050      # periodic scan cadence per worker
    levels: int = 6                     # HOT, HOT_INT, ACTIVE, INACTIVE, COLD_INT, COLD
    # number of consecutive unchanged scans before a page moves one level
    # toward the hot or cold end ("time-based stabilization", §4.2.1)
    stabilize_scans: int = 2
    scan_cache_size: int = 256          # per-worker scan cache (reduces lock contention)
    workers: int = 2                    # parallel LRU tasks (per-PCPU in the paper)


@dataclasses.dataclass(frozen=True)
class WatermarkConfig:
    """Free-memory watermarks in MS units as fractions of physical MSs."""

    high: float = 0.20   # stop reclaim above this much free memory
    low: float = 0.10    # start background reclaim below this
    min: float = 0.03    # critically low: reclaim synchronously on the fault path
    # optional policy knobs (§4.2.2: "Policies can be tuned")
    reclaim_batch: int = 8          # MSs per background reclaim round
    eager_below_high: bool = False  # start reclaim below *high* to pre-arm for bursts


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """hv_sched static shares + dynamic adjustment (paper §4.3)."""

    cycle_ms: float = 10.0
    # static proportional shares per priority class, must sum to <= 1.0
    share_front: float = 0.70
    share_fcpu: float = 0.05
    share_back: float = 0.20
    share_idle: float = 0.05
    # dynamic adjustment: penalty factor applied to a task's slice after it
    # overruns its quantum, and the number of cycles the penalty persists
    overrun_penalty: float = 0.5
    penalty_cycles: int = 3
    shards: int = 2                 # number of scheduler shards (PCPUs/CPs)
    # adaptive idle backoff: a shard whose cycle spends (almost) none of
    # its budget -- empty LRU slices, watermark satisfied -- doubles its
    # sleep up to ``idle_backoff_max`` cycles, then snaps back to 1 the
    # moment a cycle does real work. This is hv_sched's "unused slices
    # flow to FRONT" taken to its wall-clock conclusion: an idle manager
    # must not steal GIL/CPU slices from the foreground decode step
    # (paper Fig 11: benchmarks within 3% of native). Reclaim reaction
    # worst-case grows to idle_backoff_max * cycle_ms, still far inside
    # the high->low watermark gap; the critical path (min watermark)
    # reclaims synchronously and never waits on a BACK wakeup.
    idle_backoff_max: float = 16.0
    # a cycle counts as idle when its tasks spent under this fraction of
    # the cycle actually running
    idle_spent_frac: float = 0.05


@dataclasses.dataclass(frozen=True)
class HotPathConfig:
    """The unified hot-path surface: every knob that decides
    how a guest access or swap batch is serviced, in one documented
    place.

    * ``fast_fault`` -- zero-page ultrafast fault path: resolve a
      zero-kind fault through the O(1) fault-descriptor table under the
      req's short MP mutex only (no read-write lock round trip, no
      condition-variable wait, constant-CRC compare). The locked scalar
      path is kept as the A/B semantic reference.
    * ``readahead`` -- extent readahead: the first fault into a
      compressed extent decompresses the whole extent anyway, so
      materialize *all* its still-swapped sibling MPs into the resident
      MS in one pass; N future faults become zero faults and the
      decompress cost is paid exactly once (paper §3.3/Fig 8 parallel
      swapping, amortized).
    * ``pallas_kernels`` -- kept so this config stays field-for-field
      the reference's (configs and pickles carry the same fields), but
      the port's data path never reads it. The frames' device decides:
      on a CUDA device the four swap kernels in
      ``repro_torch.kernels`` (zero-detect scan, Fletcher extent tags,
      gather/scatter swap copies) always run; on the CPU their plain
      PyTorch versions always run. The per-MP CRC stored in MS records
      is zlib.crc32 over host bytes either way (records stay
      byte-compatible with the reference's, hot-upgrade ABI §4.4); the
      Fletcher checksum is the device-side integrity tag computed per
      extent row. Lossless compression remains host zlib.
    * ``compress_workers`` -- fan ``store_batch``/``load_batch`` extent
      (de)compression across a worker pool. zlib releases the GIL, so
      extents compress in parallel; results merge in submission order,
      making the stored bytes identical for ANY worker count (pinned by
      tests/test_hotpath_batch.py). ``<= 1`` keeps the serial path.
    * ``slot_shards`` / ``magazine_size`` -- contention-free first-in
      slot allocation: ``PhysicalMemory``'s free-slot list is
      sharded into ``slot_shards`` per-shard freelists fronted by
      per-thread *magazines* of up to ``magazine_size`` cached slots. A
      faulting thread refills its magazine under ONE shard lock and then
      serves first-in allocations lock-free; frees return to the slot's
      home shard. ``magazine_size <= 0`` keeps the legacy single-list
      path (one global lock), the A/B reference. The default batch is
      sized so refill amortization keeps the *uncontended* path within
      ~10% of the legacy single-lock pop: refills are lazy --
      paid only when a magazine runs dry -- so a bigger batch means
      strictly fewer lock acquires on both the single- and multi-thread
      paths.
    * ``extent_cache_entries`` -- bounded decoded-extent LRU in
      ``BackendStore``: decompressed extent payloads are kept in an LRU
      of this many entries (verified against the stored whole-extent CRC
      on insert, invalidated when the extent is dropped/consumed) so
      sibling-MP faults and readahead hitting a cached extent skip zlib
      entirely while decoded retention stays bounded. ``0`` keeps the
      legacy decompress-in-place behavior (unbounded per-live-extent raw
      caching).
    """

    fast_fault: bool = True      # O(1)-descriptor zero-page fast path
    readahead: bool = True       # materialize whole extents on first fault
    pallas_kernels: bool = False # device kernels for the batched data path
    compress_workers: int = 4    # parallel extent (de)compression pool
    slot_shards: int = 4         # per-shard free-slot freelists
    magazine_size: int = 16      # per-thread slot magazine (0 = legacy list)
    extent_cache_entries: int = 8  # decoded-extent LRU (0 = legacy in-place)
    # remote-peer swap tier: number of peer replicas the fleet
    # controller maintains for each fully swapped-out MS. ``0`` disables
    # the tier (single-box TaijiSystem behavior is ALWAYS unaffected --
    # replication is controller-driven, the local swap path never blocks
    # on a peer). ``1`` is the deployed setting; >1 is reserved.
    remote_tier: int = 1

    @classmethod
    def legacy_scalar(cls) -> "HotPathConfig":
        """The pre-batching scalar reference profile: locked faults, no
        readahead, host numpy/zlib, serial compression, single-list slot
        allocation, in-place extent decode, no remote-peer tier. The A/B
        baseline benchmarks and semantic-equivalence tests measure
        against."""
        return cls(fast_fault=False, readahead=False,
                   pallas_kernels=False, compress_workers=0,
                   slot_shards=1, magazine_size=0, extent_cache_entries=0,
                   remote_tier=0)


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    """Batched swap data-path knobs (paper §4.2.2 "parallel swapping").

    The engine moves MPs in batches of ``batch_mps`` index-vector chunks
    derived from the ``bm_in``/``bm_out`` bitmaps; cancellation (Fig 8
    (2.2)) is honoured between chunks, so ``batch_mps`` bounds how long a
    racing fault waits on an active writer. ``batch_mps <= 0`` disables
    batching entirely (scalar per-MP path, kept for A/B benchmarks).

    Fault/data-path servicing knobs live in :class:`HotPathConfig`
    (``hot_path``). The historical scalar field names
    (``fast_fault_enabled`` / ``readahead_enabled`` /
    ``use_pallas_kernels``) are kept as aliases: passing them to the
    constructor populates ``hot_path``, reading them reflects
    ``hot_path``, and configs pickled before ``hot_path`` existed
    unpickle with an equivalent one synthesized (``__setstate__``).
    When both ``hot_path`` and a legacy flag are passed explicitly, the
    legacy flag wins (this is what ``dataclasses.replace(cfg.swap,
    fast_fault_enabled=...)`` produces).
    """

    batch_enabled: bool = True
    batch_mps: int = 64              # MPs per backend bulk call / cancel point
    hot_path: Optional[HotPathConfig] = None
    # legacy aliases -- resolved into hot_path by __post_init__
    fast_fault_enabled: Optional[bool] = None
    readahead_enabled: Optional[bool] = None
    use_pallas_kernels: Optional[bool] = None

    def __post_init__(self) -> None:
        hp = self.hot_path if self.hot_path is not None else HotPathConfig()
        overrides = {}
        if self.fast_fault_enabled is not None \
                and bool(self.fast_fault_enabled) != hp.fast_fault:
            overrides["fast_fault"] = bool(self.fast_fault_enabled)
        if self.readahead_enabled is not None \
                and bool(self.readahead_enabled) != hp.readahead:
            overrides["readahead"] = bool(self.readahead_enabled)
        if self.use_pallas_kernels is not None \
                and bool(self.use_pallas_kernels) != hp.pallas_kernels:
            overrides["pallas_kernels"] = bool(self.use_pallas_kernels)
        if overrides:
            hp = dataclasses.replace(hp, **overrides)
        # aliases always mirror hot_path so old readers see one truth
        object.__setattr__(self, "hot_path", hp)
        object.__setattr__(self, "fast_fault_enabled", hp.fast_fault)
        object.__setattr__(self, "readahead_enabled", hp.readahead)
        object.__setattr__(self, "use_pallas_kernels", hp.pallas_kernels)

    def __setstate__(self, state) -> None:
        # configs pickled before hot_path existed restore a plain field
        # dict; synthesize the HotPathConfig from the legacy scalars so
        # old pickles keep working (hot-upgrade ABI promise)
        if isinstance(state, tuple):          # (dict, slots) pickle form
            merged = {}
            for part in state:
                if part:
                    merged.update(part)
            state = merged
        state = dict(state)
        if state.get("hot_path") is None:
            state["hot_path"] = HotPathConfig(
                fast_fault=bool(state.get("fast_fault_enabled", True)),
                readahead=bool(state.get("readahead_enabled", True)),
                pallas_kernels=bool(state.get("use_pallas_kernels", False)))
        hp = state["hot_path"]
        if not hasattr(hp, "slot_shards"):
            # HotPathConfig pickled before the allocator fields existed:
            # rebuild so the allocator/cache knobs get their defaults
            hp = HotPathConfig(
                fast_fault=hp.fast_fault, readahead=hp.readahead,
                pallas_kernels=hp.pallas_kernels,
                compress_workers=hp.compress_workers)
            state["hot_path"] = hp
        elif not hasattr(hp, "remote_tier"):
            # pickled before the remote tier existed: rebuild so
            # the new knob gets its default
            hp = HotPathConfig(
                fast_fault=hp.fast_fault, readahead=hp.readahead,
                pallas_kernels=hp.pallas_kernels,
                compress_workers=hp.compress_workers,
                slot_shards=hp.slot_shards,
                magazine_size=hp.magazine_size,
                extent_cache_entries=hp.extent_cache_entries)
            state["hot_path"] = hp
        state["fast_fault_enabled"] = hp.fast_fault
        state["readahead_enabled"] = hp.readahead
        state["use_pallas_kernels"] = hp.pallas_kernels
        state.setdefault("batch_enabled", True)
        state.setdefault("batch_mps", 64)
        for key, value in state.items():
            object.__setattr__(self, key, value)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Swap backend stores (paper §4.2.2 backend + §7.2)."""

    zero_page_enabled: bool = True
    compression_enabled: bool = True
    compression_level: int = 1       # zlib level; level 1 ~ lz4-class latency
    # §7.2: free-page detection disabled in production (zone-lock overhead)
    free_page_enabled: bool = False
    # optional fallback tiers; "remote memory and disks act as fallback"
    disk_fallback_path: str | None = None
    crc_enabled: bool = True         # §7.1 CRC to guarantee correctness
    # per-kind/per-shard lock split for the in-memory tiers (Palladium-style
    # sharding of per-tenant state); keys hash by (gfn, mp) across shards
    lock_shards: int = 8
    # cap on rows per batch extent: bounds the worst-case passive-fault
    # latency (first fault into an extent decompresses the whole stream)
    # at a small cost in cross-row compression and per-call amortization
    extent_max_rows: int = 16


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability: stage-attributed span tracing (``repro_torch.obs``).

    Off by default: with ``enabled=False`` no ``SpanTracer`` is
    constructed and every instrumented call site costs exactly one
    ``is not None`` branch (the GuestSpace empty-observer discipline).
    ``enabled=True`` builds the system's tracer: spans per stage, the
    per-stage counts and bytes of copies across PCIe, and -- while
    ``torch.profiler`` records -- a ``taiji::<stage>`` host range in the
    profiler's timeline for each span of a mirrored stage. Spans and
    copy counts are wall-clock telemetry only -- they never enter
    ``deterministic_snapshot``, so capture/replay and chaos determinism
    are identical with tracing on or off.
    """

    enabled: bool = False
    ring_capacity: int = 4096     # encoded spans buffered between flushes
    max_spans: int = 200_000      # retained decoded spans (Chrome export)


@dataclasses.dataclass(frozen=True)
class TaijiConfig:
    """Top-level configuration of the elastic-memory system."""

    # geometry -- defaults mirror the paper (2 MiB MS / 4 KiB MP); tests and
    # the KV-cache integration scale these down/up per use case.
    ms_bytes: int = 2 * 1024 * 1024
    mps_per_ms: int = 512
    n_phys_ms: int = 64              # physical capacity in MSs
    overcommit_ratio: float = 0.50   # +50% virtual elastic memory (paper O3)

    mpool_reserve_ms: int = 4        # pinned metadata arena, in MSs (paper: 400 MB)

    lru: LRUConfig = dataclasses.field(default_factory=LRUConfig)
    watermark: WatermarkConfig = dataclasses.field(default_factory=WatermarkConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    swap: SwapConfig = dataclasses.field(default_factory=SwapConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)

    abi_version: int = ABI_VERSION
    # reserved fields for forward-compatible hot upgrades (paper §4.4)
    _reserved: Tuple[int, ...] = (0, 0, 0, 0)

    @property
    def mp_bytes(self) -> int:
        return self.ms_bytes // self.mps_per_ms

    @property
    def n_virt_ms(self) -> int:
        """Total virtual MSs visible to the guest (physical + elastic)."""
        return int(round(self.n_phys_ms * (1.0 + self.overcommit_ratio)))

    @property
    def n_elastic_ms(self) -> int:
        return self.n_virt_ms - self.n_phys_ms

    def validate(self) -> None:
        if self.ms_bytes % self.mps_per_ms:
            raise ValueError("ms_bytes must be divisible by mps_per_ms")
        if self.mp_bytes % 8:
            raise ValueError("mp_bytes must be a multiple of 8")
        if self.n_phys_ms <= self.mpool_reserve_ms:
            raise ValueError("physical memory must exceed the mpool reserve")
        wm = self.watermark
        if not (0.0 <= wm.min <= wm.low <= wm.high < 1.0):
            raise ValueError("watermarks must satisfy 0 <= min <= low <= high < 1")
        sc = self.scheduler
        total = sc.share_front + sc.share_fcpu + sc.share_back + sc.share_idle
        if total > 1.0 + 1e-9:
            raise ValueError("scheduler shares must sum to <= 1.0")
        if self.backend.lock_shards < 1:
            raise ValueError("backend.lock_shards must be >= 1")
        hp = self.swap.hot_path
        if hp is not None:
            if getattr(hp, "slot_shards", 1) < 1:
                raise ValueError("hot_path.slot_shards must be >= 1")
            if getattr(hp, "magazine_size", 0) < 0:
                raise ValueError("hot_path.magazine_size must be >= 0")
            if getattr(hp, "extent_cache_entries", 0) < 0:
                raise ValueError("hot_path.extent_cache_entries must be >= 0")
            if not 0 <= getattr(hp, "remote_tier", 0) <= 1:
                raise ValueError("hot_path.remote_tier must be 0 or 1")
        if self.obs.ring_capacity < 1 or self.obs.max_spans < 0:
            raise ValueError("obs ring_capacity must be >= 1, max_spans >= 0")


def small_test_config(**overrides) -> TaijiConfig:
    """A reduced configuration for fast unit tests."""
    base = dict(
        ms_bytes=16 * 1024,
        mps_per_ms=8,
        n_phys_ms=24,
        overcommit_ratio=0.5,
        mpool_reserve_ms=2,
        lru=LRUConfig(scan_interval_s=0.002, workers=2, stabilize_scans=1,
                      scan_cache_size=32),
        scheduler=SchedulerConfig(cycle_ms=2.0, shards=2),
    )
    base.update(overrides)
    cfg = TaijiConfig(**base)
    cfg.validate()
    return cfg


def size_mpool_reserve(ms_bytes: int, mps: int, n_phys: int,
                       overcommit: float) -> int:
    """MSs of pinned metadata arena for ``n_phys`` managed MSs: the
    virtual space's records and table words with 2x headroom (the paper
    reserves 400 MB and reports <50% average utilization). The same
    sizing as the reference's ``elastic_kv._mpool_reserve_ms``."""
    n_virt = int(round((n_phys) * (1.0 + overcommit))) + 2
    per_gfn = (192 + 6 * mps) + 16          # MS record slab + table words
    need = 2 * (n_virt * per_gfn + 4 * ms_bytes)
    return max(2, -(-need // ms_bytes))
