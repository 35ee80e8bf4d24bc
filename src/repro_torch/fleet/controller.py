"""FleetController -- multi-node elasticity orchestration (control plane).

CLUES-style cluster orchestration adapted to memory elasticity: the
controller owns fleet-wide *admission control* for elastic MS
allocations, *pressure-aware placement* onto the least-pressured serving
node, *staggered reclaim* coordination (nodes are partitioned into
stagger groups; only one group's BACK reclaim fires per fleet tick, so
the whole fleet never compresses/swaps in the same window), and *rolling
hot-upgrade* orchestration with failure-domain batching and
abort-on-regression, *failure recovery* (a dead node's committed MSs are
re-placed onto survivors under admission control on the next tick), and
*live MS migration* between nodes (export -> admit + import ->
read-verify -> drop, preserving the resident/swapped split).

Concurrency model: one deterministic event loop. ``tick()`` is a fleet
round that steps every node once; nothing runs on threads, so replaying
a seeded trace is exactly reproducible (see ``trace.TraceReplayer``).

Port: a copy of ``repro/fleet/controller.py``. Migration and the
remote-peer tier move the numpy MS image that the port's
``TaijiSystem.export_ms`` returns (one device-to-host copy of the frame)
and ``import_ms`` uploads, so nodes on one device or on different ones
exchange the same bytes.
"""
from __future__ import annotations

import dataclasses
import json
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from ..core.hotupgrade import EngineModule
from ..core.metrics import LatencyHistogram
from ..obs.tracer import (ST_FLEET_ADMISSION, ST_FLEET_PLACEMENT,
                          ST_FLEET_RECOVERY, ST_FLEET_STEP, ST_FLEET_TICK,
                          ST_FLEET_UPGRADE)
from .node import NodeAgent

_perf_ns = time.perf_counter_ns

REJECT_OVERCOMMIT = "fleet_overcommit"
REJECT_NO_CAPACITY = "no_serving_capacity"

# migration rejection reasons: all checked *before* any mutation, so a
# rejected migration leaves both nodes untouched
REJECT_MIGRATE_BAD_SRC = "migrate_bad_src"
REJECT_MIGRATE_NO_DST = "migrate_no_dst"
REJECT_MIGRATE_VERIFY = "migrate_verify_failed"

# remap_listener(src_node, old_gfn, dst_node | None, new_gfn | None,
#                data_preserved): how the trace replayer tracks tokens
# across migrations (preserved) and failure re-placements (fresh MS)
RemapListener = Callable[[NodeAgent, int, Optional[NodeAgent],
                          Optional[int], bool], None]


# ------------------------------------------------ remote-tier MS images
# A replica blob is the owner's full export image (guest-visible rows +
# resident/swapped split) compressed as one zlib stream, so the peer can
# hold -- and hand back -- bytes it cannot interpret, and a recovered MS
# re-lands with the elasticity state it left with.
def _encode_ms_image(rows: np.ndarray,
                     resident: np.ndarray) -> Tuple[bytes, int]:
    raw = (np.asarray(resident, dtype=np.uint8).tobytes()
           + np.ascontiguousarray(rows, dtype=np.uint8).tobytes())
    blob = zlib.compress(raw, 1)
    # CRC covers the *stored* bytes: the peer's remote_get re-checksums
    # the blob as held, so rot anywhere between put and get is caught
    # without the peer having to understand (or decompress) the image
    return blob, zlib.crc32(blob)


def _decode_ms_image(blob: bytes, mps_per_ms: int,
                     mp_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
    raw = zlib.decompress(blob)
    resident = np.frombuffer(raw[:mps_per_ms], dtype=np.uint8).astype(bool)
    rows = np.frombuffer(raw[mps_per_ms:], dtype=np.uint8).reshape(
        mps_per_ms, mp_bytes)
    return rows, resident


def _remote_tier(node: NodeAgent) -> int:
    hp = getattr(node.cfg.swap, "hot_path", None)
    return int(getattr(hp, "remote_tier", 0) or 0)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Control-plane knobs (per-node knobs stay in TaijiConfig)."""

    # fleet-wide admission cap: committed virtual MSs may not exceed this
    # multiple of the fleet's managed physical MSs. Per-node overcommit is
    # +50% (paper O3); holding the *fleet* at +25% keeps aggregate reclaim
    # pressure bounded even when placement is skewed.
    overcommit_cap: float = 1.25
    # number of reclaim stagger groups: node i belongs to group
    # (i % groups); group (tick % groups) reclaims this tick.
    reclaim_stagger_groups: int = 2
    # rolling upgrade: rounds a node drains before its module swap
    upgrade_drain_rounds: int = 2
    # optional latency guard (abort-on-regression): if set, a batch whose
    # post-upgrade fleet p90 fault latency exceeds guard * the pre-upgrade
    # baseline aborts the rollout. Timing-dependent, so it is OFF by
    # default; the deterministic health probe always runs.
    latency_guard_factor: Optional[float] = None
    latency_guard_min_samples: int = 200

    @classmethod
    def production_profile(cls) -> "FleetConfig":
        """The named production rollout profile (ROADMAP wiring item).

        Wires the optional latency guard into abort-on-regression: a
        rollout batch whose post-upgrade fleet p90 fault latency exceeds
        1.5x the pre-rollout baseline aborts, judged only on a deep
        sample window (500 faults) so one noisy probe cannot kill a
        rollout.  Reclaim stagger widens to 4 groups and drains deepen --
        production trades rollout speed for blast-radius control.
        """
        return cls(overcommit_cap=1.25,
                   reclaim_stagger_groups=4,
                   upgrade_drain_rounds=3,
                   latency_guard_factor=1.5,
                   latency_guard_min_samples=500)


class _RollingUpgrade:
    def __init__(self, module_cls: Type[EngineModule],
                 batches: List[List[NodeAgent]], drain_rounds: int,
                 baseline_p90_ns: float) -> None:
        self.module_cls = module_cls
        self.batches = batches
        self.drain_rounds = drain_rounds
        self.baseline_p90_ns = baseline_p90_ns
        self.batch_idx = 0
        self.in_flight = False
        # fleet fault histogram at batch start: the latency guard judges
        # only the samples recorded *since*, so pre-upgrade history can't
        # dilute a regression. pre_batch_epoch snapshots (kills,
        # recoveries): a fleet-membership change between capture and
        # validation invalidates the delta (the dead node's samples are in
        # the pre hist but not the post), so the guard skips that batch.
        self.pre_batch_hist: Optional[LatencyHistogram] = None
        self.pre_batch_epoch: Tuple[int, int] = (0, 0)


def _hist_delta(post: LatencyHistogram,
                pre: LatencyHistogram) -> LatencyHistogram:
    """Samples recorded between two cumulative histogram states.

    Buckets/counters are additive so they subtract cleanly; the exact
    reservoir does not, so the delta keeps no samples and ``percentile``
    falls back to bucket math.
    """
    d = LatencyHistogram()
    d.buckets = [a - b for a, b in zip(post.buckets, pre.buckets)]
    d.count = post.count - pre.count
    d.total_ns = post.total_ns - pre.total_ns
    d.max_ns = post.max_ns
    return d


class FleetController:
    def __init__(self, nodes: Sequence[NodeAgent],
                 fleet_cfg: Optional[FleetConfig] = None) -> None:
        self.nodes = list(nodes)
        if not self.nodes:
            raise ValueError("fleet needs at least one node")
        self.cfg = fleet_cfg or FleetConfig()
        if self.cfg.reclaim_stagger_groups < 1:
            raise ValueError("reclaim_stagger_groups must be >= 1")
        self.ticks = 0
        # admission counters
        self.admitted = 0
        self.rejections: Dict[str, int] = {REJECT_OVERCOMMIT: 0,
                                           REJECT_NO_CAPACITY: 0}
        self.placements: Dict[int, int] = {n.node_id: 0 for n in self.nodes}
        self.reclaimed_mps = 0
        # chaos + migration counters
        self.kills = 0
        self.recoveries = 0
        self.migrations = 0
        self.migration_mps = 0
        self.migrations_rejected: Dict[str, int] = {
            REJECT_MIGRATE_BAD_SRC: 0, REJECT_MIGRATE_NO_DST: 0,
            REJECT_MIGRATE_VERIFY: 0}
        self.ms_replaced = 0             # re-placed after a hard kill (fresh)
        self.ms_lost = 0                 # died with the node, no capacity
        self.remap_listener: Optional[RemapListener] = None
        # remote-peer swap tier: controller-brokered leases.
        # (owner_id, gfn) -> (peer_id, peer_epoch): the peer holds a
        # replica of the owner's fully-swapped MS in its BackendStore;
        # peer_epoch (= peer.recoveries at grant) invalidates leases that
        # survive a peer's death + rebirth, whose replica bytes did not.
        self.leases: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # drain-kill leftovers whose only surviving copy is their replica:
        # these recover preserved or count lost -- never fresh-replaced
        self._drain_pending: set = set()
        self.remote_puts = 0             # replicas placed (lease grants)
        self.remote_recovered = 0        # dead-owner MSs rebuilt from peers
        self.remote_rereplicated = 0     # replicas re-placed off a dead peer
        self.remote_dropped = 0          # leases broken (write/free/loss)
        self.remote_evicted = 0          # peer hit its watermark: evict back
        for n in self.nodes:
            n._lease_break = self._on_lease_break
        # rolling upgrade state
        self._rolling: Optional[_RollingUpgrade] = None
        self.upgrade_batches_done = 0
        self.upgrade_aborted = False
        self.upgrade_abort_reason = ""
        # stage-attributed tracing (repro_torch.obs): the controller gets its
        # own tracer when the fleet is traced, on a pid track one past the
        # node ids; None when any node runs untraced
        self.tracer = None
        if all(n.system.metrics.tracer is not None for n in self.nodes):
            from ..obs.tracer import SpanTracer
            obs = self.nodes[0].cfg.obs
            self.tracer = SpanTracer(cap=obs.ring_capacity,
                                     max_spans=obs.max_spans,
                                     pid=len(self.nodes))

    # ---------------------------------------------------------- fleet sums
    # dead nodes are out of the fleet: their physical MSs back nothing and
    # their committed MSs are in-flight to survivors (failure recovery)
    def fleet_managed_ms(self) -> int:
        return sum(n.managed_phys_ms for n in self.nodes if n.alive)

    def fleet_committed_ms(self) -> int:
        return sum(len(n.allocated) for n in self.nodes if n.alive)

    def fleet_free_ms(self) -> int:
        return sum(n.free_ms for n in self.nodes if n.alive)

    def node_by_id(self, node_id: int) -> NodeAgent:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        raise ValueError(f"unknown node id {node_id}")

    # ----------------------------------------------------------- admission
    def admit_alloc(self) -> Tuple[Optional[NodeAgent], Optional[int], str]:
        """Admission control + placement for one elastic MS allocation.

        Returns ``(node, gfn, "ok")`` on success, else
        ``(None, None, reason)``. Placement is pressure-aware: the
        least-pressured serving node with virtual headroom wins (node_id
        breaks ties deterministically).
        """
        tr = self.tracer
        if tr is not None:
            t0 = _perf_ns()
        cap = int(self.fleet_managed_ms() * self.cfg.overcommit_cap)
        if self.fleet_committed_ms() + 1 > cap:
            self.rejections[REJECT_OVERCOMMIT] += 1
            if tr is not None:
                tr.push(ST_FLEET_ADMISSION, t0, _perf_ns() - t0, 1)
            return None, None, REJECT_OVERCOMMIT
        if tr is not None:
            t_p = _perf_ns()
        node = self._pick_target()
        if tr is not None:
            tr.push(ST_FLEET_PLACEMENT, t_p, _perf_ns() - t_p)
        if node is None:
            self.rejections[REJECT_NO_CAPACITY] += 1
            if tr is not None:
                tr.push(ST_FLEET_ADMISSION, t0, _perf_ns() - t0, 1)
            return None, None, REJECT_NO_CAPACITY
        gfn = node.alloc_ms()
        self.admitted += 1
        self.placements[node.node_id] += 1
        if tr is not None:
            tr.push(ST_FLEET_ADMISSION, t0, _perf_ns() - t0)
        return node, gfn, "ok"

    def _pick_target(self,
                     exclude: Optional[NodeAgent] = None
                     ) -> Optional[NodeAgent]:
        """The one placement policy, shared by admission and migration:
        least-pressured serving node with virtual headroom (node_id
        breaks ties deterministically), optionally excluding a node."""
        candidates = [n for n in self.nodes
                      if n is not exclude and n.serving
                      and len(n.allocated) < n.capacity_ms]
        if not candidates:
            return None
        return min(candidates, key=lambda n: (n.pressure(), n.node_id))

    # --------------------------------------------------------- fleet round
    def reclaim_group_of(self, node_index: int) -> int:
        return node_index % self.cfg.reclaim_stagger_groups

    def tick(self) -> int:
        """One fleet round: detect dead nodes (failure recovery), step
        every surviving node, stagger reclaim windows, drive any in-flight
        rolling upgrade. Returns MPs reclaimed."""
        tr = self.tracer
        if tr is not None:
            t0 = _perf_ns()
        for node in self.nodes:
            if not node.alive and node.allocated:
                if tr is not None:
                    t_r = _perf_ns()
                self._replace_dead_ms(node)
                if tr is not None:
                    tr.push(ST_FLEET_RECOVERY, t_r, _perf_ns() - t_r)
        # settle leases whose *peer* died (or was reborn): re-replicate
        # from the still-alive owner, exactly once per lease
        if self.leases:
            self._settle_dead_peers()
        groups = self.cfg.reclaim_stagger_groups
        active_group = self.ticks % groups
        reclaimed = 0
        if tr is not None:
            t_s = _perf_ns()
        for i, node in enumerate(self.nodes):
            if not node.alive:
                continue
            window = node.serving and self.reclaim_group_of(i) == active_group
            reclaimed += node.step(reclaim=window)
        self.reclaimed_mps += reclaimed
        if tr is not None:
            t_u = _perf_ns()
            tr.push(ST_FLEET_STEP, t_s, t_u - t_s)
        self._drive_rolling()
        # remote-peer tier passes run after stepping: reclaim is what
        # creates the fully-swapped population worth replicating
        self._replicate_pass()
        self._evict_pass()
        self.ticks += 1
        if tr is not None:
            tr.push(ST_FLEET_UPGRADE, t_u, _perf_ns() - t_u)
            tr.push(ST_FLEET_TICK, t0, _perf_ns() - t0)
        return reclaimed

    # ---------------------------------------------------- failure injection
    def kill_node(self, node_id: int, *, drain: bool = False) -> None:
        """Deterministic failure injection: kill one NodeAgent.

        ``drain=True`` is a graceful decommission: committed MSs are
        live-migrated to survivors first (guest-visible bytes preserved);
        whatever cannot be placed dies with the node. ``drain=False`` is
        a hard crash -- contents are lost, and the next :meth:`tick`
        detects the dead node and re-places its committed MSs as fresh
        allocations under normal admission control. Idempotent.
        """
        node = self.node_by_id(node_id)
        if not node.alive:
            return
        if drain:
            for gfn in sorted(node.allocated):
                self.migrate_ms(node, gfn)
            # whatever could not be placed dies with the node -- counted
            # lost, NOT re-placed as a fresh MS (a silent zeroed
            # replacement would mislabel data loss as recovery). Final
            # for *unleased* MSs: their only data source disappears at
            # the kill point, so there is nothing to retry when capacity
            # returns. A leased MS is different: its replica
            # outlives the node, so it stays pending on the dead
            # identity and every tick retries lease-driven recovery --
            # the exact scenario the remote tier exists for.
            pending: List[int] = []
            for gfn in sorted(node.allocated):
                if (node.node_id, gfn) in self.leases:
                    pending.append(gfn)
                    self._drain_pending.add((node.node_id, gfn))
                    continue
                self.ms_lost += 1
                if self.remap_listener is not None:
                    self.remap_listener(node, gfn, None, None, False)
            node.allocated.clear()
            node.allocated.update(pending)
        node.kill()
        self.kills += 1

    def recover_node(self, node_id: int) -> None:
        """Bring a killed node back (fresh, empty, serving). If the node
        was never ticked over while dead, its committed MSs are settled
        (re-placed or lost) before the identity is reused. Idempotent."""
        node = self.node_by_id(node_id)
        if node.alive:
            return
        if node.allocated:
            # the identity is being reused: pending MSs settle for good
            self._replace_dead_ms(node, final=True)
        node.recover()
        self.recoveries += 1

    def _replace_dead_ms(self, node: NodeAgent, *, final: bool = False) -> None:
        """Re-place a dead node's committed MSs onto survivors.

        The contents died with the node: each MS re-enters through the
        normal admission path as a fresh (zeroed) allocation. A placement
        shortage can be *transient* -- e.g. candidates draining
        mid-upgrade, or headroom that frees up when another node recovers
        -- so unplaced MSs stay pending on the dead node and every tick
        retries them; only a ``final`` settlement (the node's identity is
        being reused by :meth:`recover_node`) counts them lost. The remap
        listener (the trace replayer) is told about both outcomes so
        token maps and the read-verify written-set stay deterministic.
        """
        remaining: List[int] = []
        for gfn in sorted(node.allocated):
            # remote-peer tier first: a valid lease means a live
            # peer holds this MS's full content -- recover it *preserved*
            # instead of re-placing a fresh zeroed MS. Placement bypasses
            # the overcommit admission counter exactly like live
            # migration does (the MS is already committed; this is the
            # same data changing hosts, not a new allocation).
            key = (node.node_id, gfn)
            outcome = self._recover_from_lease(node, gfn)
            if outcome == "recovered":
                self._drain_pending.discard(key)
                continue
            if outcome == "retry" and not final:
                remaining.append(gfn)    # lease valid, no capacity yet
                continue
            if key in self._drain_pending:
                # drain leftover: its bytes only survived on the replica.
                # With the lease unusable (or the settlement final), it
                # is honestly lost -- a fresh zeroed replacement would
                # mislabel data loss as recovery.
                self._drain_pending.discard(key)
                if self._drop_lease(node.node_id, gfn):
                    self.remote_dropped += 1
                self.ms_lost += 1
                if self.remap_listener is not None:
                    self.remap_listener(node, gfn, None, None, False)
                continue
            dst, new_gfn, _reason = self.admit_alloc()
            if dst is None:
                if final:
                    if self._drop_lease(node.node_id, gfn):
                        self.remote_dropped += 1
                    self.ms_lost += 1
                    if self.remap_listener is not None:
                        self.remap_listener(node, gfn, None, None, False)
                else:
                    remaining.append(gfn)
                continue
            if self._drop_lease(node.node_id, gfn):
                self.remote_dropped += 1
            self.ms_replaced += 1
            if self.remap_listener is not None:
                self.remap_listener(node, gfn, dst, new_gfn, False)
        node.allocated.clear()
        node.allocated.update(remaining)

    # ------------------------------------------------- remote-peer tier
    # Zero -> compressed -> remote-peer: each serving node with
    # ``hot_path.remote_tier > 0`` gets its fully-swapped MSs replicated
    # onto the least-pressured peer under a controller-brokered lease.
    # The lease registry is the single source of truth; nodes carry only
    # a mirror set (``leased_gfns``) so their write path can break a
    # lease in O(1). Every lease settles exactly once: recovery, owner
    # write/free, peer death (re-replicate or drop), or peer watermark
    # eviction.
    def _replicate_pass(self) -> None:
        """Place replicas for every unleased fully-swapped MS of every
        remote-tier-enabled serving owner. Runs once per tick, after the
        step loop (reclaim is what creates the fully-swapped population)."""
        for owner in self.nodes:
            if not owner.serving or _remote_tier(owner) <= 0:
                continue
            engine = owner.system.engine
            for gfn in sorted(owner.allocated):
                if (owner.node_id, gfn) in self.leases:
                    continue
                if not engine.ms_fully_swapped(gfn):
                    continue
                self._replicate_one(owner, gfn)

    def _replicate_one(self, owner: NodeAgent, gfn: int) -> bool:
        """Export one fully-swapped MS and lease its replica to a peer.

        Peer choice is the shared pressure-aware placement policy
        (:meth:`_pick_target`); a peer already in its critical watermark
        zone is refused -- replicating onto a node in fault-path reclaim
        would trade durability for latency where it hurts most.
        """
        peer = self._pick_target(exclude=owner)
        if peer is None:
            return False
        if peer.system.watermark.zone(peer.free_ms) == "critical":
            return False
        rows, resident = owner.export_ms(gfn)
        blob, crc = _encode_ms_image(rows, resident)
        peer.system.backend.remote_put(owner.node_id, gfn, blob, crc)
        self.leases[(owner.node_id, gfn)] = (peer.node_id, peer.recoveries)
        owner.leased_gfns.add(gfn)
        self.remote_puts += 1
        return True

    def _drop_lease(self, owner_id: int, gfn: int) -> bool:
        """Remove one lease and its replica (if the peer still has it).
        Returns whether a lease existed; the caller attributes the drop
        to the right counter."""
        lease = self.leases.pop((owner_id, gfn), None)
        self.node_by_id(owner_id).leased_gfns.discard(gfn)
        if lease is None:
            return False
        peer = self.node_by_id(lease[0])
        if peer.alive and peer.recoveries == lease[1]:
            peer.system.backend.remote_drop(owner_id, gfn)
        return True

    def _on_lease_break(self, owner: NodeAgent, gfn: int) -> None:
        """Node write-path callback: the owner is about to mutate (or
        free) a leased MS, so the replica is stale the moment the op
        lands. Installed on every NodeAgent at controller construction."""
        if self._drop_lease(owner.node_id, gfn):
            self.remote_dropped += 1

    def _recover_from_lease(self, owner: NodeAgent, gfn: int) -> str:
        """Try to rebuild a dead owner's MS from its peer replica.

        Returns ``"recovered"`` (content-preserving import done),
        ``"retry"`` (lease valid but no placement capacity this tick --
        the replica outlives the owner, so waiting is safe), or
        ``"none"`` (no usable lease: fall through to the legacy
        fresh-replacement path).
        """
        key = (owner.node_id, gfn)
        lease = self.leases.get(key)
        if lease is None:
            return "none"
        peer = self.node_by_id(lease[0])
        if not peer.alive or peer.recoveries != lease[1]:
            del self.leases[key]         # replica died with the peer
            self.remote_dropped += 1
            return "none"
        blob = peer.system.backend.remote_get(owner.node_id, gfn)
        if blob is None:                 # missing or failed its CRC
            del self.leases[key]
            self.remote_dropped += 1
            return "none"
        dst = self._pick_target()        # dead owner is not serving
        if dst is None:
            return "retry"
        rows, resident = _decode_ms_image(blob, owner.cfg.mps_per_ms,
                                          owner.cfg.mp_bytes)
        new_gfn = dst.import_ms(rows, resident)
        self._drop_lease(owner.node_id, gfn)
        self.remote_recovered += 1
        if self.remap_listener is not None:
            self.remap_listener(owner, gfn, dst, new_gfn, True)
        return "recovered"

    def _settle_dead_peers(self) -> None:
        """Settle every lease whose peer died or was reborn (stale
        epoch): re-replicate from the still-alive owner when the MS is
        still eligible, else drop. Exactly once per lease -- the lease
        leaves the registry before any counter moves."""
        for key in sorted(self.leases):
            peer_id, epoch = self.leases[key]
            peer = self.node_by_id(peer_id)
            if peer.alive and peer.recoveries == epoch:
                continue
            owner_id, gfn = key
            del self.leases[key]
            owner = self.node_by_id(owner_id)
            owner.leased_gfns.discard(gfn)
            if (owner.serving and gfn in owner.allocated
                    and owner.system.engine.ms_fully_swapped(gfn)
                    and self._replicate_one(owner, gfn)):
                self.remote_rereplicated += 1
            else:
                self.remote_dropped += 1

    def _evict_pass(self) -> None:
        """Release replicas held by peers that hit their critical
        watermark: the peer's own guests outrank replica hosting, and
        the owner still has the authoritative copy. The next replicate
        pass re-places the MS on a healthier peer if one exists. A dead
        owner's replica is exempt -- it is the *only* surviving copy, so
        the peer keeps carrying it until recovery settles the lease."""
        if not self.leases:
            return
        for key in sorted(self.leases):
            peer_id, epoch = self.leases[key]
            peer = self.node_by_id(peer_id)
            if not peer.alive or peer.recoveries != epoch:
                continue                 # _settle_dead_peers owns these
            if not self.node_by_id(key[0]).alive:
                continue                 # sole copy of a dead owner's MS
            if peer.system.watermark.zone(peer.free_ms) != "critical":
                continue
            peer.system.backend.remote_drop(key[0], key[1])
            del self.leases[key]
            self.node_by_id(key[0]).leased_gfns.discard(key[1])
            self.remote_evicted += 1

    # ------------------------------------------------------- live migration
    def migrate_ms(self, src: Union[NodeAgent, int], gfn: int,
                   dst: Optional[Union[NodeAgent, int]] = None, *,
                   verify: bool = True
                   ) -> Tuple[Optional[NodeAgent], Optional[int], str]:
        """Live MS migration: export on the source, admit + import on the
        destination, read-verify, then drop the source copy.

        Returns ``(dst_node, new_gfn, "ok")`` or ``(None, None, reason)``.
        With ``dst=None`` the least-pressured serving node (excluding the
        source) is chosen, admission-control style. All rejections happen
        before any mutation; a failed read-verify rolls the destination
        copy back and keeps the source authoritative. The resident/swapped
        split of the MS survives the move (import re-stores the swapped
        MPs through the batched store machinery).
        """
        if isinstance(src, int):
            src = self.node_by_id(src)
        if isinstance(dst, int):
            dst = self.node_by_id(dst)
        if not src.alive or gfn not in src.allocated:
            self.migrations_rejected[REJECT_MIGRATE_BAD_SRC] += 1
            return None, None, REJECT_MIGRATE_BAD_SRC
        if dst is None:
            dst = self._pick_target(exclude=src)
        elif (dst is src or not dst.serving
              or len(dst.allocated) >= dst.capacity_ms):
            dst = None
        if dst is None:
            self.migrations_rejected[REJECT_MIGRATE_NO_DST] += 1
            return None, None, REJECT_MIGRATE_NO_DST
        rows, resident = src.export_ms(gfn)      # non-consuming peek
        new_gfn = dst.import_ms(rows, resident)
        if verify:
            # read-verify without faulting: export the imported copy and
            # compare guest-visible bytes against the source image
            got, _res = dst.system.export_ms(new_gfn)
            if not np.array_equal(got, rows):
                dst.evict_ms(new_gfn)            # roll back, keep source
                self.migrations_rejected[REJECT_MIGRATE_VERIFY] += 1
                return None, None, REJECT_MIGRATE_VERIFY
        src.evict_ms(gfn)
        self.migrations += 1
        self.migration_mps += src.cfg.mps_per_ms
        if self.remap_listener is not None:
            self.remap_listener(src, gfn, dst, new_gfn, True)
        return dst, new_gfn, "ok"

    # ------------------------------------------------------ rolling upgrade
    def start_rolling_upgrade(self, module_cls: Type[EngineModule],
                              drain_rounds: Optional[int] = None) -> None:
        """Plan a fleet-wide rolling hot-upgrade.

        Nodes are batched by failure domain (one domain in flight at a
        time) so a bad module build can never take out more than one
        domain before the health probes abort the rollout.
        """
        if self._rolling is not None:
            raise RuntimeError("a rolling upgrade is already in flight")
        domains: Dict[int, List[NodeAgent]] = {}
        for n in self.nodes:
            if not n.alive:              # dead nodes are not upgraded
                continue
            domains.setdefault(n.failure_domain, []).append(n)
        if not domains:
            raise RuntimeError("no alive nodes to upgrade")
        batches = [sorted(domains[d], key=lambda n: n.node_id)
                   for d in sorted(domains)]
        self.upgrade_aborted = False
        self.upgrade_abort_reason = ""
        self.upgrade_batches_done = 0
        self._rolling = _RollingUpgrade(
            module_cls, batches,
            drain_rounds if drain_rounds is not None
            else self.cfg.upgrade_drain_rounds,
            baseline_p90_ns=self._fleet_fault_hist().percentile(0.90))

    @property
    def upgrade_in_progress(self) -> bool:
        return self._rolling is not None

    def _abort_rolling(self, reason: str) -> None:
        self.upgrade_aborted = True
        self.upgrade_abort_reason = reason
        self._rolling = None

    def _drive_rolling(self) -> None:
        ru = self._rolling
        if ru is None:
            return
        if ru.in_flight:
            batch = ru.batches[ru.batch_idx]
            dead = [n for n in batch if not n.alive]
            if dead:
                # a batch member died mid-drain/swap: abort the rollout
                # cleanly. Surviving batch members finish their drain via
                # step() and return to serving -- nothing stays stuck.
                self._abort_rolling(
                    f"node {dead[0].node_id} died mid-upgrade batch")
                return
            if any(not n.serving for n in batch):
                return                   # still draining/swapping
            ru.in_flight = False
            if not self._validate_batch(batch, ru):
                self.upgrade_aborted = True
                self._rolling = None
                return
            self.upgrade_batches_done += 1
            ru.batch_idx += 1
        if ru.batch_idx >= len(ru.batches):
            self._rolling = None         # rollout complete
            return
        batch = ru.batches[ru.batch_idx]
        dead = [n for n in batch if not n.alive]
        if dead:
            self._abort_rolling(
                f"node {dead[0].node_id} died before its upgrade batch")
            return
        if self.cfg.latency_guard_factor is not None:
            ru.pre_batch_hist = self._fleet_fault_hist()
            ru.pre_batch_epoch = (self.kills, self.recoveries)
        for n in batch:
            n.begin_upgrade(ru.module_cls, ru.drain_rounds)
        ru.in_flight = True

    def _validate_batch(self, batch: List[NodeAgent],
                        ru: _RollingUpgrade) -> bool:
        """Abort-on-regression gate after each failure-domain batch."""
        target = ru.module_cls.VERSION
        for n in batch:
            if n.upgrade_failed or n.module_version != target:
                self.upgrade_abort_reason = (
                    f"node {n.node_id}: module swap failed "
                    f"(version {n.module_version} != {target})")
                return False
            if not n.health_probe():
                self.upgrade_abort_reason = (
                    f"node {n.node_id}: post-upgrade health probe failed")
                return False
        guard = self.cfg.latency_guard_factor
        if (guard is not None and ru.baseline_p90_ns > 0
                and ru.pre_batch_hist is not None
                and (self.kills, self.recoveries) == ru.pre_batch_epoch):
            since = _hist_delta(self._fleet_fault_hist(), ru.pre_batch_hist)
            if (since.count >= self.cfg.latency_guard_min_samples
                    and since.percentile(0.90) > guard * ru.baseline_p90_ns):
                self.upgrade_abort_reason = (
                    f"fleet p90 fault latency regressed past "
                    f"{guard:.1f}x baseline")
                return False
        return True

    # ------------------------------------------------------------ snapshots
    def _fleet_fault_hist(self) -> LatencyHistogram:
        agg = LatencyHistogram()
        for n in self.nodes:
            if not n.alive:
                continue
            # the fault_latency property folds pending ring samples itself
            agg.merge(n.system.metrics.fault_latency)
        return agg

    def latency_snapshot(self) -> Dict[str, object]:
        """Fleet-wide latency aggregation (timing-dependent)."""
        out: Dict[str, object] = {}
        fault_agg: Optional[LatencyHistogram] = None
        for name, pick in (("fault", lambda m: m.fault_latency),
                           ("swap_out", lambda m: m.swap_out_latency),
                           ("swap_in", lambda m: m.swap_in_latency)):
            agg = LatencyHistogram()
            for n in self.nodes:
                if not n.alive:
                    continue
                agg.merge(pick(n.system.metrics))
            out[name] = agg.snapshot()
            if name == "fault":
                fault_agg = agg
        # the paper's 10us claim is for passive swap-in (fault path)
        out["frac_fault_under_10us"] = fault_agg.fraction_below(10_000)
        return out

    def snapshot(self) -> Dict[str, object]:
        return {
            "deterministic": {
                "ticks": self.ticks,
                "admitted": self.admitted,
                "rejections": dict(self.rejections),
                "placements": {str(k): v
                               for k, v in sorted(self.placements.items())},
                "reclaimed_mps": self.reclaimed_mps,
                "fleet_committed_ms": self.fleet_committed_ms(),
                "fleet_free_ms": self.fleet_free_ms(),
                "alive_nodes": sum(1 for n in self.nodes if n.alive),
                "kills": self.kills,
                "recoveries": self.recoveries,
                "migrations": self.migrations,
                "migration_mps": self.migration_mps,
                "migrations_rejected": dict(self.migrations_rejected),
                "ms_replaced": self.ms_replaced,
                "ms_lost": self.ms_lost,
                "remote_leases": len(self.leases),
                "remote_puts": self.remote_puts,
                "remote_recovered": self.remote_recovered,
                "remote_rereplicated": self.remote_rereplicated,
                "remote_dropped": self.remote_dropped,
                "remote_evicted": self.remote_evicted,
                "remote_held": sum(n.system.backend.remote_held()
                                   for n in self.nodes if n.alive),
                "remote_modeled_ns": sum(n.system.backend.remote_modeled_ns
                                         for n in self.nodes if n.alive),
                "upgrade_in_progress": self.upgrade_in_progress,
                "upgrade_batches_done": self.upgrade_batches_done,
                "upgrade_aborted": self.upgrade_aborted,
                "upgrade_abort_reason": self.upgrade_abort_reason,
                "nodes": [n.snapshot()["deterministic"]
                          for n in self.nodes],
            },
            "latency": self.latency_snapshot(),
        }

    def deterministic_bytes(self) -> bytes:
        """Canonical serialization of the deterministic snapshot: two
        replays of the same seeded trace must produce identical bytes."""
        return json.dumps(self.snapshot()["deterministic"],
                          sort_keys=True).encode()

    def close(self) -> None:
        for n in self.nodes:
            n.close()
