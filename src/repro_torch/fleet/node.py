"""NodeAgent -- one TaijiSystem as a member of a multi-node fleet.

The paper deploys Taiji "across more than 30,000 servers"; the fleet
layer reproduces the control-plane half of that claim. A NodeAgent wraps
one :class:`TaijiSystem` plus its hot-upgrade entry table (``tj.ko``
analogue) and exposes:

  * deterministic stepped operation -- ``step()`` is one background round
    (LRU scan shards + optionally one reclaim round), driven by the
    fleet controller's event loop instead of hv_sched threads, so fleet
    simulations are exactly reproducible on the single-core container;
  * periodic snapshots -- free-MS, watermark zone, swap/backend counters
    and the upgrade epoch, split into a byte-stable ``deterministic``
    view and a timing-dependent ``latency`` view;
  * per-node rolling-upgrade mechanics -- drain (stop serving), swap the
    engine module through ``core/hotupgrade.py``, resume -- which the
    controller sequences across failure domains.

Port: a copy of ``repro/fleet/node.py`` whose node boots the port's
:class:`TaijiSystem` on ``device`` (the card by default, ``"cpu"`` for
the parity runs). A killed node also drops its system, so its frames
leave the device at the kill; the reference keeps the closed system
until recovery, and nothing reads it there.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional, Set, Type

from ..core.config import TaijiConfig
from ..core.errors import ABIMismatchError, InvalidStateError, TaijiError
from ..core.hotupgrade import EngineModule, EntryOps, hot_upgrade, install_module
from ..core.system import TaijiSystem
from ..obs.tracer import (ST_NODE_CALL, TAG_READ, TAG_READ_MANY, TAG_WRITE,
                          TAG_WRITE_MANY)

_perf_ns = time.perf_counter_ns

# pressure penalty per watermark zone: a node already reclaiming is a
# worse placement target than raw occupancy alone suggests
_ZONE_PENALTY = {"ok": 0.0, "band": 0.25, "low": 0.5, "critical": 1.0}


class NodeNotServingError(InvalidStateError):
    """Raised when guest traffic hits a node that is draining mid-upgrade."""


class NodeDeadError(InvalidStateError):
    """Raised when any traffic hits a killed node (chaos injection)."""


class _PendingUpgrade:
    __slots__ = ("module_cls", "rounds_left")

    def __init__(self, module_cls: Type[EngineModule], rounds: int) -> None:
        self.module_cls = module_cls
        self.rounds_left = rounds


class NodeAgent:
    def __init__(self, node_id: int, cfg: TaijiConfig,
                 failure_domain: int = 0, device=None) -> None:
        self.node_id = node_id
        self.cfg = cfg
        self.failure_domain = failure_domain
        self.device = device
        self._boot()

        self.allocated: Set[int] = set()
        # remote-peer tier: gfns of THIS node that currently
        # have a replica leased out on a peer. Mirrors the controller's
        # lease registry so the guest write path can break a lease in
        # O(1) without asking the controller about every access;
        # `_lease_break` is installed by the FleetController.
        self.leased_gfns: Set[int] = set()
        self._lease_break = None
        self.alive = True                # False after chaos kill()
        self.recoveries = 0              # completed kill->recover cycles
        self.rounds = 0                  # stepped background rounds executed
        self.reclaim_windows = 0         # rounds in which reclaim fired
        self.upgrade_epoch = 0           # completed hot-upgrades
        self.upgrade_failed = False      # last upgrade attempt failed (ABI)
        self._upgrade: Optional[_PendingUpgrade] = None

    def _boot(self) -> None:
        """Fresh system bring-up, shared by __init__ and recover() so a
        recovered node boots exactly like a new one (GA module installed
        through the entry table).  Guest traffic goes through the node's
        canonical GuestSpace -- the one sanctioned surface -- so fleet
        replays hit the same instrumented path as the integrations."""
        self.system = TaijiSystem(self.cfg, device=self.device)
        self.space = self.system.guest
        self.entry = EntryOps()
        install_module(self.system, self.entry, EngineModule(self.system))
        # stage-attributed tracing (repro_torch.obs): the node's tracer tags its
        # spans with the node id so a fleet Chrome trace shows one process
        # track per node; None when disabled. Re-runs on recover() -- a
        # rebooted node gets a fresh tracer like any other subsystem.
        tr = self.system.metrics.tracer
        if tr is not None:
            tr.pid = self.node_id
        self._tr = tr

    # -------------------------------------------------------------- serving
    @property
    def serving(self) -> bool:
        """False while dead or draining mid-upgrade: no guest traffic."""
        return self.alive and self._upgrade is None

    def _check_alive(self) -> None:
        if not self.alive:
            raise NodeDeadError(f"node {self.node_id} is dead")

    def _check_serving(self) -> None:
        self._check_alive()
        if self._upgrade is not None:
            raise NodeNotServingError(
                f"node {self.node_id} is draining for hot-upgrade")

    # ------------------------------------------------------------ kill/recover
    def kill(self) -> None:
        """Chaos injection: this node dies now.

        Its TaijiSystem is torn down (contents are gone, like a crashed
        server); ``allocated`` is left intact so the controller's failure
        recovery knows which committed MSs it must re-place. Idempotent.
        The system is dropped too, and collected now (it holds itself in
        cycles), so a dead node holds no frames on the device.
        """
        if not self.alive:
            return
        self.alive = False
        self._upgrade = None             # a draining node dies mid-drain
        self.system.close()
        self.system = self.space = self.entry = self._tr = None
        gc.collect()

    def recover(self) -> None:
        """Bring a killed node back as a fresh, empty, serving member.

        Boots a new TaijiSystem with the GA module installed (a replaced
        server PXE-boots the base image, not whatever was mid-rollout);
        lifetime counters (rounds, upgrade_epoch) survive the identity.
        """
        if self.alive:
            raise InvalidStateError(f"node {self.node_id} is not dead")
        self._boot()
        self.allocated = set()
        self.leased_gfns = set()
        self.upgrade_failed = False
        self.alive = True
        self.recoveries += 1

    # ------------------------------------------------------------- capacity
    @property
    def capacity_ms(self) -> int:
        """Allocatable virtual MSs (the guest-visible elastic space)."""
        return self.cfg.n_virt_ms - self.cfg.mpool_reserve_ms

    @property
    def managed_phys_ms(self) -> int:
        """Physical MSs backing guest memory (excludes the mpool arena)."""
        return self.cfg.n_phys_ms - self.cfg.mpool_reserve_ms

    @property
    def free_ms(self) -> int:
        return self.system.phys.free_count

    def pressure(self) -> float:
        """Placement score: physical occupancy plus a watermark-zone
        penalty, so admission steers new load away from nodes that are
        already reclaiming (or worse, in fault-path reclaim)."""
        free = self.free_ms
        occupancy = 1.0 - free / max(1, self.managed_phys_ms)
        return occupancy + _ZONE_PENALTY[self.system.watermark.zone(free)]

    # -------------------------------------------------------- guest traffic
    def alloc_ms(self) -> int:
        self._check_serving()
        gfn = self.space.alloc_ms()
        self.allocated.add(gfn)
        return gfn

    def free_ms_gfn(self, gfn: int) -> None:
        self._check_serving()
        self._maybe_break_lease(gfn)     # the replicated content dies here
        self.space.free_ms(gfn)
        self.allocated.discard(gfn)

    def _maybe_break_lease(self, gfn: int) -> None:
        """Invalidate the remote replica before a content-changing op.

        Write-path cost when nothing is leased: one truthiness check on
        an empty set. Conservative ordering -- the lease breaks *before*
        the mutation, so a failed write can at worst drop a still-valid
        replica (data stays authoritative on this node), never leave a
        stale replica behind.
        """
        if self.leased_gfns and gfn in self.leased_gfns \
                and self._lease_break is not None:
            self._lease_break(self, gfn)

    def write_mp(self, gfn: int, mp: int, data: bytes) -> None:
        self.write_at(gfn, mp * self.cfg.mp_bytes, data)

    def read_mp(self, gfn: int, mp: int,
                nbytes: Optional[int] = None) -> bytes:
        n = self.cfg.mp_bytes if nbytes is None else nbytes
        return self.read_at(gfn, mp * self.cfg.mp_bytes, n)

    def write_at(self, gfn: int, off: int, data: bytes) -> None:
        """Byte-granular guest write (captured-trace payload replay)."""
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        self._check_serving()
        self._maybe_break_lease(gfn)
        self.space.write(gfn, data, off=off)
        if tr is not None:
            tr.push(ST_NODE_CALL, t0, _perf_ns() - t0, TAG_WRITE)

    def read_at(self, gfn: int, off: int, nbytes: int) -> bytes:
        """Byte-granular guest read (captured-trace read-verify)."""
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        self._check_serving()
        data = self.space.read(gfn, nbytes, off=off)
        if tr is not None:
            tr.push(ST_NODE_CALL, t0, _perf_ns() - t0, TAG_READ)
        return data

    def write_many(self, items) -> None:
        """Batched guest writes over (gfn, off, data) triples: one
        serving check + one GuestSpace batch call for the whole vector
        (the fleet wrapper's per-access share was a measurable slice of
        fleet swap-in p90 vs single-box)."""
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        self._check_serving()
        if self.leased_gfns:
            for gfn, _off, _data in items:
                self._maybe_break_lease(gfn)
        self.space.write_many(items)
        if tr is not None:
            tr.push(ST_NODE_CALL, t0, _perf_ns() - t0, TAG_WRITE_MANY)

    def read_many(self, reqs) -> list:
        """Batched guest reads over (gfn, off, nbytes) triples; see
        :meth:`write_many`."""
        tr = self._tr
        if tr is not None:
            t0 = _perf_ns()
        self._check_serving()
        out = self.space.read_many(reqs)
        if tr is not None:
            tr.push(ST_NODE_CALL, t0, _perf_ns() - t0, TAG_READ_MANY)
        return out

    # --------------------------------------------------- migration (control)
    def export_ms(self, gfn: int):
        """Non-consuming MS image for migration (see TaijiSystem.export_ms).

        Control-plane path: works on a draining (mid-upgrade) node too --
        decommissioning must be able to move data off a node that is not
        taking guest traffic -- but never on a dead one.
        """
        self._check_alive()
        if gfn not in self.allocated:
            raise InvalidStateError(
                f"gfn {gfn} is not allocated on node {self.node_id}")
        return self.system.export_ms(gfn)

    def import_ms(self, rows, resident) -> int:
        """Admit one exported MS image (requires a serving node)."""
        self._check_serving()
        gfn = self.system.import_ms(rows, resident)
        self.allocated.add(gfn)
        return gfn

    def evict_ms(self, gfn: int) -> None:
        """Control-plane teardown of one MS (migration source drop).

        Bypasses the serving gate -- a draining node can still be drained
        of data -- and drops the MS's backend entries through the normal
        free path so the compression accounting returns to baseline.
        """
        self._check_alive()
        self._maybe_break_lease(gfn)
        self.system.guest_free_ms(gfn)
        self.allocated.discard(gfn)

    # ----------------------------------------------------- stepped background
    def step(self, *, reclaim: bool = True) -> int:
        """One deterministic background round.

        Draining nodes only advance their upgrade countdown (the module
        swap happens at the end of the drain); serving nodes run every
        LRU scan shard and, when the controller's stagger window allows,
        one reclaim round -- routed through the entry table so an
        upgraded module's reclaim implementation takes over seamlessly.
        """
        if not self.alive:
            return 0
        self.rounds += 1
        if self._upgrade is not None:
            self._upgrade.rounds_left -= 1
            if self._upgrade.rounds_left <= 0:
                self._finish_upgrade()
            return 0
        self.system.step_background(reclaim=False)    # LRU scan shards only
        if not reclaim:
            return 0
        self.reclaim_windows += 1
        return int(self.entry.call("reclaim_round"))

    # ----------------------------------------------------------- hot-upgrade
    def begin_upgrade(self, module_cls: Type[EngineModule],
                      drain_rounds: int = 1) -> None:
        if self._upgrade is not None:
            raise InvalidStateError(f"node {self.node_id} already upgrading")
        self._upgrade = _PendingUpgrade(module_cls, max(1, drain_rounds))

    def _finish_upgrade(self) -> None:
        assert self._upgrade is not None
        module_cls = self._upgrade.module_cls
        try:
            hot_upgrade(self.system, self.entry, module_cls(self.system))
        except (ABIMismatchError, TaijiError):
            self.upgrade_failed = True
        else:
            self.upgrade_failed = False
            self.upgrade_epoch += 1
        finally:
            self._upgrade = None

    @property
    def module_version(self) -> int:
        return self.system.module_version

    def health_probe(self) -> bool:
        """Deterministic post-upgrade self-check.

        Pushes one MS through the full data path of the (possibly new)
        module: alloc, write a marker, active swap-out through the entry
        table, fault it back in, verify bytes, free. Abort-on-regression
        for the rolling upgrade keys off this (plus the optional latency
        guard in the controller).
        """
        if self.upgrade_failed:
            return False
        if len(self.allocated) >= self.capacity_ms:
            return True                  # no room for a probe: version-only
        marker = bytes([(0x5A + self.node_id) & 0xFF]) * 32
        try:
            gfn = self.alloc_ms()
            try:
                self.write_mp(gfn, 0, marker)
                self.entry.call("swap_out_ms", gfn)
                ok = self.read_mp(gfn, 0, len(marker)) == marker
            finally:
                self.free_ms_gfn(gfn)
        except TaijiError:
            return False
        return ok and self.system.metrics.crc_failures == 0

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, object]:
        if not self.alive:
            # dead nodes have no system to snapshot: a minimal byte-stable
            # view keeps chaos replays comparable without try/except
            return {
                "deterministic": {
                    "node_id": self.node_id,
                    "failure_domain": self.failure_domain,
                    "alive": False,
                    "serving": False,
                    "allocated_ms": len(self.allocated),
                    "rounds": self.rounds,
                    "reclaim_windows": self.reclaim_windows,
                    "upgrade_epoch": self.upgrade_epoch,
                    "upgrade_failed": self.upgrade_failed,
                    "recoveries": self.recoveries,
                },
                "latency": {},
            }
        s = self.system.snapshot()
        s["deterministic"].update(
            node_id=self.node_id,
            failure_domain=self.failure_domain,
            alive=True,
            serving=self.serving,
            allocated_ms=len(self.allocated),
            rounds=self.rounds,
            reclaim_windows=self.reclaim_windows,
            upgrade_epoch=self.upgrade_epoch,
            upgrade_failed=self.upgrade_failed,
            recoveries=self.recoveries,
        )
        return s

    def close(self) -> None:
        if self.alive:                   # a killed node is already closed
            self.system.close()
