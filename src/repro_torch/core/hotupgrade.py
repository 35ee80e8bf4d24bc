"""Hot-upgrade (paper §4.4, Fig 10).

Taiji splits into ``tj.ko`` (entry, never upgraded) and ``tj_hv_x.ko``
(main functionality, upgradable). We reproduce all three mechanisms:

  * **Data-plane compatibility** -- persistent metadata (MS records in the
    mpool arena) has a fixed ABI with reserved fields; the new module
    *attaches* to the same bytes (``MSRecord(..., attach=True)`` verifies
    the ABI version) with no conversion.
  * **Operation entry points** -- :class:`EntryOps` is the ``devtj``
    f_ops_g analogue: every external call goes through one global table;
    an upgrade atomically repoints table entries to the new module after
    in-flight calls drain (refcounted).
  * **VCPU execution transition** -- hv_sched workers re-read
    ``loop_entry`` every iteration; the upgrade installs the new module's
    scheduler loop (the HOST_RIP update), so each shard hands off at its
    next safe point without stopping.

Port: a copy of ``repro/core/hotupgrade.py``. It is host code over the
port's :class:`~.swap.SwapEngine`, MS records and hv_sched; none of it
touches the frames, so a module attached after the switch swaps the
device's frames through the same kernels as any other engine.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..analysis.lock_order import named_lock
from .config import ABI_VERSION
from .errors import ABIMismatchError
from .ms import MSRecord, record_nbytes
from .swap import SwapEngine
from .system import TaijiSystem


class EntryOps:
    """tj.ko: the stable, never-upgraded entry module."""

    def __init__(self) -> None:
        self._ops: Dict[str, Callable] = {}
        self._inflight = 0
        self._lock = named_lock("entry")
        self._drained = threading.Condition(self._lock)

    def register(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._ops[name] = fn

    def call(self, name: str, *args, **kwargs):
        with self._lock:
            fn = self._ops[name]
            self._inflight += 1
        try:
            return fn(*args, **kwargs)
        finally:
            with self._lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._drained.notify_all()

    def swap_all(self, new_ops: Dict[str, Callable], timeout: float = 5.0) -> None:
        """Atomically repoint every entry after in-flight calls complete.

        "All updates occur only after calls to the old module complete."
        """
        with self._lock:
            deadline = time.monotonic() + timeout
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("in-flight entry calls did not drain")
                self._drained.wait(remaining)
            self._ops.update(new_ops)


class EngineModule:
    """tj_hv_x.ko: one version of the main functionality.

    Subclasses may change internal behaviour but must keep the metadata
    ABI. ``attach`` re-validates every persistent record against the ABI
    before taking over -- an incompatible module refuses to load.
    """

    VERSION = 1
    ABI = ABI_VERSION

    def __init__(self, system: TaijiSystem) -> None:
        self.system = system
        self.engine: Optional[SwapEngine] = None

    # ------------------------------------------------------------- lifecycle
    def attach(self) -> None:
        sys = self.system
        if self.ABI != sys.cfg.abi_version:
            raise ABIMismatchError(
                f"module ABI {self.ABI} != system ABI {sys.cfg.abi_version}")
        expected = record_nbytes(sys.cfg)
        # inherit metadata directly: re-open every persistent record from
        # the same arena bytes, verifying layout (no conversion)
        for gfn, req in sys.reqs.items():
            rec = MSRecord(sys.cfg, req.record.handle, attach=True)
            if rec.handle.nbytes < expected or rec.gfn != gfn:
                raise ABIMismatchError(f"record for gfn {gfn} incompatible")
            req.record = rec
        # a fresh engine instance (new code) over the inherited state
        self.engine = self.make_engine()

    def make_engine(self) -> SwapEngine:
        sys = self.system
        return SwapEngine(sys.cfg, sys.virt, sys.backend, sys.reqs, sys.lru,
                          sys.watermark, sys.metrics)

    # entry-point table served through tj.ko
    def ops(self) -> Dict[str, Callable]:
        assert self.engine is not None
        return {
            "fault_in": self.engine.fault_in,
            "swap_out_ms": self.engine.swap_out_ms,
            "swap_in_ms": self.engine.swap_in_ms,
            "reclaim_round": self.engine.reclaim_round,
            "version": lambda: self.VERSION,
        }

    # the scheduler loop this module provides (HOST_RIP target)
    def sched_loop(self) -> Callable[[int], None]:
        return self.system.scheduler._run_cycle


class EngineModuleV2(EngineModule):
    """An upgraded module: same ABI, improved reclaim batching.

    Demonstrates a real behavioural change shipped by hot-upgrade: reclaim
    rounds take the cold-intermediate set into account immediately and use
    a doubled batch, converging to the high watermark in fewer rounds.
    """

    VERSION = 2

    def make_engine(self) -> SwapEngine:
        engine = super().make_engine()
        base_reclaim = engine.reclaim_round

        def reclaim_round_v2(budget_s=None) -> int:
            t0 = time.monotonic()
            n = base_reclaim(budget_s)
            if n > 0:                       # keep pressure while productive,
                # but within the same hv_sched quantum, not a second one
                rem = (None if budget_s is None
                       else budget_s - (time.monotonic() - t0))
                if rem is None or rem > 0:
                    n += base_reclaim(rem)
            return n

        engine.reclaim_round = reclaim_round_v2  # type: ignore[assignment]
        return engine


def install_module(system: TaijiSystem, entry: EntryOps,
                   module: EngineModule) -> None:
    """First-time load: attach and register all entry points."""
    module.attach()
    for name, fn in module.ops().items():
        entry.register(name, fn)
    system.scheduler.loop_entry = module.sched_loop()
    system.module_version = module.VERSION


def hot_upgrade(system: TaijiSystem, entry: EntryOps,
                new_module: EngineModule) -> None:
    """Upgrade the running module to ``new_module`` without service stop."""
    # 1) load + verify the new module against the live metadata (ABI gate)
    new_module.attach()
    # 2) VCPU execution transition: repoint the scheduler loop; every shard
    #    hands off at its next iteration boundary (HOST_RIP update)
    system.scheduler.loop_entry = new_module.sched_loop()
    # 3) repoint all operation entry points after old calls drain
    entry.swap_all(new_module.ops())
    system.module_version = new_module.VERSION
