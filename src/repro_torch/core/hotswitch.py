"""Hot-switch: convert a running plain system into the elastic architecture
(paper §4.1.2, Fig 6).

The plain system is the "host OS": services access memory directly
(identity translation, no swapping). The hot-switch performs, per PCPU,
the two-stage ``switch_vcpu``:

  stage 1: an SMP call quiesces the PCPU at a safe point, saves its
           register state into a fresh VMCS, prepares the EPT (block
           table), and enters root mode (``hv_sched`` takes over the PCPU);
  stage 2: the new VCPU's first instruction re-enters ``switch_vcpu``,
           restores the saved state and resumes the exact execution flow --
           the guest never observes the transition.

Here the "registers" are each service thread's cursor state, the SMP call
is a per-PCPU quiesce lock, and entering non-root mode means the service's
memory accessor is atomically redirected from direct physical access to
block-table translation. Tests verify the paper's transparency claims:
identical memory contents, zero failed service operations across the
switch, and swappability afterwards.

Port: the frames are the port's one flat ``torch.uint8`` tensor
``phys.frames`` on an explicit device (the card's HBM by default), so the
pre-switch :class:`DirectAccessor` reads with one device-to-host copy and
writes with one host-to-device copy. The hot-switch hands the same
:class:`~.virt.PhysicalMemory` to :class:`~.system.TaijiSystem`: the
guest's frames stay where they are, with no copy, and the system takes
their device. The metadata arena is already a host buffer, so the
identity map ``gfn == pfn`` holds for every slot the plain system hands
out, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from ..analysis.lock_order import named_lock
from .config import TaijiConfig
from .system import TaijiSystem
from .virt import PhysicalMemory, frame_bytes, host_u8


@dataclasses.dataclass
class VMCS:
    """Saved per-VCPU state (register file analogue)."""

    vcpu_id: int
    saved_cursor: Dict[str, object]
    host_rip: str = "hv_sched._run_cycle"   # exit entry point (see hotupgrade)
    launched: bool = False


class PlainMemorySystem:
    """The pre-switch host OS: direct physical access, no elasticity.

    Guest MSs are identity-mapped (gfn == pfn). Services run as threads
    issuing reads/writes through :attr:`accessor`, which the hot-switch
    redirects atomically.
    """

    def __init__(self, cfg: TaijiConfig, device=None) -> None:
        """``device`` holds the frames: ``None`` means the card and raises
        when there is none; pass ``"cpu"`` to run on the CPU."""
        cfg.validate()
        self.cfg = cfg
        self.phys = PhysicalMemory(cfg, device=device)
        self._alloc_lock = named_lock("app")
        self.allocated: List[int] = []
        # pre-switch accessor: identity translation straight to physical
        self.accessor: "MemoryAccessor" = DirectAccessor(self)
        # per-PCPU quiesce locks (the SMP-call stop point)
        self.pcpu_locks = [named_lock("pcpu") for _ in range(cfg.scheduler.shards)]

    def alloc_ms(self) -> int:
        with self._alloc_lock:
            pfn = self.phys.alloc_slot()
            self.allocated.append(pfn)
            return pfn                      # identity: gfn == pfn

    def read(self, pcpu: int, gva: int, n: int) -> bytes:
        with self.pcpu_locks[pcpu % len(self.pcpu_locks)]:
            return self.accessor.read(gva, n)

    def write(self, pcpu: int, gva: int, data: bytes) -> None:
        with self.pcpu_locks[pcpu % len(self.pcpu_locks)]:
            self.accessor.write(gva, data)


class MemoryAccessor:
    def read(self, gva: int, n: int) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError

    def write(self, gva: int, data: bytes) -> None:  # pragma: no cover
        raise NotImplementedError


class DirectAccessor(MemoryAccessor):
    """Host-OS path: VA -> PA via the identity kernel map."""

    def __init__(self, plain: PlainMemorySystem) -> None:
        self.plain = plain

    def read(self, gva: int, n: int) -> bytes:
        return frame_bytes(self.plain.phys.frames[gva : gva + n])

    def write(self, gva: int, data: bytes) -> None:
        self.plain.phys.frames[gva : gva + len(data)].copy_(host_u8(data))


class VirtAccessor(MemoryAccessor):
    """Post-switch path: GVA -> GPA -> HPA through the block table."""

    def __init__(self, system: TaijiSystem) -> None:
        self.system = system

    def read(self, gva: int, n: int) -> bytes:
        return self.system.guest.read_gva(gva, n)

    def write(self, gva: int, data: bytes) -> None:
        self.system.guest.write_gva(gva, data)


def hot_switch(plain: PlainMemorySystem,
               on_stage: Optional[Callable[[int, str], None]] = None) -> TaijiSystem:
    """Switch a running plain system into the Taiji elastic architecture.

    Reuses the *same* PhysicalMemory (no copy: the guest's memory stays in
    place, on its device); builds the virtualization layer around it;
    converts each PCPU via the two-stage switch; finally redirects the
    accessor.
    """
    cfg = plain.cfg
    system = TaijiSystem(cfg, phys=plain.phys)

    # identity-map every MS the host OS had allocated (gfn == pfn), so the
    # switched guest sees exactly the memory it had -- then track it in the
    # LRU so it becomes swappable (the whole point of the switch)
    for pfn in plain.allocated:
        system.virt.table.map_huge(pfn, pfn)
        system.lru.track(pfn)
        with system._gfn_lock:
            if pfn in system._free_gfns:
                system._free_gfns.remove(pfn)

    vmcss: List[VMCS] = []
    for pcpu, lock in enumerate(plain.pcpu_locks):
        # ---- SMP call: quiesce this PCPU at a safe point
        with lock:
            if on_stage:
                on_stage(pcpu, "stage1")
            # stage 1: save state into the VMCS, prepare EPT + structures
            vmcs = VMCS(vcpu_id=pcpu, saved_cursor={"pcpu": pcpu,
                                                    "t": time.monotonic()})
            # stage 2: "VMLAUNCH" -- the VCPU resumes the saved flow; from
            # now on this PCPU's accesses translate through the block table
            vmcs.launched = True
            vmcss.append(vmcs)
            if on_stage:
                on_stage(pcpu, "stage2")
        # the PCPU is now a VCPU task under hv_sched; its original
        # execution flow continues (the service thread keeps running)

    # all PCPUs switched: atomically redirect the accessor (single store)
    plain.accessor = VirtAccessor(system)
    system.vmcss = vmcss
    return system
