"""Drivers of the ``taiji-paper-2m`` deployment: the guest's fault path
with hv_sched's background work stepped in (``GuestZipf``), the batched
swap engine (``SwapBulk``), and the Zipf guest with the background work
as a co-tenant stepped in another driver's loop (``CoTenant``).

Set-up is the same for all: the configuration file's system with its
frames on the card, every guest MS the run uses allocated and filled
from the 64 paper-mix images (the allocation path reclaims on the way),
then stepped background rounds until free memory is back at the high
watermark. What the program derives from these inputs is its own; the
checks hold it to :class:`~taiji_bench.reference.memory_model.MemoryModel`.
"""
from __future__ import annotations

import gc
import time
from typing import List, Optional

import numpy as np

from .. import workload as W
from ..bench import Check, Run
from ..reference.memory_model import MemoryModel

ACCESS_BYTES = 64
N_PAYLOADS = 4096
DRAWS = 1 << 20          # pre-drawn accesses a worker cycles through


def taiji_config(config: dict, trace: bool):
    """The program's configuration from the configuration file."""
    from repro_torch.core.config import (BackendConfig, HotPathConfig,
                                         LRUConfig, ObsConfig,
                                         SchedulerConfig, SwapConfig,
                                         TaijiConfig, WatermarkConfig,
                                         size_mpool_reserve)
    reserve = size_mpool_reserve(config["ms_bytes"], config["mps_per_ms"],
                                 config["managed_ms"], config["overcommit_ratio"])
    hot = config["hot_path"]
    return TaijiConfig(
        ms_bytes=config["ms_bytes"], mps_per_ms=config["mps_per_ms"],
        n_phys_ms=config["managed_ms"] + reserve, mpool_reserve_ms=reserve,
        overcommit_ratio=config["overcommit_ratio"],
        lru=LRUConfig(**config["lru"]),
        watermark=WatermarkConfig(**config["watermark"]),
        scheduler=SchedulerConfig(**config["scheduler"]),
        backend=BackendConfig(**config["backend"]),
        swap=SwapConfig(batch_mps=config["swap_batch_mps"],
                        hot_path=HotPathConfig(**hot)),
        obs=ObsConfig(enabled=trace))


def counters(m) -> dict:
    m.sync()
    return {k: getattr(m, k) for k in (
        "faults", "mp_swapped_out", "mp_swapped_in", "ms_swapped_out",
        "ms_swapped_in", "swap_out_batches", "swap_in_batches",
        "backend_zero_mps", "backend_compressed_mps", "fault_zero_pages",
        "proactive_reclaims", "crc_failures")}


def span_totals(tracer) -> dict:
    """``{stage: {tag: total ns}}`` of the tracer so far ({} untraced)."""
    if tracer is None:
        return {}
    return {name: {t: v["total_ns"] for t, v in st["by_tag"].items()}
            for name, st in tracer.totals().items()}


def delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = delta(v, before.get(k, {}))
        else:
            out[k] = v - before.get(k, 0)
    return out


class Memory:
    """The system under test, set up from the configuration file, with the
    reference model of what every guest MS holds."""

    def __init__(self, run: Run, config: dict) -> None:
        import torch
        from repro_torch.core.system import TaijiSystem
        self.run, self.config = run, config
        mps, mp = config["mps_per_ms"], config["ms_bytes"] // config["mps_per_ms"]
        self.mps, self.mp = mps, mp
        images = W.paper_mix_images(run.seed, config["page_mix"]["images"], mps, mp)
        pay = W.payloads(run.seed, N_PAYLOADS, ACCESS_BYTES)
        self.payload_bytes = [p.tobytes() for p in pay]
        self.model = MemoryModel(images, pay)
        self.system = TaijiSystem(taiji_config(config, run.trace), device=run.device)
        guest = self.system.guest
        n_fill = int(config["guest_ms_per_managed"] * config["managed_ms"])
        for i in range(n_fill):
            g = guest.alloc_ms()
            guest.write(g, images[i % len(images)])
            self.model.fill(g, i % len(images))
        s = self.system
        while s.phys.free_count < s.watermark.high_ms:
            s.step_background()
        if run.device != "cpu":
            torch.cuda.synchronize()
        self.gfns: List[int] = list(self.model.image_of)
        self.order = W.popularity_order(run.seed, self.gfns)

    def warm(self, hot: List[int], chunk: int = 32) -> None:
        """Make ``hot`` resident, hottest first, as it is in a deployment
        that has been serving this guest for a while; then back to the
        high watermark. Without it the window would measure the minutes
        in which the hot MSs fault in MP by MP."""
        s = self.system
        for lo in range(0, len(hot), chunk):
            s.guest.touch(hot[lo:lo + chunk])
            for _ in range(2):
                s.step_background()
        while s.phys.free_count < s.watermark.high_ms:
            s.step_background()

    def swapped(self, gfn: int) -> bool:
        from repro_torch.core.virt import NO_PFN
        return int(self.system.virt.table.pfn[gfn]) == NO_PFN

    def verify(self, gfns) -> int:
        """Live MSs whose guest-visible bytes differ from the model, or
        that cannot be read back."""
        bad = 0
        for g in gfns:
            try:
                rows, _ = self.system.export_ms(g)
            except Exception:
                bad += 1
                continue
            bad += not np.array_equal(rows.reshape(-1), self.model.ms_bytes(g))
        return bad

    def close(self) -> None:
        self.system.close()


class Worker:
    """One guest worker: Zipf over the MSs it owns (most popular first), the next MP of
    the MS drawn (a cursor that wraps), a 64-byte read or write at a
    drawn slot of that MP. Logs every access for the check."""

    def __init__(self, mem: Memory, wid: int, own: List[int], write_share: float,
                 zipf_s: float):
        self.mem, self.own = mem, own
        self.ops = W.guest_ops(mem.run.seed, wid, DRAWS, len(own),
                               mem.mp // ACCESS_BYTES, write_share, N_PAYLOADS, zipf_s)
        self.cursor: dict = {}
        self.log: list = []
        self.i = 0
        self.done = 0
        self.failed = 0
        self.errors: list = []

    def access(self) -> None:
        k = self.i % DRAWS
        self.i += 1
        o, mem = self.ops, self.mem
        g = self.own[o["rank"][k]]
        off = W.next_mp(self.cursor, g, mem.mps) * mem.mp + int(o["slot"][k]) * ACCESS_BYTES
        guest = mem.system.guest
        try:
            if o["write"][k]:
                p = int(o["payload"][k])
                guest.write(g, mem.payload_bytes[p], off)
                self.log.append((g, off, p))
            else:
                self.log.append((g, off, guest.read(g, ACCESS_BYTES, off)))
            self.done += 1
        except Exception as e:          # counted, and the run is not correct
            self.failed += 1
            self.errors.append(repr(e))

    def loop(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            self.access()
        self.ended = time.perf_counter()


class GuestZipf:
    """Closed loop, one guest stream with hv_sched's BACK work stepped in
    it as ``benchmarks/fault_latency.py`` multiplexes FRONT and BACK: after
    every ``back_every_faults`` faults of the guest, and after every
    access while free memory is below the low watermark, one background
    slice (``step_background``: both LRU scan shards and a reclaim round;
    then reclaim rounds until none reclaims, back at the high watermark;
    then a young-generation garbage collection, automatic collection
    being off in the traffic), timed in the window. The cadence counts
    the guest's own events, so a seed makes the same work at any host
    speed. (A round each ``lru.scan_interval_s`` of the host clock made
    a slower host spend a larger share of the window in BACK, and runs
    of one code spread by 13-15%: ``PERF.md``.)"""

    def __init__(self, run: Run) -> None:
        self.run, self.t = run, run.traffic

    def setup(self) -> None:
        self.mem = Memory(self.run, self.run.config)
        config = self.run.config
        self.mem.warm(self.mem.order[:int(config["managed_ms"] * self.t["warm_share"])])
        self.worker = Worker(self.mem, 0, self.mem.order, self.t["write_share"],
                             self.t["zipf_s"])
        # the same traffic, unmeasured: from the set-up's state, the rate of
        # faults and reclaim takes a while to settle
        if self.t["warmup_ops"] > 0:
            self._drive(float("inf"), self.t["warmup_ops"])

    def _back(self) -> None:
        s = self.mem.system
        s.step_background()
        while s.engine.reclaim_round() > 0:
            pass
        gc.collect(0)

    def _drive(self, seconds: float, max_ops: Optional[int] = None) -> dict:
        """The traffic until ``seconds`` have passed or ``max_ops``
        accesses are made."""
        s, w = self.mem.system, self.worker
        every = self.t["back_every_faults"]
        m = s.metrics
        n0, back_s, rounds = w.done + w.failed, 0.0, 0
        stop = n0 + max_ops if max_ops is not None else None
        low, phys = s.watermark.low_ms, s.phys
        f_due = m.faults + every
        enabled = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            deadline, series, mark, last = t0 + seconds, [], t0 + 1.0, n0
            now = t0
            while now < deadline and (stop is None or w.done + w.failed < stop):
                w.access()
                if m.faults >= f_due or phys.free_count < low:
                    b0 = time.perf_counter()
                    self._back()
                    back_s += time.perf_counter() - b0
                    rounds += 1
                    f_due = m.faults + every
                now = time.perf_counter()
                if now >= mark:                 # accesses, second by second
                    series.append(w.done + w.failed - last)
                    last, mark = w.done + w.failed, mark + 1.0
        finally:
            if enabled:
                gc.enable()
        return {"seconds": now - t0, "ops": w.done + w.failed - n0,
                "series": series, "back_s": back_s, "back_rounds": rounds}

    def window(self, seconds: float) -> dict:
        m = self.mem.system.metrics
        m.sync()
        m.reset_fault_latency()
        c0 = counters(m)
        obs = self._drive(seconds)
        self.run.attempted += obs["ops"]
        return dict(obs, e2e={"guest_ops_per_s": obs["ops"] / obs["seconds"]},
                    counters=delta(counters(m), c0),
                    fault_ns=np.asarray(m.fault_latency.samples, dtype=np.int64))

    def release(self) -> None:
        pass

    def check(self) -> List[Check]:
        mem = self.mem
        self.run.failed += self.worker.failed
        return [Check("wrong_reads", float(mem.model.replay(self.worker.log)), 0.0),
                Check("wrong_ms", float(mem.verify(mem.gfns)), 0.0),
                Check("crc_failures", float(mem.system.metrics.crc_failures), 0.0)]

    def close(self) -> None:
        if hasattr(self, "mem"):
            self.mem.close()


class SwapBulk:
    """The batched swap engine alone: each round one stepped background
    round (LRU scans, then ``reclaim_round`` swapping cold MSs out whole)
    and ``swap_in_per_round`` fully swapped MSs, drawn Zipf(1.2) by
    popularity rank, brought back by ``swap_in_ms``. No guest access."""

    def __init__(self, run: Run) -> None:
        self.run, self.t = run, run.traffic

    def setup(self) -> None:
        self.mem = Memory(self.run, self.run.config)
        g = W.rng(self.run.seed, W.STREAM_SWAP)
        n = len(self.mem.order)
        self.draws = g.choice(n, size=DRAWS, p=W.zipf_weights(n, self.t["zipf_s"]))
        self.i = 0
        self.touched: set = set()

    def _pick(self) -> List[int]:
        mem, want = self.mem, self.t["swap_in_per_round"]
        picked: List[int] = []
        for _ in range(len(self.draws)):
            g = mem.order[self.draws[self.i % len(self.draws)]]
            self.i += 1
            if g not in picked and mem.swapped(g):
                picked.append(g)
                if len(picked) == want:
                    break
        return picked

    def window(self, seconds: float) -> dict:
        import torch
        s = self.mem.system
        m = s.metrics
        c0, sp0 = counters(m), span_totals(s.tracer)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        rounds = 0
        series, mark = [], t0 + 1.0
        prev = c0["mp_swapped_out"] + c0["mp_swapped_in"]
        while time.perf_counter() < deadline:
            if time.perf_counter() >= mark:        # MPs moved, second by second
                now = m.mp_swapped_out + m.mp_swapped_in
                series.append(now - prev)
                prev, mark = now, mark + 1.0
            try:
                s.step_background()
                for g in self._pick():
                    s.engine.swap_in_ms(g)
                    self.touched.add(g)
            except Exception as e:      # counted, and the run is not correct
                self.run.failed += 1
                print(f"swap-bulk: {e!r}", flush=True)
            rounds += 1
        if self.run.device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = delta(counters(m), c0)
        self.run.attempted += rounds
        moved = c["mp_swapped_out"] + c["mp_swapped_in"]
        return {"seconds": dt, "e2e": {"swap_mp_per_s": moved / dt},
                "series": series, "counters": c, "spans": delta(span_totals(s.tracer), sp0),
                "mp_bytes": self.mem.mp, "rounds": rounds}

    def release(self) -> None:
        pass

    def check(self) -> List[Check]:
        mem = self.mem
        return [Check("wrong_ms", float(mem.verify(mem.gfns)), 0.0),
                Check("crc_failures", float(mem.system.metrics.crc_failures), 0.0)]

    def close(self) -> None:
        if hasattr(self, "mem"):
            self.mem.close()


class CoTenant:
    """A guest and hv_sched's background work beside another workload, on
    its thread: ``step(n)`` makes ``n`` of the Zipf guest's accesses and,
    once ``lru.scan_interval_s`` of the host clock has passed since the
    last or while free memory is below the low watermark, one stepped
    background round, and returns the round's seconds."""

    def __init__(self, run: Run, config: dict, write_share: float, warm_share: float,
                 zipf_s: float):
        self.mem = Memory(run, config)
        self.mem.warm(self.mem.order[:int(config["managed_ms"] * warm_share)])
        self.worker = Worker(self.mem, 99, self.mem.order, write_share, zipf_s)
        self.every = config["lru"]["scan_interval_s"]
        self.due = 0.0

    def step(self, n: int) -> float:
        for _ in range(n):
            self.worker.access()
        s = self.mem.system
        t0 = time.perf_counter()
        if t0 < self.due and s.phys.free_count >= s.watermark.low_ms:
            return 0.0
        s.step_background()
        t1 = time.perf_counter()
        self.due = t1 + self.every
        return t1 - t0

    def checks(self) -> List[Check]:
        mem, w = self.mem, self.worker
        touched = sorted({g for g, _, _ in w.log})
        return [Check("cotenant_wrong_reads", float(mem.model.replay(w.log)), 0.0),
                Check("cotenant_wrong_ms", float(mem.verify(touched)), 0.0),
                Check("crc_failures", float(mem.system.metrics.crc_failures), 0.0),
                Check("cotenant_failed_ops", float(w.failed), 0.0)]

    def close(self) -> None:
        self.mem.close()
