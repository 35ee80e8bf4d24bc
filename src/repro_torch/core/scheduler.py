"""hv_sched -- the Taiji resource scheduler (paper §4.3, Fig 9).

Per-shard (per-PCPU) run queues with four priority classes:

    FRONT -- switched VCPUs (here: foreground train/serve step work)
    FCPU  -- reserved for hot-plugged VCPUs (CPU elasticity, §7.4)
    BACK  -- background elasticity tasks (lru scans, swap/reclaim)
    IDLE  -- idle housekeeping

Static configuration assigns each class a proportional share of every
scheduling cycle; dynamically the scheduler (1) penalizes tasks that
overrun their quantum, shrinking their slice for the next cycles, (2)
reallocates unused slices to tasks of the same or lower priority, and (3)
lets operators adjust the shard set and shares at runtime -- all three
mechanisms from the paper.

Hot-upgrade hook: each worker thread re-reads its ``loop_entry`` every
iteration (the HOST_RIP handoff analogue, §4.4): swapping the entry
redirects the shard to the new module's scheduler loop at a safe point.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

from ..analysis.lock_order import named_lock
from ..obs.tracer import ST_SCHED_TASK
from .config import TaijiConfig

FRONT, FCPU, BACK, IDLE = range(4)
CLASS_NAMES = ("FRONT", "FCPU", "BACK", "IDLE")
# task kinds, the tag of a task's sched_task spans
TASK_LRU_SCAN, TASK_RECLAIM, TASK_OTHER = range(3)

_perf_ns = time.perf_counter_ns


class Task:
    """A cooperative task. ``fn(quantum_s) -> bool`` (True = more work)."""

    __slots__ = ("name", "cls", "kind", "fn", "penalty_left",
                 "penalty_factor", "runtime_s", "runs", "overruns", "done")

    def __init__(self, name: str, cls: int, fn: Callable[[float], bool],
                 kind: int = TASK_OTHER) -> None:
        self.name = name
        self.cls = cls
        self.kind = kind
        self.fn = fn
        self.penalty_left = 0
        self.penalty_factor = 1.0
        self.runtime_s = 0.0
        self.runs = 0
        self.overruns = 0
        self.done = False


class RunQueue:
    """Per-shard run queue with four priority classes."""

    def __init__(self) -> None:
        self.classes: List[List[Task]] = [[], [], [], []]
        self.lock = named_lock("sched.rq")
        # accounting: per-class runtime for fairness checks (Fig 14b)
        self.class_runtime_s = [0.0, 0.0, 0.0, 0.0]

    def add(self, task: Task) -> None:
        with self.lock:
            self.classes[task.cls].append(task)

    def remove(self, task: Task) -> None:
        with self.lock:
            try:
                self.classes[task.cls].remove(task)
            except ValueError:
                pass


class HvScheduler:
    def __init__(self, cfg: TaijiConfig, tracer=None) -> None:
        self.cfg = cfg
        # stage-attributed tracing (repro_torch.obs): one sched_task span per
        # task run, tagged with the task's kind; None when disabled
        self._tr = tracer
        sc = cfg.scheduler
        self.n_shards = sc.shards
        self.rqs = [RunQueue() for _ in range(self.n_shards)]
        self._shares = [sc.share_front, sc.share_fcpu, sc.share_back, sc.share_idle]
        self._back_enabled = [True] * self.n_shards
        self._threads: List[threading.Thread] = []
        self._running = False
        self.cycles = 0
        # hot-upgrade handoff: workers re-read this every iteration
        self.loop_entry: Callable[[int], None] = self._run_cycle
        self._rr: Dict[int, List[int]] = {s: [0, 0, 0, 0] for s in range(self.n_shards)}
        # adaptive idle backoff (SchedulerConfig.idle_backoff_max): sleep
        # multiplier per shard; grows while cycles do no real work so an
        # idle manager stops stealing GIL slices from foreground decode
        self._idle_mult = [1.0] * self.n_shards
        # per-cycle hooks: cheap epoch-publish/drain callbacks
        # run at the top of every shard-0 cycle (one publisher is enough;
        # hooks must be fast and must not raise for long)
        self._cycle_hooks: List[Callable[[], None]] = []

    def add_cycle_hook(self, fn: Callable[[], None]) -> None:
        """Register a callback run once per shard-0 scheduling cycle.

        The swap engine uses this to epoch-publish the watermark zone and
        drain deferred fast-path LRU joins on the background cadence --
        the staleness bound of the published view is one cycle
        (``SchedulerConfig.cycle_ms``, stretched by idle backoff)."""
        self._cycle_hooks.append(fn)

    # ------------------------------------------------------------- task API
    def add_task(self, shard: int, name: str, cls: int,
                 fn: Callable[[float], bool], kind: int = TASK_OTHER) -> Task:
        t = Task(name, cls, fn, kind)
        self.rqs[shard % self.n_shards].add(t)
        # new work: snap the shard out of idle backoff at its next wakeup
        self._idle_mult[shard % self.n_shards] = 1.0
        return t

    def hotplug_vcpu(self, shard: int, name: str,
                     fn: Callable[[float], bool]) -> Task:
        """CPU elasticity (§7.4): a hot-plugged VCPU lands in FCPU and is
        scheduled like a switched VCPU once it receives time slices."""
        return self.add_task(shard, name, FCPU, fn)

    def remove_task(self, shard: int, task: Task) -> None:
        self.rqs[shard % self.n_shards].remove(task)

    # -------------------------------------------------------- dynamic knobs
    def set_shares(self, front: float, fcpu: float, back: float, idle: float) -> None:
        if front + fcpu + back + idle > 1.0 + 1e-9:
            raise ValueError("shares must sum to <= 1")
        self._shares = [front, fcpu, back, idle]

    def set_back_enabled(self, shard: int, enabled: bool) -> None:
        """Operator control of which shards may run background tasks."""
        self._back_enabled[shard] = enabled

    # ------------------------------------------------------------ main loop
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        for s in range(self.n_shards):
            th = threading.Thread(target=self._worker, args=(s,),
                                  name=f"hv_sched/{s}", daemon=True)
            self._threads.append(th)
            th.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._running = False
        for th in self._threads:
            th.join(timeout)
        self._threads.clear()

    def _worker(self, shard: int) -> None:
        while self._running:
            # re-read loop_entry each iteration: the HOST_RIP handoff point
            entry = self.loop_entry
            entry(shard)

    # one scheduling cycle for one shard
    def _run_cycle(self, shard: int) -> None:
        if shard == 0:
            for hook in self._cycle_hooks:
                try:
                    hook()
                except Exception:
                    pass  # hooks are advisory; same policy as task errors
        cycle_s = self.cfg.scheduler.cycle_ms / 1e3
        rq = self.rqs[shard]
        start = time.perf_counter()
        deadline = start + cycle_s
        budgets = [cycle_s * s for s in self._shares]
        if not self._back_enabled[shard]:
            budgets[FRONT] += budgets[BACK]
            budgets[BACK] = 0.0
        carry = 0.0
        spent_cycle = 0.0
        for cls in (FRONT, FCPU, BACK, IDLE):
            if cls == BACK and not self._back_enabled[shard]:
                # disabled shard: BACK must not inherit carried slices
                # either (a penalized FRONT task's unused slice would
                # otherwise leak here); pass the carry straight to IDLE
                continue
            # unused slices flow downward, but never past the cycle end:
            # a class can only spend what remains of this cycle
            budget = min(budgets[cls] + carry,
                         max(0.0, deadline - time.perf_counter()))
            spent_cap = budgets[cls] + carry
            unused = self._run_class(rq, shard, cls, budget)
            spent_cycle += max(0.0, budget - unused)
            carry = max(0.0, spent_cap - (budget - unused))
        self.cycles += 1
        # adaptive idle backoff: a cycle whose tasks barely ran (empty LRU
        # slices, watermark satisfied) doubles this shard's sleep, up to
        # idle_backoff_max cycles; any working cycle snaps it back to 1.
        # An idle manager must not steal GIL slices from foreground decode
        # (paper Fig 11: within 3% of native).
        sc = self.cfg.scheduler
        if spent_cycle < cycle_s * sc.idle_spent_frac:
            self._idle_mult[shard] = min(self._idle_mult[shard] * 2.0,
                                         max(1.0, sc.idle_backoff_max))
        else:
            self._idle_mult[shard] = 1.0
        # sleep out the remainder of the (possibly stretched) cycle so
        # shares are honored in wall-clock terms even when queues are empty
        elapsed = time.perf_counter() - start
        sleep_s = cycle_s * self._idle_mult[shard] - elapsed
        if sleep_s > 0 and self._running:
            time.sleep(sleep_s)

    def _run_class(self, rq: RunQueue, shard: int, cls: int, budget: float) -> float:
        """Run tasks of one class round-robin within ``budget``.

        Returns the unused budget (reallocated to lower classes).
        """
        if budget <= 0:
            return 0.0
        with rq.lock:
            tasks = [t for t in rq.classes[cls] if not t.done]
        if not tasks:
            return budget
        spent_total = 0.0
        quantum = budget / max(1, len(tasks))
        idx0 = self._rr[shard][cls]
        self._rr[shard][cls] = (idx0 + 1) % max(1, len(tasks))
        overrun_penalty = self.cfg.scheduler.overrun_penalty
        for i in range(len(tasks)):
            t = tasks[(idx0 + i) % len(tasks)]
            if spent_total >= budget:
                break
            q = quantum * t.penalty_factor
            tr = self._tr
            t0 = _perf_ns() if tr is None else tr.begin(ST_SCHED_TASK)
            try:
                more = t.fn(q)
            except Exception:
                more = False
            dt_ns = _perf_ns() - t0
            if tr is not None:
                tr.end(ST_SCHED_TASK, t0, t.kind, dt_ns)
            dt = dt_ns / 1e9
            t.runtime_s += dt
            t.runs += 1
            spent_total += dt
            rq.class_runtime_s[cls] += dt
            # overrun = exceeded the granted quantum by 50% and by an
            # absolute margin (filters thread-scheduling jitter)
            if dt > q * 1.5 and dt - q > 5e-4:
                t.overruns += 1
                t.penalty_factor = overrun_penalty
                t.penalty_left = self.cfg.scheduler.penalty_cycles
            elif t.penalty_left > 0:
                t.penalty_left -= 1
                if t.penalty_left == 0:
                    t.penalty_factor = 1.0
            if not more:
                t.done = True
                rq.remove(t)
        return max(0.0, budget - spent_total)

    # ------------------------------------------------------------- fairness
    def class_runtime(self) -> Dict[str, float]:
        out = {n: 0.0 for n in CLASS_NAMES}
        for rq in self.rqs:
            for cls, n in enumerate(CLASS_NAMES):
                out[n] += rq.class_runtime_s[cls]
        return out
