"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name:

* ``configs/<config>.json``, the configuration as it is run (the path
  ``BENCHMARK.json`` gives);
* ``traffic/<traffic>.json``, the traffic mix's parameters, whose
  ``driver`` names the general generator that reads them
  (``<module>.<class>`` under ``drivers/``);
* ``metrics/<metric>.py``, a reader with ``read(obs) -> float | None``.

A driver has ``setup()``, ``window(seconds)`` (the traffic for that long;
it returns what it observed, the end-to-end metrics among it),
``release()`` (frees the program's state once the peak memory is read),
``check()`` (the comparisons that decide ``correct``, after the window)
and ``close()``. The harness times set-up, runs the window, in a traced
run a profiled sub-window after it, reads the peak memory, runs the
checks and prints one JSON line.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_S = 5.0          # the longest profiled sub-window
DEVICE_OPS, IDLE_GAPS = 10, 10


@dataclasses.dataclass
class Check:
    """One number compared against its limit (pass: ``value <= limit``)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, its configuration and traffic,
    the run's arguments and the device."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    manager: Optional[dict] = None     # the configuration a manager runs
    attempted: int = 0
    failed: int = 0


def spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(name: str, root: Path = ROOT):
    """The cell ``name`` with its configuration, traffic and metrics:
    ``(cell, config, traffic, end_to_end, per_layer)``."""
    s = spec(root)
    cell = next((w for w in s["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = config_file(cell["config"], root)
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in s["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in s["per_layer"] if m["moves"] in moved
                 and name in m.get("workloads", [name])]
    return cell, config, traffic, e2e, per_layer


def config_file(name: str, root: Path = ROOT) -> dict:
    """The configuration named ``name``, as its file holds it."""
    entry = next(c for c in spec(root)["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def driver_class(path: str):
    module, cls = path.rsplit(".", 1)
    return getattr(importlib.import_module(f"taiji_bench.drivers.{module}"), cls)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py`` (a file name may
    hold dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(f"taiji_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ------------------------------------------------------------------ profile
def _union_s(iv) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    busy, end = 0, None
    for s, e in sorted(iv):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def summarize(prof, window_s: float) -> dict:
    """Device busy seconds, kernel seconds by name, the device operations
    that took most time and the idle gaps by what the host was doing,
    from a ``torch.profiler`` run over ``window_s`` seconds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        (dev if e.device_type() == cuda else host).append((s, s + d, e.name()))
    kernels: Dict[str, float] = {}
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) / 1e9
    iv = sorted((s, e) for s, e, _ in dev)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:IDLE_GAPS]
    idle = []
    for a, b in gaps:
        mid = (a + b) // 2
        inner = [(e - s, n) for s, e, n in host if s <= mid < e]
        idle.append([min(inner)[1][:96] if inner else "no_torch_op", (b - a) / 1e9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:DEVICE_OPS]
    return {"window_s": window_s, "busy_s": _union_s(iv), "kernels": kernels,
            "device_ops": [[n[:96], t] for n, t in top],
            "idle_gaps": idle}


def profiled_window(driver, seconds: float):
    """The driver's traffic for ``seconds`` under ``torch.profiler``:
    ``(what the driver observed, the trace's summary)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        obs = driver.window(seconds)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return obs, summarize(prof, dt)


# ---------------------------------------------------------------------- run
def device_info(run: Run, peak: int) -> dict:
    import torch
    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(run.cell["chips"]), "memory_peak_bytes": peak}


def execute(run: Run, e2e: List[dict], per_layer: List[dict], t0: float,
            log=print) -> Optional[dict]:
    """Set up, measure, check; the result line's object, or ``None`` when
    the run may print no result (a forbidden module was loaded)."""
    import torch
    cuda = run.device != "cpu"
    driver = driver_class(run.traffic["driver"])(run)
    try:
        driver.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        obs = {"window": driver.window(run.seconds), "config": run.config,
               "traffic": run.traffic}
        if run.trace and cuda:
            obs["profiled"], obs["trace"] = profiled_window(
                driver, min(PROFILE_S, run.seconds))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        t_check = time.perf_counter()
        driver.release()
        checks = driver.check()
        log(f"taiji_bench: window, second by second: {obs['window'].get('series')}",
            file=sys.stderr)
        log(f"taiji_bench: set-up {setup_s:.3f} s, window "
            f"{obs['window']['seconds']:.3f} s, check "
            f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    finally:
        driver.close()
    bad = forbidden_modules()
    if bad:
        log(f"taiji_bench: modules of JAX or of its package loaded: {bad}",
            file=sys.stderr)
        return None
    checks.append(Check("failed_ops", float(run.failed), 0.0))
    metrics = {}
    if run.trace:
        for m in per_layer:
            v = reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            v = (setup_s if m["name"] == "setup_s"
                 else obs["window"]["e2e"].get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": all(c.ok for c in checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run, peak)}
    if run.trace and "trace" in obs:
        t = obs["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    return result
