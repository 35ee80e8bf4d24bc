"""The port's paper benchmarks (``repro_torch.benchmarks``) held against
the reference's (``benchmarks/``) on the CPU: the same workload bytes,
and every result that reads no clock equal at the reference's sizes."""
import ast
import hashlib
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.benchmarks import (backend_ratio, code_size,  # noqa: E402
                                    fault_latency, lru_accuracy, metadata,
                                    overcommit, overhead, workload)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    """The reference's benchmark modules, imported as the package
    ``benchmarks`` (they import ``.workload`` relatively). Its
    ``fault_latency`` lowers the switch interval at import: restored."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    interval = sys.getswitchinterval()
    try:
        return {name: importlib.import_module(f"benchmarks.{name}")
                for name in ("workload", "code_size", "lru_accuracy",
                             "backend_ratio", "metadata", "overcommit",
                             "fault_latency")}
    finally:
        sys.setswitchinterval(interval)


def _no_clock(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "fill_s"}


def test_results_match_the_reference(ref):
    """The workload's bytes (at the reference's and the paper's geometry)
    and every result that reads no clock, at the reference's own sizes."""
    for ms_bytes, mps in ((128 * 1024, 32), (2 << 20, 512)):
        for seed in (0, 11):
            want = ref["workload"].paper_mix_ms(np.random.default_rng(seed),
                                                ms_bytes, mps)
            got = workload.paper_mix_ms(np.random.default_rng(seed),
                                        ms_bytes, mps)
            assert got == want and len(got) == ms_bytes, (ms_bytes, seed)
    r = ref["code_size"]
    assert code_size.run(verbose=False, src=r.SRC, modules=r.MODULES) \
        == r.run(verbose=False)
    assert code_size.run(verbose=False)["Kernels"] > 0
    for batched in (False, True):
        want = ref["overcommit"].run(verbose=False, smoke=True, batched=batched)
        got = overcommit.run(verbose=False, smoke=True, batched=batched,
                             device="cpu")
        assert _no_clock(got) == _no_clock(want), batched
    for port in (metadata, backend_ratio, lru_accuracy):
        name = port.__name__.rsplit(".", 1)[-1]
        assert port.run(verbose=False, device="cpu") \
            == ref[name].run(verbose=False), name


def test_fault_counts_match_the_reference(ref):
    """Fault counts by kind and read-ahead MPs, fast and scalar: the kinds
    merged over the three windows, and the median window's counters among
    the port's windows (the median is picked by p90, a clock; each
    window's counts are not); the extent sweep's faults, ratios and
    extents. The port's ``run`` restores the switch interval."""
    R = ref["fault_latency"]
    keys = ("extent_max_rows", "faults", "compression_ratio",
            "readahead_extents")
    want = [{k: s[k] for k in keys}
            for s in R.extent_sweep(smoke=True, verbose=False)]
    got = [{k: s[k] for k in keys}
           for s in fault_latency.extent_sweep(smoke=True, verbose=False,
                                               device="cpu")]
    assert got == want

    def merged(r):
        return {k: v["count"] for k, v in r["by_kind_merged"].items()}

    names = {"zero_page_faults": "fault_zero_pages",
             "compressed_faults": "fault_compressed_pages",
             "fast_path_faults": "fault_fast_path",
             "readahead_extents": "readahead_extents",
             "readahead_mps": "fault_readahead_mps"}
    for fast, kw in ((True, dict(smoke=True)),
                     (False, dict(smoke=True, n_faults=200, fast_path=False,
                                  readahead=False))):
        interval = sys.getswitchinterval()
        want = R.run(verbose=False, **kw)
        sys.setswitchinterval(interval)
        got = fault_latency.run(verbose=False, device="cpu", **kw)
        assert sys.getswitchinterval() == interval
        assert merged(got) == merged(want), kw
        assert got["compressed_seeded"] == want["compressed_seeded"], kw
        for r in (want, got):
            assert {c: r[k] for k, c in names.items()} \
                in got["window_deltas"], kw
        assert len(got["window_deltas"]) == 3
        read_ahead = sum(d["fault_readahead_mps"] for d in got["window_deltas"])
        assert (read_ahead > 0) == fast, kw


def test_overhead_keeps_every_window_inside_its_cache(monkeypatch):
    """A short ``overhead.run`` on the CPU returns the reference's result
    keys with finite values, and no decode step writes past the cache."""
    tree = ast.parse((ROOT / "benchmarks" / "overhead.py").read_text())
    ref_keys = next({k.value for k in node.value.keys}
                    for node in ast.walk(tree)
                    if isinstance(node, ast.Assign)
                    and getattr(node.targets[0], "id", None) == "result")
    seen = []
    step = overhead.serve_step

    def checked(model, tokens, cache, cfg):
        cap = cache["block_table"].shape[1] * cfg.kv_block_tokens
        seen.append(int(cache["kv_len"].max()))
        assert seen[-1] < cap, f"decode at position {seen[-1]} of {cap}"
        return step(model, tokens, cache, cfg)

    monkeypatch.setattr(overhead, "serve_step", checked)
    r = overhead.run(verbose=False, device="cpu", pairs=2, traced_pairs=2,
                     iters=3)
    assert set(r) == ref_keys
    assert all(math.isfinite(v) for v in r.values())
    # every window decodes the same positions: 1 warm step + 3
    assert seen and max(seen) == 3 and seen.count(0) == len(seen) // 4


def test_run_smoke_on_the_cpu_gives_the_reference_rows(tmp_path):
    smoke = ROOT / "BENCH_smoke.json"
    before = hashlib.sha256(smoke.read_bytes()).hexdigest()
    out = tmp_path / "bench.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--smoke",
         "--device", "cpu", "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert hashlib.sha256(smoke.read_bytes()).hexdigest() == before
    rows = json.loads(out.read_text())
    assert rows["failures"] == 0
    assert set(rows["rows"]) == set(json.loads(smoke.read_text())["rows"])
    printed = {line.split(",", 1)[0] for line in proc.stdout.splitlines()
               if "," in line and not line.startswith("#")}
    assert printed - {"name"} == set(rows["rows"])
