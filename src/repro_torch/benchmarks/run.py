"""Benchmark harness entry of the port: one module per paper table/figure.

Prints ``name,value,derived`` CSV rows per the harness contract and
records every row in a JSON artifact (default
``build/repro_torch/BENCH_torch_{smoke,quick,full}.json`` at the root of
the checkout)::

    python -m repro_torch.benchmarks.run [--quick] [--smoke]
        [--device cpu|cuda] [--out PATH] [--trace-out PATH]

Port: ``benchmarks/run.py`` over the port's modules, in the same order
with the same rows. ``--device`` holds every module's frames and tensors
(default: the card). Outside ``--smoke`` it ends with the roofline table
of :mod:`.roofline`, from the dry run's artifacts
(``python -m repro_torch.launch.dryrun --all``).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time
import traceback
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _module_rows(mod, smoke: bool, trace_out=None, device=None):
    """Call ``mod.rows()``, passing ``smoke=`` / ``trace_out=`` /
    ``device=`` only where supported."""
    params = inspect.signature(mod.rows).parameters
    kw = {}
    if smoke and "smoke" in params:
        kw["smoke"] = True
    if trace_out and "trace_out" in params:
        kw["trace_out"] = trace_out
    if "device" in params:
        kw["device"] = device
    return mod.rows(**kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the slower latency benchmark")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny configs, seconds not minutes")
    ap.add_argument("--device", default=None,
                    help="where frames and tensors live: cuda (the "
                         "default) or cpu")
    ap.add_argument("--out", default=None,
                    help="JSON artifact path (default "
                         f"{OUT_DIR}/BENCH_torch_<mode>.json)")
    ap.add_argument("--trace-out", default=None,
                    help="write the fleet replay's stage spans as "
                         "Chrome-trace-event JSON (open in Perfetto / "
                         "chrome://tracing)")
    args = ap.parse_args()

    from . import (backend_ratio, code_size, fault_latency, fleet,
                   lru_accuracy, metadata, overcommit, overhead)

    modules = [
        ("overhead (Fig 11/12)", overhead),
        ("metadata (Fig 13a)", metadata),
        ("overcommit (Fig 13b, §5.3.3)", overcommit),
        ("lru_accuracy (Fig 15b)", lru_accuracy),
        ("backend_ratio (Fig 15c)", backend_ratio),
        ("code_size (Table 2)", code_size),
        ("fleet (multi-node replay + chaos)", fleet),
    ]
    if not args.quick:
        # smoke mode keeps fault_latency (it carries the batched-vs-scalar
        # swap throughput rows) with a tiny config
        modules.insert(0, ("fault_latency (Fig 14f/15d)", fault_latency))

    print("name,value,derived")
    failures = 0
    recorded = {}
    for title, mod in modules:
        t0 = time.time()
        try:
            for name, value, derived in _module_rows(mod, args.smoke,
                                                     args.trace_out,
                                                     args.device):
                print(f"{name},{value:.6g},{derived}")
                recorded[name] = {"value": float(value), "derived": str(derived)}
        except Exception:
            failures += 1
            traceback.print_exc()
        print(f"# {title} done in {time.time()-t0:.1f}s", file=sys.stderr)

    if not args.smoke:
        print("\n# === roofline table (from dry-run artifacts) ===")
        try:
            from . import roofline
            roofline.run(verbose=True)
        except Exception:
            failures += 1
            traceback.print_exc()

    mode = "smoke" if args.smoke else ("quick" if args.quick else "full")
    out_path = Path(args.out) if args.out else OUT_DIR / f"BENCH_torch_{mode}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"mode": mode, "device": args.device or "cuda",
               "failures": failures, "rows": recorded}
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"# wrote {os.path.abspath(out_path)}", file=sys.stderr)

    if failures:
        raise SystemExit(f"{failures} benchmark modules failed")


if __name__ == "__main__":
    main()
