#!/usr/bin/env python3
"""Repeat the decode-overhead benchmark to see its spread on one card.

    python3 tools/overhead_spread.py

Runs ``repro_torch.benchmarks.overhead.run`` on qwen3-4b at full width
(bf16, weights from seed 0; 4 pairs and 2 traced pairs of 30-step
windows) twice for each manager (512 managed 2 MiB MSs, or
the reference's small test system) at each interpreter switch interval
(the default 5 ms, and the 0.5 ms the reference's harness runs every
benchmark at), in turn within a repetition, and prints one JSON line a
run: the native and manager-live step (the min over windows), the
trimmed-mean overhead and the tracer's. Needs the card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# managed MSs of each manager (0: the reference's small test system) and
# the switch intervals, seconds
MANAGER_MS, INTERVALS = (512, 0), (0.005, 0.0005)
# repetitions of the whole sweep
REPS = 2


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("overhead_spread: needs the card")
    from repro_torch.benchmarks import overhead
    from repro_torch.benchmarks.workload import Geometry
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_config("qwen3-4b")
    model = M.cast_params(M.init_params(cfg, seed=0, device="cuda"))
    default = sys.getswitchinterval()
    for rep in range(REPS):
        for ms in MANAGER_MS:
            for interval in INTERVALS:
                sys.setswitchinterval(interval)
                t0 = time.perf_counter()
                r = overhead.run(verbose=False, device="cuda", model=model,
                                 cfg=cfg, pairs=4, traced_pairs=2, iters=30,
                                 geometry=Geometry(ms) if ms else None)
                sys.setswitchinterval(default)
                print(json.dumps({
                    "rep": rep, "manager_ms": ms, "switch_interval_s": interval,
                    "seconds": time.perf_counter() - t0,
                    **{k: r[k] for k in ("decode_native_ms", "decode_elastic_ms",
                                         "decode_overhead", "tracer_overhead")}}),
                      flush=True)


if __name__ == "__main__":
    main()
