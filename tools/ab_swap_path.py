#!/usr/bin/env python3
"""Time the swap path of two checkouts on one card, in turns.

    python3 tools/ab_swap_path.py PARENT_DIR CHANGE_DIR [--managed-ms 4096]

Runs the main-path phases of each checkout's own ``chip_smoke.py``
(fill past physical memory, stepped reclaim, passive faults, active
swap-in, hv_sched reclaim, byte-exact verify) at ``--managed-ms`` MSs of
frames, one process per run, in the order parent, change, change,
parent, and prints one JSON line per run: swap-out MP/s, the fill and
reclaim times, fault p50 / p90, swap-in MP/s and the kernel launches per
MS swapped out. Each checkout builds its own kernels. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

KEYS = ("swap_out_mp_per_s", "fill_s", "reclaim_s", "fault_p50_us",
        "fault_p90_us", "swap_in_mp_per_s", "launches_per_ms_swapped_out")


def one(tree: Path, managed: int) -> None:
    """Child process: the main path of ``tree`` (its own modules)."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch.core as core
    from repro_torch.kernels import _build, ops
    _build.build()
    t0 = time.perf_counter()
    system, _ = chip_smoke.main_path(torch, np, core, ops, managed, 0)
    system.close()
    print(json.dumps({"main_s": time.perf_counter() - t0}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--managed-ms", type=int, default=4096)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.parent.resolve(), args.managed_ms)
        return 0
    for which in ("parent", "change", "change", "parent"):
        tree = getattr(args, which).resolve()
        proc = subprocess.run(
            [sys.executable, __file__, str(tree), str(tree), "--one",
             "--managed-ms", str(args.managed_ms)],
            capture_output=True, text=True, timeout=900)
        line = next((json.loads(s)["main_path"] for s in proc.stdout.splitlines()
                     if s.startswith('{"main_path"')), None)
        if proc.returncode or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": which, "tree": str(tree),
                          **{k: line[k] for k in KEYS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
