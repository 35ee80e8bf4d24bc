#!/usr/bin/env python3
"""Time one phase of two checkouts' ``chip_smoke.py`` on one card, in turns.

    python3 tools/ab_swap_path.py PARENT_DIR CHANGE_DIR [--phase main|serve]
                                  [--managed-ms 4096]

``--phase main`` (the default) runs the swap path's main-path phases
(fill past physical memory, stepped reclaim, passive faults, active
swap-in, hv_sched reclaim, byte-exact verify) at ``--managed-ms`` MSs of
frames and prints swap-out MP/s, the fill and reclaim times, the passive
reads' seconds and fault p50 / p90, swap-in MP/s and the kernel launches
per MS swapped out.
``--phase serve`` runs the serve phase (qwen3-4b at full width, bf16, 8
requests of 512 prompt tokens then 64 new) and prints the mean, median
and min decode step of the 64-step window, the prompt's seconds and the
device busy share. One process per run, in the order parent, change,
change, parent, parent, change; one JSON line per run. Each checkout
builds its own kernels. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ORDER = ("parent", "change", "change", "parent", "parent", "change")
KEYS = {
    "main": ("swap_out_mp_per_s", "fill_s", "reclaim_s", "passive_s",
             "fault_p50_us", "fault_p90_us", "swap_in_mp_per_s",
             "launches_per_ms_swapped_out"),
    "serve": ("decode_step_ms_mean", "decode_step_ms_median", "decode_step_ms_min",
              "prompt_steps_s", "device_busy_share"),
}


def one(tree: Path, phase: str, managed: int) -> None:
    """Child process: ``phase`` of ``tree`` (its own modules); prints its
    numbers as ``{"ab": {...}}``."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch.core as core
    from repro_torch.kernels import _build, ops
    _build.build()
    lines: list = []
    chip_smoke.log = lines.append
    if phase == "main":
        system, _ = chip_smoke.main_path(torch, np, core, ops, managed, 0)
        system.close()
        r = next(json.loads(s)["main_path"] for s in lines
                 if s.startswith('{"main_path"'))
    else:
        r, _ = chip_smoke.serve_path(torch, ops, 0)
    print(json.dumps({"ab": {k: r[k] for k in KEYS[phase]}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--phase", choices=tuple(KEYS), default="main")
    ap.add_argument("--managed-ms", type=int, default=4096)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.parent.resolve(), args.phase, args.managed_ms)
        return 0
    for which in ORDER:
        tree = getattr(args, which).resolve()
        proc = subprocess.run(
            [sys.executable, __file__, str(tree), str(tree), "--one",
             "--phase", args.phase, "--managed-ms", str(args.managed_ms)],
            capture_output=True, text=True, timeout=900)
        line = next((json.loads(s)["ab"] for s in proc.stdout.splitlines()
                     if s.startswith('{"ab"')), None)
        if proc.returncode or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": which, "tree": str(tree), "phase": args.phase,
                          **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
