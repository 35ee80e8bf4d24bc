#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 taiji_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and,
traced, ``breakdown``), and last the numbers compared for ``correct``
beside their limits (also the last lines of standard error). Without a
CUDA card, or with fewer than the cell asks for, or without the program
(``src/repro_torch``) beside it, it exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from taiji_bench import bench
    cell, config, traffic, e2e, per_layer = bench.resolve(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("taiji_bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"taiji_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    manager = bench.config_file(config["manager"]) if "manager" in config else None
    run = bench.Run(cell=cell, config=config, traffic=traffic, seed=args.seed,
                    seconds=args.seconds, trace=bool(args.trace), manager=manager)
    result = bench.execute(run, e2e, per_layer, T0)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
