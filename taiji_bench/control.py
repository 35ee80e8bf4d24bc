#!/usr/bin/env python3
"""The controls, each run through the harness in the program's place, on
the card at a cell's own size (the benchmark's own runs never run this):

    python3 taiji_bench/control.py --workload <cell> --seeds 11 12 13 [--seconds 20]

For each seed, one whole run of the cell (set-up, window, checks) with
the control planted, and its result line: each one has to come out not
correct. The controls are:

* decode cells: the tokens that a float8 (e4m3) forward of the plain
  reference puts first, at each position of the same prompts and served
  tokens, judged in place of the program's (the step below bfloat16);
* swap cells: a backend that keeps each byte to 7 bits, planted in the
  program's own codec once set-up is done (a lossy store: the guarantee
  the configuration states, broken). The window's stores lose a bit;
  whatever the program or the checks then find is the reading.

The program's own readings are those of ``run.py``'s runs. Exits 1 if a
control came out correct.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


class LossyZlib:
    """``zlib`` for the program's backend, its compressor keeping each
    byte to 7 bits (``memory_model.lossy``)."""

    def __init__(self, real) -> None:
        self.real = real

    def compress(self, data, *a, **k):
        from taiji_bench.reference.memory_model import lossy
        return self.real.compress(lossy(bytes(data)), *a, **k)

    def __getattr__(self, name):
        return getattr(self.real, name)


def controlled(cls):
    """The driver ``cls`` with its control planted."""
    if hasattr(cls, "gaps"):
        class Float8(cls):
            def gaps(self, control: bool = False):
                return super().gaps(control=True)
        return Float8

    class Lossy(cls):
        def setup(self) -> None:
            super().setup()
            from repro_torch.core import backend
            backend.zlib = LossyZlib(backend.zlib)
    return Lossy


@contextlib.contextmanager
def planted():
    """``bench.driver_class`` gives the controlled drivers; the program's
    codec is restored on the way out."""
    from repro_torch.core import backend
    from taiji_bench import bench
    find, real = bench.driver_class, backend.zlib
    bench.driver_class = lambda path: controlled(find(path))
    try:
        yield
    finally:
        bench.driver_class, backend.zlib = find, real


def control_result(run, e2e, per_layer, log=print) -> dict:
    """One run of ``run`` with the control in the program's place."""
    from taiji_bench import bench
    with planted():
        return bench.execute(run, e2e, per_layer, time.perf_counter(), log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from taiji_bench import bench
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell, config, traffic, e2e, per_layer = bench.resolve(args.workload)
    seconds = args.seconds or bench.spec()["run_seconds"]
    manager = bench.config_file(config["manager"]) if "manager" in config else None
    passed = 0
    for seed in args.seeds:
        run = bench.Run(cell=cell, config=config, traffic=traffic, seed=seed,
                        seconds=seconds, trace=False, manager=manager)
        t0 = time.perf_counter()
        r = control_result(run, e2e, per_layer)
        passed += bool(r and r["correct"])
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "seconds": time.perf_counter() - t0,
                          "card": torch.cuda.get_device_name(0), **(r or {})}),
              flush=True)
        torch.cuda.empty_cache()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
