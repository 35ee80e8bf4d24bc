#!/usr/bin/env python3
"""Count the serving runs whose KV does not read back as it was written.

    python3 tools/serve_verify_spread.py [TREE]

Runs ``repro_torch.launch.serve.run_serving`` with ``verify=True`` on
reduced qwen3-4b (launch/serve.py's defaults: 24 sequences over 48 physical
blocks, 30 turns of batch 4, prompt 24, gen 8, the reclaim threads in
the background), frames on the CPU, for seeds 0-59, from the checkout
TREE (default: this one), and prints one JSON line: the runs
whose read-back differed from what was appended, the runs that died of
another error (by its type), and the seconds. A guest copy racing a
swap-out shows here as a read-back that differs.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

SEEDS, PHYS_BLOCKS = 60, 48


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.launch.serve import run_serving

    differs, other = [], collections.Counter()
    t0 = time.perf_counter()
    for seed in range(SEEDS):
        try:
            run_serving(reduced_config("qwen3-4b"), n_seqs=24,
                        phys_blocks=PHYS_BLOCKS, turns=30, batch=4,
                        prompt_len=24, gen_len=8, seed=seed,
                        device="cpu", verify=True, verbose=False)
        except RuntimeError as e:
            if "read back differs" not in str(e):
                raise
            differs.append(seed)
        except Exception as e:       # noqa: BLE001 - counted by type
            other[type(e).__name__] += 1
    print(json.dumps({"tree": args.tree, "phys_blocks": PHYS_BLOCKS,
                      "seeds": SEEDS,
                      "read_back_differs": len(differs),
                      "differing_seeds": differs, "other_errors": other,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
