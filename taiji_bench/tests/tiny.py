"""Tiny versions of each configuration (the same keys, small sizes) and a
run of a cell on the CPU through the harness, the look for a card
skipped."""
import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from taiji_bench import bench  # noqa: E402

torch.set_num_threads(1)


def tiny_taiji() -> dict:
    c = copy.deepcopy(bench.config_file("taiji-paper-2m"))
    c.update(ms_bytes=16 * 4096, mps_per_ms=16, managed_ms=32)
    c["lru"].update(scan_interval_s=0.002, stabilize_scans=1)
    c["scheduler"].update(cycle_ms=2.0)
    c["page_mix"]["images"] = 8
    return c


def tiny_qwen(dtype: str = "bfloat16") -> dict:
    """qwen3-4b's keys at a tiny size. The initializer is scaled up so that
    the program's and the float8 control's widest gaps read at this size
    about as they do at full width (program 0.05-0.08, control 1.3-2.3 on
    three seeds; at full width 0.04-0.27 and 1.77-2.23)."""
    c = copy.deepcopy(bench.config_file("qwen3-4b-on-taiji"))
    c.update(hidden_size=64, head_dim=16, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=128, num_hidden_layers=2,
             vocab_size=512, initializer_range=0.35)
    c["serving"].update(dtype=dtype, kv_block_tokens=16)
    return c


def tiny_run(cell: str, seconds: float = 1.0, trace: bool = False, seed: int = 2**31 + 11,
             dtype: str = "bfloat16"):
    """``(run, e2e, per_layer)`` of ``cell`` at a tiny size on the CPU."""
    c, config, traffic, e2e, per_layer = bench.resolve(cell)
    manager = None
    if c["config"] == "taiji-paper-2m":
        config = tiny_taiji()
        traffic = dict(traffic, warmup_ops=200) if "warmup_ops" in traffic else traffic
    else:
        config, manager = tiny_qwen(dtype), tiny_taiji()
        traffic = dict(traffic, prompt_tokens=8, max_seq=48, batch=4)
    run = bench.Run(cell=c, config=config, traffic=traffic, seed=seed,
                    seconds=seconds, trace=trace, device="cpu", manager=manager)
    return run, e2e, per_layer


def execute(run, e2e, per_layer):
    return bench.execute(run, e2e, per_layer, time.perf_counter(),
                         log=lambda *a, **k: None)
