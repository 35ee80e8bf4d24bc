#!/usr/bin/env python3
"""Time the paged latent-attention (MLA) kernel on the card beside its
bound and its plain version.

    python3 tools/paged_mla_time.py

At DeepSeek-V2's shape (16 heads, 576-wide latent rows, 512-wide value)
and the decode cell's batch of 64 over a 1024-position table of 64-token
blocks, shuffled: for contexts of 256, 512 and 1024 positions, and the
cell's mix (256 + i for sequence i), the kernel's time (CUDA events over
a CUDA-graph replay of 20 launches, median of 7; bf16 and f32), its
L2-cold time (a 256 MiB write before each launch, less the write's own
time), its bound (``ops.paged_mla_cost``'s bytes over 3.35 TB/s or FLOPs
over 989 TFLOP/s, the larger), the plain version's time (eager, on the
card) and the largest difference from the plain version. One JSON line
each, then the card's name and power limit. Needs the card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

HEADS, WIDTH, RANK = 16, 576, 512
BATCH, BT, MBS = 64, 64, 16
REPLAYS, REPEATS = 20, 7
HBM, PEAK = 3.35e12, 989e12


def _events_ms(fn, n: int = 1) -> float:
    import torch
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("paged_mla_time: needs the card")
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    scale = get_config("deepseek-v2-lite").softmax_scale()
    g = torch.Generator().manual_seed(0)
    n_blocks = BATCH * MBS
    table = torch.randperm(n_blocks, generator=g).view(BATCH, MBS).int().to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.randn(n_blocks, BT, WIDTH, generator=g).to(dev, dtype)
        q = torch.randn(BATCH, HEADS, WIDTH, generator=g).to(dev, dtype)
        cases = {"256": [256] * BATCH, "512": [512] * BATCH, "1024": [1024] * BATCH,
                 "cell_mix": [256 + i for i in range(BATCH)]}
        for name, lens in cases.items():
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = ops.paged_mla_decode(q, pool, table, kv_len, RANK, scale)
            want = ref.paged_mla_decode(q.float(), pool.float(), table, kv_len, RANK, scale)
            err = float((out.float() - want).abs().max())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(REPLAYS):
                    ops.paged_mla_decode(q, pool, table, kv_len, RANK, scale)
            graph.replay()
            warm = statistics.median(_events_ms(graph.replay, REPLAYS) for _ in range(REPEATS))

            def cold_once():
                flush.fill_(1)
                ops.paged_mla_decode(q, pool, table, kv_len, RANK, scale)
            flush_ms = statistics.median(_events_ms(lambda: flush.fill_(1)) for _ in range(REPEATS))
            cold = statistics.median(_events_ms(cold_once) for _ in range(REPEATS)) - flush_ms
            plain = statistics.median(_events_ms(lambda: ref.paged_mla_decode(
                q, pool, table, kv_len, RANK, scale)) for _ in range(3))
            flops, nbytes = ops.paged_mla_cost(q, pool, table, 0, RANK)
            rows = sum(lens)
            flops += 2 * rows * HEADS * (WIDTH + RANK)
            nbytes += rows * WIDTH * pool.element_size()
            bound_us = max(nbytes / HBM, flops / PEAK) * 1e6
            print(json.dumps({
                "paged_mla": name, "dtype": str(dtype).split(".")[-1], "batch": BATCH,
                "kernel_us": warm * 1e3, "l2_cold_us": cold * 1e3, "bound_us": bound_us,
                "bound_by": "bytes" if nbytes / HBM >= flops / PEAK else "flops",
                "roofline_pct": 100 * bound_us / (warm * 1e3), "plain_us": plain * 1e3,
                "max_abs_err": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "launches": ops.launches.get("paged_mla")}))


if __name__ == "__main__":
    main()
