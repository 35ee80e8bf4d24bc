#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--managed-ms 2048] [--fleet-node-ms 256] [--seed 0]

Phases, one after another, each fatal on failure (exit code 1), each
freeing its device memory before the next:

1. build        -- compile every ``csrc/*.cu`` source with nvcc for
                   sm_90a (one nvcc each, in parallel) and print the
                   card's name and power limit;
2. kernels      -- hold each swap kernel (the swap-out's compacting
                   gather, gather, the swap-in's verified scatter and its
                   plain mode, zero scan, Fletcher) against its plain
                   PyTorch version on the card (exact equality, the
                   verified scatter's verdict too) at the main-path
                   shapes and at ragged shapes, paged decode
                   attention within its tolerances at the serve path's
                   shape and the f32/f16 sweep, and the int8 quantize
                   pair bit for bit (tests/test_kernels.py's sweep in
                   f32/f16/bf16, zero, -0.0 and tie MPs, qwen3-4b's KV
                   block); time kernel, plain version and library call,
                   paged attention also at the kv_len of ``ATTN_SWEEP``,
                   the swap kernels, paged attention and quantize also
                   L2-cold, and with ``--compare-sources DIR`` the
                   swap-in's chunk write (host clock), Fletcher, paged
                   attention, quantize and, where DIR's sources have the
                   separate gather and zero scan, the swap-out's chunk
                   read against the earlier sources in DIR, in turns
                   (old, new, new, old);
3. main         -- Taiji's swap data path at the paper's deployment size
                   (2 MiB MS, 4 KiB MP, ``--managed-ms`` managed MSs of
                   guest frames in HBM, +50% elastic): fill past physical
                   memory, reclaim, passive faults, active swap-in,
                   hv_sched background reclaim under guest traffic, then
                   every live MS checked byte for byte; per MS swapped in,
                   one verified scatter and one host wait a chunk, and no
                   other scatter, Fletcher pass or index upload;
4. corrupt      -- a flipped extent tag must raise CorruptionError from
                   the device-side check;
5. hot-switch   -- a plain system with ``--managed-ms`` MSs of frames in
                   HBM, one service thread per PCPU writing and reading
                   through it, is hot-switched into Taiji; the swap engine
                   is installed (v1), swaps out through the entry table,
                   is hot-upgraded to v2 while the services fault, and v2
                   reclaims (1024 / 256 / 1024 MSs at 4096 managed MSs or
                   more, scaled down with fewer); every MS checked byte
                   for byte;
6. serve        -- qwen3-4b at full width (36 layers, d 2560, 32/8 heads,
                   vocab 151936; weights from ``--seed``, cast once to
                   bf16): 8 requests of 512 prompt tokens fed through
                   ``serve_step``, then 64 greedy tokens; every attention
                   layer of every step must launch the paged kernel;
7. serve-parity -- reduced qwen3-4b, the same parameters and tokens
                   decoded on the card (kernel) and on the CPU (plain
                   version);
8. elastic-kv   -- ``run_serving`` with qwen3-4b's KV geometry (one 9 MiB
                   MS per 64-token block, frames in HBM) under pressure;
                   every block read back equal to its host mirror;
9. elastic-serving -- the elastic-serving flow with that geometry: the
                   swap engine hot-upgraded v1 -> v2 halfway, under load;
10. expert-cache -- deepseek-moe-16b's routed experts at full width (one
                   34.6 MB MS of 16 MPs per expert), 4 MoE layers of 64,
                   HBM for half: 4 rounds of 8-token decode batches
                   routed top-6 from a Zipf(1.2) popularity, dispatched
                   layer by layer (swap in, pin, gather), the active
                   experts written back updated every 2nd round, every
                   expert read back bit for bit;
11. fleet       -- 4 nodes of ``--fleet-node-ms`` managed 2 MiB MSs each
                   in HBM, through ``repro_torch.benchmarks.fleet``: the
                   paper trace (rolling hot-upgrade) and the chaos trace
                   (kills, recoveries, live migrations, the remote-peer
                   tier), each replayed twice to equal bytes; both
                   captured workloads replayed twice; one small trace
                   replayed on the CPU and on the card to equal bytes;
                   killed nodes free their frames.

The last two lines of standard output are the kernel table and the
device line as JSON. No card, or no ``src/repro_torch`` beside this
file: a non-zero exit and no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from array import array
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

# H100 SXM peaks: HBM bandwidth (NVIDIA data sheet) and the INT32 rate
# of the integer kernels' operation bound. The data sheet lists no INT32
# rate; a Hopper SM has 64 INT32 lanes against 128 FP32 lanes (H100
# architecture whitepaper), so it is half the sheet's 67 T/s float32
# rate, a multiply-add counted as two operations as there
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# float32 outside the tensor cores (data sheet), the rate of the paged
# attention kernel's f32 arithmetic
FP32_OPS_PER_S = 67e12

# paper Fig 15c page mix, as benchmarks/workload.py
ZERO_FRACTION = 0.7679
# distinct MS images the workload cycles through
N_IMAGES = 64
# MSs read per passive-fault window: ~400 faults each, so a window stays
# inside the 200k-sample latency reservoir and the percentiles cover
# every fault of the phase
PASSIVE_WINDOW_MS = 128

SWAP_SOURCE = "src/repro_torch/csrc/swap_kernels.cu"
ATTN_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
QUANT_SOURCE = "src/repro_torch/csrc/quantize.cu"
KERNELS = {
    # name: (ops counter, TPU kernel it replaces, source, main path)
    "gather_nonzero_rows": ("gather", "src/repro/kernels/swap_copy.py:40",
                            SWAP_SOURCE, "swap path"),
    # the swap-out reads through gather_nonzero_rows, the gather and the
    # zero scan folded into it: these two are on no path, so their
    # launches are their checks' own
    "gather_rows": ("gather", "src/repro/kernels/swap_copy.py:40", SWAP_SOURCE,
                    None),
    # the verified scatter: its check-and-write mode is the swap-in's
    # write (with the tags the swap-in's Fletcher pass checked), its plain
    # mode the fault path's readahead scatter
    "scatter_verified_rows": ("scatter_verified", "src/repro/kernels/swap_copy.py:69",
                              SWAP_SOURCE, "swap path"),
    "scatter_rows_": ("scatter", "src/repro/kernels/swap_copy.py:69", SWAP_SOURCE,
                      "swap path"),
    "zero_rows": ("zero", "src/repro/kernels/zero_detect.py:42", SWAP_SOURCE,
                  None),
    "fletcher_rows": ("fletcher", "src/repro/kernels/crc32c.py:60", SWAP_SOURCE,
                      "swap path"),
    "paged_decode_attention": ("paged_attn",
                               "src/repro/kernels/paged_attention.py:104",
                               ATTN_SOURCE, "serve"),
    # no path of either package calls the quantize pair: their launches
    # are the quantize check's own
    "block_quantize": ("quantize", "src/repro/kernels/compress.py:38",
                       QUANT_SOURCE, None),
    "block_dequantize": ("dequantize", "src/repro/kernels/compress.py:63",
                         QUANT_SOURCE, None),
}
SWAP_COUNTERS = ("gather", "scatter", "scatter_verified", "zero", "fletcher")
# what each swap phase must launch: the compacting gather (counted as
# "gather"), Fletcher and, where MSs come back through faults, the plain
# scatter; and no separate zero scan, which the gather does. The main
# path's active swap-in also launches the verified scatter
SWAP_OUT_IN = ("gather", "scatter", "fletcher")
SWAP_OUT = ("gather", "fletcher")
# the L2-cold timings write this much between launches: more than the
# H100's 50 MB L2
FLUSH_BYTES = 256 << 20
# kv_len of the paged-attention timing sweep: early in a serve prompt,
# the serve phase's 512-token prompt, its last decode step, the serve
# table's capacity
ATTN_SWEEP = (64, 512, 576, 2048)

# the serve phase: qwen3-4b, 8 requests of 512 prompt tokens, 64 new each
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "qwen3-4b", 8, 512, 64
SERVE_MAX_SEQ = 2048
# the paged-attention tolerances of tests/test_kernels.py
ATTN_TOL = {"float32": 2e-5, "float16": 2e-2, "bfloat16": 2e-2}
# the quantize pair at qwen3-4b's KV block: the elastic-KV phase's 24
# physical blocks of 64 tokens x 36 layers x K+V x 8 heads x 128, bf16,
# 8 MPs each
QUANT_CARD_SHAPE, QUANT_CARD_MPS = (24, 4_718_592), 8

# the hot-switch phase: MSs each service (one per PCPU) owns, of which
# half are swapped out under it just before the upgrade; MSs swapped out
# under v1, by a swapper thread across the upgrade, and reclaimed by v2,
# at 4096 managed MSs or more; below that the three scale with the frames
# (the guest's 50% elastic room must hold what v2's pressure allocates)
SERVICE_MS = 8
V1_SWAP_MS, UPGRADE_SWAP_MS, V2_RECLAIM_MS = 1024, 256, 1024
HOT_SWITCH_FULL_MS = 4096
# swapped MSs read back through the guest (the rest through export_ms),
# the fault-latency sample after the switch
FAULT_SAMPLE_MS = 256

# the expert-cache phase: deepseek-moe-16b's routed experts at full width
# (64 of (3, 2048, 1408) float32 a layer: w_gate, w_up, w_down^T) in 4 of
# its 27 MoE layers, HBM for half of them; each round routes a decode
# batch of 8 tokens top-6 per layer from a Zipf(1.2) popularity and
# dispatches layer by layer; every 2nd round writes the active experts
# back updated (2 update rounds of 4); the residency of each layer's 16
# most-routed experts is reported against the rest. A round swaps ~45
# experts out and in (23-24 s on the H100's host), so 4 rounds
EXPERT_ARCH, EXPERT_LAYERS, EXPERT_ROUNDS = "deepseek-moe-16b", 4, 4
EXPERT_TOKENS, EXPERT_ZIPF, EXPERT_UPDATE_EVERY, EXPERT_HOT = 8, 1.2, 2, 16
# float32 weights compress to ~0.93 under zlib level 1, at ~30 MB/s a
# host core: the expert cache's backend compresses each expert (one MS)
# as 8 streams of 2 MPs on 8 host threads, not as one 34.6 MB stream
EXPERT_EXTENT_ROWS, EXPERT_ZLIB_WORKERS = 2, 8
# the fleet phase: 4 nodes of the paper's geometry in 2 failure domains,
# each node's frames in HBM; the paper trace's and the chaos trace's fault
# bursts and the chaos trace's live migrations
FLEET_NODES, FLEET_PAPER_BURST, FLEET_CHAOS_BURST, FLEET_MIGRATIONS = 4, 20000, 6000, 8
# device memory the chaos replays may leave allocated (their killed and
# recovered nodes' frames must all be gone; one node's are 100s of MB)
FLEET_KEPT_SLACK = 4 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- timing
def time_us(torch, fn, inner: int = 40, outer: int = 7) -> float:
    """Device time of one ``fn()`` call in microseconds: ``inner`` calls
    captured in a CUDA graph (so host launch cost is out of the number),
    replayed ``outer`` times, median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(outer):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        per_call.append(t0.elapsed_time(t1) * 1e3 / inner)
    per_call.sort()
    return per_call[len(per_call) // 2]


def time_cold_us(torch, fn, flush) -> tuple:
    """Device time of one ``fn()`` call with its inputs out of L2:
    time(flush + fn) - time(flush), where the flush writes every byte of
    ``flush`` (FLUSH_BYTES, larger than the L2). Returns (cold us, flush +
    fn us, flush us)."""
    both = time_us(torch, lambda: (flush.zero_(), fn()), inner=20)
    alone = time_us(torch, flush.zero_, inner=20)
    return both - alone, both, alone


def time_events_us(torch, fn, inner: int = 20, outer: int = 7) -> float:
    """Device time of one ``fn()`` call in microseconds for a function a
    CUDA graph cannot capture (it waits for the device inside): ``inner``
    eager calls between two events, median of ``outer``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(outer):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        per_call.append(t0.elapsed_time(t1) * 1e3 / inner)
    per_call.sort()
    return per_call[len(per_call) // 2]


def check_swap_launches(where: str, launches: dict, needed) -> None:
    """Each of ``needed`` launched, and no separate zero scan."""
    missing = [k for k in needed if launches.get(k, 0) <= 0]
    if missing:
        fail(f"{where}: swap kernels not launched: {missing}")
    if launches.get("zero", 0):
        fail(f"{where}: {launches['zero']} zero-scan launches; the swap-out's "
             f"gather does the scan")


def bound_us(nbytes: int, nops: int, ops_per_s: float = INT32_OPS_PER_S) -> tuple:
    b = nbytes / HBM_BYTES_PER_S * 1e6
    o = nops / ops_per_s * 1e6
    return (b, "bytes") if b >= o else (o, "operations")


def free_device(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# --------------------------------------------------------------- kernels
def check_kernels(torch, ops, ref, seed: int) -> dict:
    """Phase 2: every kernel against its plain version, exact, at the
    main-path shapes and at ragged ones; times at the main-path shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rows(n, elems, zero_every=0):
        x = torch.randint(0, 256, (n, elems), generator=g, dtype=torch.uint8)
        if zero_every:
            x[::zero_every] = 0
        return x.to(dev)

    def perm(n_pool, k):
        return torch.randperm(n_pool, generator=g)[:k].numpy()

    def max_err(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) \
            if a.numel() else 0.0

    results = {}
    # (label, n_pool, elems, rows): main-path shapes first, then ragged
    # rows (4100 bytes: no 16-byte alignment), one past the 65521 wrap and
    # the expert cache's 2.06 MiB MP
    copy_shapes = [("main64", 512, 4096, 64), ("main13", 512, 4096, 13),
                   ("ragged", 37, 4100, 11)]
    row_shapes = [("main64", 64, 4096), ("main16", 16, 4096),
                  ("ragged", 16, 4100), ("wrap", 3, 70001), ("one", 4, 1),
                  ("fifteen", 5, 15), ("odd", 3, 4097), ("2MiB", 1, 2 ** 21),
                  ("expert_mp", 3, 2_162_688)]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    # the swap-out's compacting gather, bit for bit against gather_blocks +
    # zero_detect: (label, n_pool, elems, indices, every n-th pool row
    # zero; 1: all, 0: none) -- the main-path chunk and its edges, ragged
    # rows, eight 1.125 MiB KV rows, an expert's sixteen 2.06 MiB MPs, a
    # whole MS, more than one launch takes
    compact_shapes = [("main64", 512, 4096, 64, 3), ("all_zero", 512, 4096, 64, 1),
                      ("none_zero", 512, 4096, 64, 0), ("one", 512, 4096, 1, 2),
                      ("main13", 512, 4096, 13, 3), ("ragged", 37, 4100, 11, 2),
                      ("kv_rows", 8, 1_179_648, 8, 2), ("expert_rows", 16, 2_162_688, 16, 2),
                      ("whole_ms", 512, 4096, 512, 3),
                      ("split", 1024, 4096, 700, 2)]
    for label, n_pool, elems, k, zero_every in compact_shapes:
        pool, idx = rows(n_pool, elems, zero_every=zero_every), perm(n_pool, k)
        if zero_every > 1:               # a row zero but for its last byte
            pool[int(idx[0])] = 0
            pool[int(idx[0]), -1] = 1
        zero, got = ops.gather_nonzero_rows(pool, idx)
        want_zero, want = ref.gather_nonzero_blocks(pool, torch.from_numpy(idx).to(dev))
        torch.cuda.synchronize()
        if not (torch.equal(zero, want_zero.cpu()) and torch.equal(got, want)):
            fail(f"gather_nonzero_rows != plain at {label} {(n_pool, elems, k)}")
    pool, idx = rows(512, 4096, zero_every=3), perm(512, 64)
    idx_dev = torch.from_numpy(idx).to(dev)
    meta = torch.empty(4 + 64, dtype=torch.uint8, device=dev)
    out = torch.empty((64, 4096), dtype=torch.uint8, device=dev)
    live = int((~ref.gather_nonzero_blocks(pool, idx_dev)[0]).sum())
    results["gather_nonzero_rows"] = dict(
        shape=f"pool (512, 4096) uint8 (every third row zero), 64 indices, "
              f"{live} non-zero", max_abs_err=0.0, compact_cases=[
                  c[0] for c in compact_shapes],
        kernel_us=time_us(torch, lambda: ops.launch_gather_nonzero(
            pool, idx, meta, out)),
        cold=time_cold_us(torch, lambda: ops.launch_gather_nonzero(
            pool, idx, meta, out), flush),
        plain_us=time_events_us(torch, lambda: ref.gather_nonzero_blocks(
            pool, idx_dev)),
        library_us=None,
        # the rows read, the non-zero rows, the flags and the count written
        bound=bound_us(64 * 4096 + live * 4096 + 64 + 4, 64 * 4096))

    # gather (the launches of its check: the main path does not call it)
    err, n0 = 0.0, ops.launches["gather"]
    for label, n_pool, elems, k in copy_shapes:
        pool, idx = rows(n_pool, elems), perm(n_pool, k)
        got = ops.gather_rows(pool, idx)
        want = ref.gather_blocks(pool, torch.from_numpy(idx).to(dev))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_rows != plain at {label} {(n_pool, elems, k)}")
        err = max(err, max_err(got, want))
    n_gather = ops.launches["gather"] - n0
    pool, idx = rows(512, 4096), perm(512, 64)
    idx_dev = torch.from_numpy(idx).to(dev)
    results["gather_rows"] = dict(
        shape="pool (512, 4096) uint8, 64 indices", max_abs_err=err,
        launches=n_gather,
        kernel_us=time_us(torch, lambda: ops.launch_gather(pool, idx, out)),
        cold=time_cold_us(torch, lambda: ops.launch_gather(pool, idx, out), flush),
        plain_us=time_us(torch, lambda: ref.gather_blocks(pool, idx_dev)),
        library_us=time_us(torch, lambda: torch.index_select(pool, 0, idx_dev)),
        bound=bound_us(2 * 64 * 4096, 0))

    # the verified scatter, bit for bit against its plain version: the
    # staged rows (every fourth verified only), their tags (every third
    # untagged), zero rows -- at the main-path chunk, a whole MS (more
    # rows than one launch takes), ragged rows, eight 1.125 MiB KV rows,
    # an expert's sixteen 2.06 MiB MPs, zero rows only, and each with a
    # tag spoiled (nothing written)
    def verified_case(n_pool, elems, k, z):
        pool, stage = rows(n_pool, elems), rows(k, elems, zero_every=5)
        perm_rows = perm(n_pool, n_pool)
        dst = perm_rows[:k].astype("int64")
        dst[3::4] = -1
        zero = perm_rows[k:k + z].astype("int64")
        tags = (ref.fletcher_checksum(stage).cpu().numpy().astype("int64")
                if k else dst[:0].copy())
        tags[2::3] = -1
        return pool, stage, dst, tags, zero

    verified_shapes = [("chunk64", 512, 4096, 64, 16), ("whole_ms", 1024, 4096, 512, 300),
                       ("ragged", 37, 4100, 11, 4), ("kv_rows", 16, 1_179_648, 8, 2),
                       ("expert_rows", 32, 2_162_688, 16, 4),
                       ("zero_only", 512, 4096, 0, 64)]
    cases = []
    for label, n_pool, elems, k, z in verified_shapes:
        for spoil in ((False, True) if k else (False,)):
            pool, stage, dst, tags, zero = verified_case(n_pool, elems, k, z)
            if spoil:
                tags[int((tags >= 0).nonzero()[0][-1])] ^= 1
            want = pool.clone()
            v_want = ref.scatter_verified_blocks_(
                want, stage, torch.from_numpy(dst).to(dev),
                torch.from_numpy(tags).to(dev), torch.from_numpy(zero).to(dev))
            v_got = ops.scatter_verified_rows_(pool, stage, dst, tags, zero)
            torch.cuda.synchronize()
            if v_got != v_want or not torch.equal(pool, want):
                fail(f"scatter_verified_rows_ != plain at {label}"
                     f"{' (a tag spoiled)' if spoil else ''}: verdict {v_got} "
                     f"against {v_want}")
            cases.append(label + ("/spoiled" if spoil else ""))
    # timed at the main-path chunk with every row tagged and written
    pool, stage, idx = rows(512, 4096), rows(64, 4096), perm(512, 64)
    tags = ref.fletcher_checksum(stage).cpu().numpy().astype("int64")
    none = idx[:0].astype("int64")
    idx_dev, tags_dev = (torch.from_numpy(a).to(dev) for a in (idx, tags))
    none_dev = torch.from_numpy(none).to(dev)
    verdict = torch.empty(1, dtype=torch.int32, device=dev)

    def verified():
        ops.launch_scatter_verified(pool, stage, idx, tags, none, verdict)

    results["scatter_verified_rows"] = dict(
        shape="pool (512, 4096) uint8, 64 staged rows, all tagged and written",
        max_abs_err=0.0, verified_cases=cases,
        kernel_us=time_us(torch, verified),
        cold=time_cold_us(torch, verified, flush),
        plain_us=time_events_us(torch, lambda: ref.scatter_verified_blocks_(
            pool, stage, idx_dev, tags_dev, none_dev)),
        library_us=time_us(torch, lambda: pool.index_copy_(0, idx_dev, stage)),
        # the rows read and written, the verdict; two sums of one
        # multiply-add each per byte
        bound=bound_us(2 * 64 * 4096 + 8 * 64 + 4, 4 * 64 * 4096))

    # the plain scatter (in place: untouched rows must keep their bytes)
    err = 0.0
    for label, n_pool, elems, k in copy_shapes:
        pool, idx, blocks = rows(n_pool, elems), perm(n_pool, k), rows(k, elems)
        want = pool.clone()
        ref.scatter_blocks_(want, torch.from_numpy(idx).to(dev), blocks)
        ops.scatter_rows_(pool, idx, blocks)
        torch.cuda.synchronize()
        if not torch.equal(pool, want):
            fail(f"scatter_rows_ != plain at {label} {(n_pool, elems, k)}")
        err = max(err, max_err(pool, want))
    pool, idx, blocks = rows(512, 4096), perm(512, 64), rows(64, 4096)
    idx_dev = torch.from_numpy(idx).to(dev)
    results["scatter_rows_"] = dict(
        shape="pool (512, 4096) uint8, 64 rows", max_abs_err=err,
        kernel_us=time_us(torch, lambda: ops.launch_scatter(pool, idx, blocks)),
        cold=time_cold_us(torch, lambda: ops.launch_scatter(pool, idx, blocks), flush),
        plain_us=time_us(torch, lambda: ref.scatter_blocks_(pool, idx_dev, blocks)),
        library_us=time_us(torch, lambda: pool.index_copy_(0, idx_dev, blocks)),
        # the rows read and written, their int32 indices
        bound=bound_us(2 * 64 * 4096 + 4 * 64, 0))

    # zero scan: every third row zero, plus rows zero but for their last
    # byte (the launches of its check: the main path does not call it)
    err, n0 = 0.0, ops.launches["zero"]
    for label, n, elems in row_shapes:
        x = rows(n, elems, zero_every=3)
        if n > 1:
            x[1] = 0
            x[1, -1] = 1
        got, want = ops.zero_rows(x), ref.zero_detect(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"zero_rows != plain at {label} {(n, elems)}")
        err = max(err, max_err(got, want))
    n_zero = ops.launches["zero"] - n0
    x = rows(64, 4096, zero_every=3)
    zout = torch.empty(64, dtype=torch.bool, device=dev)
    results["zero_rows"] = dict(
        shape="(64, 4096) uint8", max_abs_err=err, launches=n_zero,
        kernel_us=time_us(torch, lambda: ops.launch_zero(x, zout)),
        cold=time_cold_us(torch, lambda: ops.launch_zero(x, zout), flush),
        plain_us=time_us(torch, lambda: ref.zero_detect(x)),
        library_us=time_us(torch, lambda: x.any(dim=1)),
        bound=bound_us(64 * 4096 + 64, 64 * 4096))

    # Fletcher tags
    err = 0.0
    for label, n, elems in row_shapes:
        x = rows(n, elems, zero_every=5)
        got = ops.fletcher_rows(x).cpu().numpy()
        want = ref.fletcher_checksum(x).cpu().numpy()
        if not (got == want).all():
            fail(f"fletcher_rows != plain at {label} {(n, elems)}")
        err = max(err, float(abs(got.astype("int64") - want.astype("int64")).max()))
    x = rows(64, 4096)
    fout = torch.empty(64, dtype=torch.uint32, device=dev)
    cold = time_cold_us(torch, lambda: ops.launch_fletcher(x, fout), flush)
    del flush
    results["fletcher_rows"] = dict(
        shape="(64, 4096) uint8", max_abs_err=err, cold=cold,
        kernel_us=time_us(torch, lambda: ops.launch_fletcher(x, fout)),
        plain_us=time_us(torch, lambda: ref.fletcher_checksum(x)),
        library_us=None,
        # two sums of one multiply-add each per byte
        bound=bound_us(64 * 4096 + 4 * 64, 4 * 64 * 4096))

    for name, r in results.items():
        line = {"kernel": name, "shape": r["shape"],
                "equal_to_plain": True, "tolerance": 0,
                "kernel_us": r["kernel_us"], "plain_us": r["plain_us"],
                "bound_us": r["bound"][0], "bound_by": r["bound"][1],
                "library_us": r["library_us"]}
        if "cold" in r:
            line.update(l2_cold_us=r["cold"][0], flush_plus_kernel_us=r["cold"][1],
                        flush_us=r["cold"][2])
        if "launches" in r:
            line["launches_in_this_check"] = r["launches"]
        if "compact_cases" in r:
            line.update(cases=r["compact_cases"],
                        plain_timing="eager, CUDA events (it waits for the card)")
        if "verified_cases" in r:
            line.update(cases=r["verified_cases"],
                        plain_timing="eager, CUDA events (it waits for the card)")
        log(json.dumps(line))
    return results


def check_paged_attention(torch, ops, ref, seed: int) -> dict:
    """Phase 2, paged decode attention: the kernel against its plain
    version within the tolerances of tests/test_kernels.py -- at the serve
    phase's shape (8 sequences, qwen3-4b's 32/8 heads of 128, 64-token
    blocks, 2048 positions, a permuted table, bf16), with lengths from 0
    to 2048, and on the f32/f16 sweep and the reduced configs' f32-over-
    bf16 pair; then timed at kv_len 512 against the plain version and
    ``index_select`` + ``scaled_dot_product_attention``, L2-warm and
    L2-cold, and at each kv_len of ``ATTN_SWEEP`` beside the library
    call, L2-warm."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed + 3)

    def inputs(B, H, KV, hd, bt, mbs, q_dt, pool_dt, lens):
        q = torch.randn((B, H, hd), generator=g).to(q_dt)
        pool = torch.randn((B * mbs, bt, 2, KV, hd), generator=g).to(pool_dt)
        table = torch.randperm(B * mbs, generator=g).to(torch.int32)
        return [q.to(dev), pool.to(dev), table.view(B, mbs).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev)]

    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main_shape = (SERVE_BATCH, 32, 8, 128, 64, SERVE_MAX_SEQ // 64)
    cases = [("main", main_shape, bf16, bf16, [0, 1, 63, 64, 65, 512, 2048, 1000]),
             ("reduced", (2, 4, 2, 32, 8, 4), f32, bf16, [0, 29]),
             ("mqa48", (2, 48, 1, 128, 64, 4), bf16, bf16, [200, 256])]
    for i, (B, H, KV, hd, bt, mbs) in enumerate([(2, 8, 2, 32, 8, 4),
                                                 (1, 4, 4, 64, 16, 2),
                                                 (3, 16, 1, 32, 8, 3)]):
        lens = [0, mbs * bt, bt + 3][:B]
        cases += [(f"sweep{i}_f32", (B, H, KV, hd, bt, mbs), f32, f32, lens),
                  (f"sweep{i}_f16", (B, H, KV, hd, bt, mbs), f16, f16, lens)]
    err = {}
    for label, shape, q_dt, pool_dt, lens in cases:
        args = inputs(*shape, q_dt, pool_dt, lens)
        got = ops.paged_decode_attention(*args)
        want = ref.paged_decode_attention(*args)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[str(q_dt).split(".")[-1]]
        if not e <= tol:
            fail(f"paged_decode_attention differs from plain at {label} "
                 f"{shape} {q_dt}/{pool_dt}: max abs err {e} > {tol}")
        if not torch.equal(got[0], torch.zeros_like(got[0])) and lens[0] == 0:
            fail(f"paged_decode_attention: kv_len 0 did not give zeros at {label}")
        err[label] = e
    log(json.dumps({"paged_attention_check": err}))

    # timing at the serve phase's shape: every sequence at kv_len 512
    # (the kernel table's row), then the sweep, L2-warm, with the library
    # call beside each, and the kv_len 512 row L2-cold
    B, H, KV, hd, bt, mbs = main_shape
    q, pool, table, kv_len = inputs(*main_shape, bf16, bf16, [512] * B)
    out = torch.empty_like(q)

    def library(kv):
        n_blk = -(-kv // bt)
        pos = torch.arange(n_blk * bt, device=dev)
        mask = (pos[None, :] < kv)[:, None, None, :]              # (1,1,1,S)
        idx = table[:, :n_blk].reshape(-1)

        def call():
            kvs = pool.index_select(0, idx).view(B, n_blk * bt, 2, KV, hd)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], kvs[:, :, 0].transpose(1, 2),
                kvs[:, :, 1].transpose(1, 2), attn_mask=mask,
                enable_gqa=True)[:, :, 0]
        return call

    def bound(kv):
        kv_bytes = B * kv * 2 * KV * hd * pool.element_size()
        io_bytes = 2 * q.numel() * q.element_size() + table.numel() * 4 + B * 4
        # q.K and p.V: 4 flops per K/V element and query head, in f32
        return bound_us(kv_bytes + io_bytes, 4 * B * H * kv * hd, FP32_OPS_PER_S)

    lib_err = float((library(512)().float()
                     - ops.paged_decode_attention(q, pool, table, kv_len).float()
                     ).abs().max())
    sweep = {}
    for kv in ATTN_SWEEP:
        lens = torch.full((B,), kv, dtype=torch.int32, device=dev)
        sweep[kv] = dict(
            kernel_us=time_us(torch, lambda: ops.launch_paged_attn(
                q, pool, table, lens, out)),
            library_us=time_us(torch, library(kv)), bound_us=bound(kv)[0])
        log(json.dumps({"paged_attention_kv_len": kv, "l2": "warm", **sweep[kv]}))
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cold = time_cold_us(torch, lambda: ops.launch_paged_attn(
        q, pool, table, kv_len, out), flush)
    lib_cold = time_cold_us(torch, library(512), flush)
    del flush
    r = dict(shape=f"q {tuple(q.shape)} bf16, pool {tuple(pool.shape)} bf16, "
                   f"kv_len 512", max_abs_err=max(err.values()),
             kernel_us=time_us(torch, lambda: ops.launch_paged_attn(
                 q, pool, table, kv_len, out)),
             plain_us=time_us(torch, lambda: ref.paged_decode_attention(
                 q, pool, table, kv_len), inner=10),
             library_us=time_us(torch, library(512)), bound=bound(512))
    log(json.dumps({"kernel": "paged_decode_attention", "shape": r["shape"],
                    "max_abs_err": r["max_abs_err"], "tolerance": ATTN_TOL,
                    "library_max_abs_err": lib_err,
                    "kernel_us": r["kernel_us"], "plain_us": r["plain_us"],
                    "bound_us": r["bound"][0], "bound_by": r["bound"][1],
                    "library_us": r["library_us"], "l2_cold_us": cold[0],
                    "flush_plus_kernel_us": cold[1], "flush_us": cold[2],
                    "library_l2_cold_us": lib_cold[0],
                    "kv_len_sweep_l2_warm": sweep}))
    return {"paged_decode_attention": r}


def compare_old_new(torch, ops, lib_old, seed: int) -> dict:
    """This checkout's kernels against ``lib_old``, a library built from
    earlier sources of ``csrc/swap_kernels.cu``, ``csrc/paged_attention.cu``
    and ``csrc/quantize.cu``, each pair timed in turns -- old, new, new,
    old -- after both versions agree:

    * swap_in_chunk_write, on the host clock, 200 chunks a turn and one
      synchronize at the end: a 64-MP swap-in chunk of 16 extent rows
      and 48 zero rows into a (512, 4096) frame. The earlier flow is the
      earlier ``load_batch`` and partial swap-in: the decoded extent
      copied to the card from pageable memory, Fletcher and a wait for
      the tags, the rows uploaded again, an index upload and a scatter
      into a fresh buffer, an index upload and ``index_fill_`` for the
      zero rows, an index upload and a scatter into the frame. The new
      one: the rows staged in a pinned buffer, one upload, one verified
      scatter, one wait for the verdict;
    * Fletcher at (64, 4096), paged attention at the serve shape (kv_len
      512) and the int8 block quantize at the KV-block shape, device time
      L2-warm;
    * where the earlier sources still have the separate gather and zero
      scan, the swap-out's chunk read as well (gather, zero scan, gather
      of the non-zero rows against one compacting gather)."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed + 11)
    x = torch.randint(0, 256, (64, 4096), generator=g, dtype=torch.uint8).to(dev)
    f_new = torch.empty(64, dtype=torch.uint32, device=dev)
    f_old = torch.empty_like(f_new)
    out = {}

    def stream():          # the current stream (a CUDA graph's, capturing)
        return torch.cuda.current_stream().cuda_stream

    def fletcher_old():
        return lib_old.swap_fletcher_rows(x.data_ptr(), f_old.data_ptr(), 64,
                                          4096, stream())

    frame = torch.randint(0, 256, (512, 4096), generator=g, dtype=torch.uint8)
    frame[::3] = 0
    frame = frame.to(dev)
    idx = torch.randperm(512, generator=g)[:64].numpy()

    B, H, KV, hd, bt, mbs = SERVE_BATCH, 32, 8, 128, 64, SERVE_MAX_SEQ // 64
    q = torch.randn((B, H, hd), generator=g).bfloat16().to(dev)
    pool = torch.randn((B * mbs, bt, 2, KV, hd), generator=g).bfloat16().to(dev)
    table = torch.randperm(B * mbs, generator=g).to(torch.int32).view(B, mbs).to(dev)
    kv_len = torch.full((B,), 512, dtype=torch.int32, device=dev)
    a_new, a_old = torch.empty_like(q), torch.empty_like(q)
    n_split = ops.attn_splits(mbs, bt)
    ws = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32, device=dev)

    def attn_old():
        return lib_old.paged_attn_decode(
            q.data_ptr(), pool.data_ptr(), table.data_ptr(), kv_len.data_ptr(),
            a_old.data_ptr(), ws.data_ptr(), B, H, KV, hd, bt, mbs, B * mbs,
            n_split, 2, 2, hd ** -0.5, stream())

    gq = torch.Generator(device=dev).manual_seed(seed + 12)
    xq = (torch.randn(QUANT_CARD_SHAPE, generator=gq, device=dev) * 4).bfloat16()
    n_mps = QUANT_CARD_SHAPE[0] * QUANT_CARD_MPS
    mp = QUANT_CARD_SHAPE[1] // QUANT_CARD_MPS
    qo, qn = (torch.empty(QUANT_CARD_SHAPE, dtype=torch.int8, device=dev) for _ in "on")
    so, sn = (torch.empty((QUANT_CARD_SHAPE[0], QUANT_CARD_MPS), dtype=torch.float32,
                          device=dev) for _ in "on")

    def quant_old():
        return lib_old.quant_block_quantize(xq.data_ptr(), qo.data_ptr(), so.data_ptr(),
                                            n_mps, mp, 2, stream())

    def quant_new():
        ops.launch_quantize(xq, qn, sn)

    if fletcher_old() or attn_old() or quant_old():
        fail("old-vs-new: a launch of the earlier sources failed")
    ops.launch_fletcher(x, f_new)
    ops.launch_paged_attn(q, pool, table, kv_len, a_new)
    quant_new()
    torch.cuda.synchronize()
    if not torch.equal(f_old, f_new):
        fail("old-vs-new: the two Fletcher kernels disagree")
    if not (torch.equal(qo, qn) and torch.equal(so.view(torch.int32), sn.view(torch.int32))):
        fail("old-vs-new: the two quantize kernels disagree")
    attn_diff = float((a_old.float() - a_new.float()).abs().max())
    if not attn_diff <= ATTN_TOL["bfloat16"]:
        fail(f"old-vs-new: the two paged kernels differ by {attn_diff}")
    pairs = [("fletcher_rows", fletcher_old, lambda: ops.launch_fletcher(x, f_new)),
             ("paged_decode_attention", attn_old,
              lambda: ops.launch_paged_attn(q, pool, table, kv_len, a_new)),
             ("block_quantize", quant_old, quant_new)]

    if has_symbols(lib_old, "swap_gather_rows", "swap_zero_rows"):
        idx_dev = torch.from_numpy(idx).to(dev)
        data = torch.empty((64, 4096), dtype=torch.uint8, device=dev)
        z_old = torch.empty(64, dtype=torch.bool, device=dev)
        need = (frame.cpu()[torch.from_numpy(idx)] != 0).any(dim=1).nonzero()[:, 0].to(dev)
        rows_old = torch.empty((len(need), 4096), dtype=torch.uint8, device=dev)
        meta = torch.empty(4 + 64, dtype=torch.uint8, device=dev)
        rows_new = torch.empty((64, 4096), dtype=torch.uint8, device=dev)

        def chunk_old():
            return (lib_old.swap_gather_rows(frame.data_ptr(), idx_dev.data_ptr(),
                                             data.data_ptr(), 64, 4096, stream())
                    or lib_old.swap_zero_rows(data.data_ptr(), z_old.data_ptr(), 64,
                                              4096, stream())
                    or lib_old.swap_gather_rows(data.data_ptr(), need.data_ptr(),
                                                rows_old.data_ptr(), len(need), 4096,
                                                stream()))

        def chunk_new():
            ops.launch_gather_nonzero(frame, idx, meta, rows_new)

        if chunk_old():
            fail("old-vs-new: a launch of the earlier sources failed")
        chunk_new()
        count = int(meta[:4].cpu().view(torch.int32))
        if not (count == len(need) and torch.equal(rows_new[:count], rows_old)
                and torch.equal(meta[4:].view(torch.bool), z_old)):
            fail("old-vs-new: the chunk reads disagree")
        pairs.insert(0, ("swap_out_chunk_read", chunk_old, chunk_new))
    for name, old, new in pairs:
        turns = [("old", old), ("new", new), ("new", new), ("old", old)]
        times = [(which, time_us(torch, fn)) for which, fn in turns]
        out[name] = {"turns_us": times,
                     "old_us": sum(t for w, t in times if w == "old") / 2,
                     "new_us": sum(t for w, t in times if w == "new") / 2}
    out["paged_decode_attention"]["max_abs_diff"] = attn_diff
    if "swap_out_chunk_read" in out:
        out["swap_out_chunk_read"].update(
            old="gather_rows + zero_rows + gather_rows (non-zero rows)",
            new="gather_nonzero_rows")
    if has_symbols(lib_old, "swap_scatter_rows"):
        out["swap_in_chunk_write"] = swap_in_chunk_write(torch, ops, lib_old, g)
    log(json.dumps({"old_vs_new": out}))
    free_device(torch)
    return out


def has_symbols(lib, *names) -> bool:
    try:
        for name in names:
            getattr(lib, name)
    except AttributeError:
        return False
    return True


def swap_in_chunk_write(torch, ops, lib_old, g, n_chunks: int = 200) -> dict:
    """Host-clock device work of one partial swap-in chunk, the earlier
    flow against the new, in turns (see :func:`compare_old_new`); both
    must leave the same frame first."""
    import numpy as np
    dev = torch.device("cuda")
    n, k, n_data = 4096, 64, 16
    idxs = np.sort(torch.randperm(512, generator=g)[:k].numpy())
    data_pos = np.sort(torch.randperm(k, generator=g)[:n_data].numpy())
    zero_pos = np.setdiff1d(np.arange(k), data_pos)
    ext = torch.randint(0, 256, (n_data, n), generator=g, dtype=torch.uint8).numpy()
    ext_ro = np.frombuffer(ext.tobytes(), dtype=np.uint8).reshape(n_data, n)
    tags = torch.from_numpy(ext).to(dev)
    tags = ops.fletcher_rows(tags).cpu().numpy()
    frames = {w: torch.full((512, n), 0xA5, dtype=torch.uint8, device=dev)
              for w in ("old", "new")}
    f_old = torch.empty(n_data, dtype=torch.uint32, device=dev)
    stage_np = np.empty((n_data, n), dtype=np.uint8)
    data_rows, zero_rows = data_pos.astype(np.int64), zero_pos.astype(np.int64)
    voff = n_data * n
    buf = torch.empty(voff + 16, dtype=torch.uint8, pin_memory=True)
    dev_buf = torch.empty(voff + 16, dtype=torch.uint8, device=dev)
    staged = buf.numpy()[:voff].reshape(n_data, n)
    dst, zero = idxs[data_pos], idxs[zero_pos]
    tag64 = tags.astype(np.int64)
    stream = torch.cuda.current_stream().cuda_stream

    def old():
        frame = frames["old"]
        d = torch.from_numpy(ext_ro.copy()).to(dev)           # the tag check
        if lib_old.swap_fletcher_rows(d.data_ptr(), f_old.data_ptr(), n_data, n, stream):
            fail("old-vs-new: the earlier Fletcher launch failed")
        if (f_old.cpu().numpy() != tags).any():
            fail("old-vs-new: the earlier tag check failed")
        stage_np[:] = ext_ro
        out = torch.empty((k, n), dtype=torch.uint8, device=dev)
        st = torch.from_numpy(stage_np).to(dev)
        i1 = torch.from_numpy(data_rows).to(dev)
        rc = lib_old.swap_scatter_rows(out.data_ptr(), i1.data_ptr(), st.data_ptr(),
                                       n_data, n, stream)
        out.index_fill_(0, torch.from_numpy(zero_rows).to(dev), 0)
        i2 = torch.from_numpy(idxs).to(dev)
        rc = rc or lib_old.swap_scatter_rows(frame.data_ptr(), i2.data_ptr(),
                                             out.data_ptr(), k, n, stream)
        if rc:
            fail("old-vs-new: the earlier scatter launch failed")

    def new():
        staged[:] = ext_ro
        if ops.scatter_staged_rows_(frames["new"], buf, dev_buf, n_data, dst,
                                    tag64, zero) != -1:
            fail("old-vs-new: the verified scatter's tag check failed")

    old()
    new()
    torch.cuda.synchronize()
    if not torch.equal(frames["old"], frames["new"]):
        fail("old-vs-new: the two swap-in chunk writes disagree")

    def per_chunk_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_chunks * 1e6

    times = [(w, per_chunk_us(fn)) for w, fn in
             (("old", old), ("new", new), ("new", new), ("old", old))]
    return {"turns_us": times,
            "old_us": sum(t for w, t in times if w == "old") / 2,
            "new_us": sum(t for w, t in times if w == "new") / 2,
            "clock": "host, per chunk", "chunk": f"{k} MPs: {n_data} extent "
            f"rows, {len(zero_rows)} zero rows, into a (512, {n}) frame",
            "old": "Fletcher + wait, stage upload, 3 index uploads, scatter, "
                   "index_fill_, scatter",
            "new": "one call: pinned upload, verified scatter, verdict back, "
                   "one wait"}


def start_old_build(src_dir: Path):
    """Start one nvcc that builds ``src_dir``'s swap_kernels.cu,
    paged_attention.cu and quantize.cu (earlier versions of this
    checkout's sources) into a library of their own; returns the process
    and the library's path."""
    import atexit
    from repro_torch.kernels import _build
    srcs = [src_dir / "swap_kernels.cu", src_dir / "paged_attention.cu",
            src_dir / "quantize.cu"]
    missing = [str(p) for p in srcs if not p.is_file()]
    if missing:
        fail(f"--compare-sources: missing {missing}")
    out = _build.BUILD_DIR / "compare" / "librepro_torch_kernels_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             "-o", str(out), *map(str, srcs)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def load_old_build(proc, path: Path):
    """Wait for :func:`start_old_build`'s nvcc and load its library; the
    entry points that are gone from this checkout's sources get their
    earlier signatures where the library has them."""
    import ctypes
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    text = proc.communicate()[0]
    if proc.returncode:
        fail(f"--compare-sources: nvcc failed ({proc.returncode}):\n{text}")
    lib = ctypes.CDLL(str(path))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    earlier = {"swap_gather_rows": (vp, vp, vp, i64, i64, vp),
               "swap_zero_rows": (vp, vp, i64, i64, vp),
               "swap_scatter_rows": (vp, vp, vp, i64, i64, vp)}
    for name in ("swap_fletcher_rows", "paged_attn_decode", "quant_block_quantize"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    for name, argtypes in earlier.items():
        if has_symbols(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    log(f"build: earlier sources into {path.name} (waited "
        f"{time.perf_counter() - t0:.1f} s more)")
    return lib


def check_quantize(torch, ops, ref, seed: int) -> dict:
    """Phase 2, the int8 quantize pair: both kernels against their plain
    versions on the card, bit for bit (q, scales, and the dequantized
    values in f32, f16 and bf16) -- at tests/test_kernels.py's sweep in
    f32, f16 and bf16, on an all-zero MP, an MP of -0.0 and an MP of ties
    (absmax exactly 127, so x / scale lands on .5), and at the KV-block
    shape; then timed there. Dequantize's library call is one
    ``torch.mul`` of int8 q by the f32 scales into a bf16 ``out`` (f32
    product, rounded to nearest even on the store), held bit for bit
    against the kernel. No PyTorch call computes quantize's bits
    (``torch.quantize_per_channel`` takes the scales as input), so it has
    no library time. ``launches`` counts the equality checks' launches
    only, read before the timing."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed + 9)
    n0 = {k: ops.launches.get(k, 0) for k in ("quantize", "dequantize")}
    dts = (torch.float32, torch.float16, torch.bfloat16)

    def special():
        x = torch.zeros(2, 3 * 256)
        x[0, 256:512] = -0.0
        ties = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -126.5,
                             126.5, 127.0, -127.0, 0.0])
        x[0, 512:] = ties.repeat(22)[:256]
        x[1] = (ties.flip(0) * 0.25).repeat(64)
        return x

    cases = []
    # tests/test_kernels.py's sweep, then MPs against the quantize
    # kernel's clusters: sixteen blocks held in shared memory (bf16, f16),
    # an MP too large to hold (read twice), odd lengths
    for n, elems, mps in [(2, 512, 4), (4, 1024, 8), (1, 2048, 16), (6, 768, 3),
                          (2, 2 * 800_000, 2), (1, 1 << 21, 1), (2, 3 * 100_003, 3)]:
        x = torch.randn((n, elems), generator=g) * 4
        x[0, :elems // mps] = 0
        cases += [(f"sweep{n}x{elems}/{mps}", x, mps)]
    cases += [("zero/-0.0/ties", special(), 3)]
    for label, x, mps in cases:
        for dt in dts:
            xd = x.to(dt).to(dev)
            q, s = ops.block_quantize(xd, mps)
            pq, ps = ref.block_quantize(xd, mps)
            torch.cuda.synchronize()
            if not (torch.equal(q, pq) and torch.equal(s.view(torch.int32),
                                                       ps.view(torch.int32))):
                fail(f"block_quantize != plain at {label} {dt}")
            for odt in dts:
                d = ops.block_dequantize(q, s, odt)
                if not torch.equal(d.view(torch.uint8),
                                   ref.block_dequantize(pq, ps, odt).view(torch.uint8)):
                    fail(f"block_dequantize != plain at {label} {dt} -> {odt}")
    # the KV-block shape, bf16
    gd = torch.Generator(device=dev).manual_seed(seed + 10)
    x = (torch.randn(QUANT_CARD_SHAPE, generator=gd, device=dev) * 4).bfloat16()
    mps = QUANT_CARD_MPS
    q, s = ops.block_quantize(x, mps)
    pq, ps = ref.block_quantize(x, mps)
    if not (torch.equal(q, pq) and torch.equal(s.view(torch.int32),
                                               ps.view(torch.int32))):
        fail(f"block_quantize != plain at {QUANT_CARD_SHAPE} bf16 (max q "
             f"difference {int((q.int() - pq.int()).abs().max())})")
    d = ops.block_dequantize(q, s, torch.bfloat16)
    if not torch.equal(d.view(torch.uint8),
                       ref.block_dequantize(pq, ps, torch.bfloat16).view(torch.uint8)):
        fail(f"block_dequantize != plain at {QUANT_CARD_SHAPE} bf16")
    launches = {k: ops.launches.get(k, 0) - n0[k] for k in n0}
    del pq, ps
    out = torch.empty_like(x)
    lib_out = torch.empty_like(x)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    n, mp = x.shape[0], x.shape[1] // mps

    def library():
        torch.mul(q.view(n, mps, mp), s.unsqueeze(-1),
                  out=lib_out.view(n, mps, mp))

    library()
    if not torch.equal(lib_out.view(torch.uint8), d.view(torch.uint8)):
        fail(f"library dequantize (torch.mul) != kernel at {QUANT_CARD_SHAPE} bf16")
    del d
    shape = f"{QUANT_CARD_SHAPE} bf16, {mps} MPs of {mp}"
    n_el = x.numel()
    results = {
        "block_quantize": dict(
            shape=shape, max_abs_err=0.0,
            kernel_us=time_us(torch, lambda: ops.launch_quantize(x, q, s)),
            cold=time_cold_us(torch, lambda: ops.launch_quantize(x, q, s), flush),
            plain_us=time_us(torch, lambda: ref.block_quantize(x, mps), inner=10),
            library_us=None,
            # abs, max, divide, round and two clamps per element, in f32
            bound=bound_us(2 * n_el + n_el + 4 * s.numel(), 6 * n_el,
                           FP32_OPS_PER_S)),
        "block_dequantize": dict(
            shape=shape, max_abs_err=0.0,
            kernel_us=time_us(torch, lambda: ops.launch_dequantize(q, s, out)),
            plain_us=time_us(torch, lambda: ref.block_dequantize(
                q, s, torch.bfloat16), inner=10),
            library_us=time_us(torch, library),
            # one multiply per element
            bound=bound_us(n_el + 4 * s.numel() + 2 * n_el, n_el,
                           FP32_OPS_PER_S)),
    }
    for name, counter in (("block_quantize", "quantize"),
                          ("block_dequantize", "dequantize")):
        r = results[name]
        r["launches"] = launches[counter]
        line = {"kernel": name, "shape": r["shape"],
                "equal_to_plain": True, "tolerance": 0,
                "cases": [c[0] for c in cases] + [shape],
                "launches_in_this_check": r["launches"],
                "kernel_us": r["kernel_us"], "plain_us": r["plain_us"],
                "bound_us": r["bound"][0], "bound_by": r["bound"][1],
                "library_us": r["library_us"]}
        if "cold" in r:
            line.update(l2_cold_us=r["cold"][0], flush_plus_kernel_us=r["cold"][1],
                        flush_us=r["cold"][2])
        log(json.dumps(line))
    del x, q, s, out, lib_out, flush
    free_device(torch)
    return results


# ------------------------------------------------------------- main path
def per_ms(now: dict, before: dict, n_ms: int) -> dict:
    return {k: (now[k] - before.get(k, 0)) / n_ms for k in now} if n_ms else {}


def paper_mix_images(np, n_img: int, mps: int, mp: int, seed: int):
    """``n_img`` distinct MS images with the paper's Fig 15c page mix
    (76.79% zero MPs; the rest half one repeated byte, half random,
    shuffled at 16-byte grain: ~48% compressible), made vectorised."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n_img, mps, mp), dtype=np.uint8)
    nz = rng.random((n_img, mps)) >= ZERO_FRACTION
    k = int(nz.sum())
    pages = np.empty((k, mp), dtype=np.uint8)
    pages[:, : mp // 2] = rng.integers(0, 256, (k, 1), dtype=np.uint8)
    pages[:, mp // 2:] = rng.integers(0, 256, (k, mp - mp // 2), dtype=np.uint8)
    order = np.argsort(rng.random((k, mp // 16)), axis=1)
    pages = np.take_along_axis(pages.reshape(k, mp // 16, 16),
                               order[:, :, None], axis=1).reshape(k, mp)
    imgs[nz] = pages
    return imgs.reshape(n_img, mps * mp)


def swap_config(managed: int):
    """The paper's deployment (2 MiB MS, 4 KiB MP, +50% elastic) with
    ``managed`` MSs of guest frames; returns (config, reserved slots)."""
    from repro_torch.core.config import (BackendConfig, HotPathConfig,
                                         SwapConfig, TaijiConfig,
                                         size_mpool_reserve)
    ms_bytes, mps = 2 * 1024 * 1024, 512
    reserve = size_mpool_reserve(ms_bytes, mps, managed, 0.5)
    cfg = TaijiConfig(
        ms_bytes=ms_bytes, mps_per_ms=mps, n_phys_ms=managed + reserve,
        mpool_reserve_ms=reserve, overcommit_ratio=0.5,
        backend=BackendConfig(compression_level=1, extent_max_rows=16,
                              crc_enabled=True),
        swap=SwapConfig(batch_mps=64,
                        hot_path=HotPathConfig(compress_workers=4)))
    return cfg, reserve


def main_path(torch, np, core, ops, managed: int, seed: int):
    from repro_torch.core.virt import NO_PFN

    cfg, reserve = swap_config(managed)
    mps = cfg.mps_per_ms
    n_img = N_IMAGES
    t0 = time.perf_counter()
    images = paper_mix_images(np, n_img, mps, cfg.mp_bytes, seed)
    log(f"main: {n_img} distinct paper-mix MS images in "
        f"{time.perf_counter() - t0:.1f} s")
    s = core.TaijiSystem(cfg, device="cuda")
    frames_gib = s.phys.frames.numel() / 2**30
    log(f"main: frames in HBM {frames_gib:.3f} GiB "
        f"({cfg.n_phys_ms} MSs = {managed} managed + {reserve} reserved slots), "
        f"n_virt_ms {cfg.n_virt_ms}, mpool arena on host "
        f"{s.phys.mpool_arena().nbytes / 2**20:.0f} MiB")
    m, guest = s.metrics, s.guest
    rng = np.random.default_rng(seed + 1)
    want = {}                                  # gfn -> image index
    phases = {}

    ops.reset_launches()
    # 1. fill to 1.4x managed physical: the allocation path reclaims
    t0 = time.perf_counter()
    for i in range(int(1.4 * managed)):
        g = guest.alloc_ms()
        guest.write(g, images[i % n_img])
        want[g] = i % n_img
    torch.cuda.synchronize()
    phases["fill_s"] = time.perf_counter() - t0
    out0, msout0, l0 = m.mp_swapped_out, m.ms_swapped_out, dict(ops.launches)
    # ... then step background rounds until the reclaim episode ends: back
    # above the low watermark and up to high, where the hysteresis stops
    # it -- so the fault and swap-in phases below start with the room for
    # their 2 x 1024 MSs and measure no synchronous reclaim
    t0 = time.perf_counter()
    steps = 0
    while s.phys.free_count < s.watermark.high_ms:
        s.step_background()
        steps += 1
        if steps > 100_000:
            fail("reclaim did not get back to the high watermark")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    phases.update(reclaim_s=dt, reclaim_steps=steps,
                  swap_out_mp_per_s=(m.mp_swapped_out - out0) / dt,
                  launches_per_ms_swapped_out=per_ms(
                      ops.launches, l0, m.ms_swapped_out - msout0))
    log(f"main: filled {len(want)} MSs in {phases['fill_s']:.1f} s; reclaim "
        f"{steps} steps, {m.mp_swapped_out - out0} MPs in {dt:.1f} s; "
        f"free {s.phys.free_count} (low {s.watermark.low_ms}, "
        f"high {s.watermark.high_ms})")

    # 1024 fully swapped MSs each for the passive and the active phase
    # (fewer when a cut-down run swapped out fewer than 2048)
    swapped = [g for g in want if int(s.virt.table.pfn[g]) == NO_PFN]
    n_each = min(1024, len(swapped) // 2)
    if n_each < 1:
        fail(f"only {len(swapped)} fully swapped MSs after reclaim")
    pick = rng.choice(len(swapped), size=2 * n_each, replace=False)
    passive = [swapped[i] for i in pick[:n_each]]
    active = [swapped[i] for i in pick[n_each:]]

    # 2. passive faults: read 1024 swapped MSs in full, in windows whose
    # latencies all fit the exact reservoir (reset before each window)
    f0, in0 = m.faults, m.mp_swapped_in
    dt, samples = 0.0, []
    for w in range(0, len(passive), PASSIVE_WINDOW_MS):
        m.sync()
        m.reset_fault_latency()
        t0 = time.perf_counter()
        for g in passive[w:w + PASSIVE_WINDOW_MS]:
            if guest.read(g) != images[want[g]].tobytes():
                fail(f"passive read of gfn {g} differs from what was written")
        dt += time.perf_counter() - t0
        hist = m.fault_latency
        if len(hist.samples) != hist.count:
            fail(f"{hist.count} faults in a passive window overflow the "
                 f"{len(hist.samples)}-sample reservoir")
        samples.extend(hist.samples)
    lat = np.sort(np.asarray(samples, dtype=np.int64))
    if not len(lat):
        fail("the passive phase recorded no fault latencies")
    phases.update(passive_s=dt, passive_faults=m.faults - f0,
                  fault_p50_us=float(lat[len(lat) // 2]) / 1e3,
                  fault_p90_us=float(lat[int(0.9 * len(lat))]) / 1e3,
                  fault_under_10us_frac=float((lat < 10_000).mean()),
                  fault_latency_samples=len(lat),
                  passive_mp_per_s=(m.mp_swapped_in - in0) / dt)
    log(f"main: passive {len(passive)} MSs, {m.faults - f0} faults in "
        f"{dt:.1f} s; fault p50 {phases['fault_p50_us']:.2f} us p90 "
        f"{phases['fault_p90_us']:.2f} us")

    # 3. active swap-in: per MS, one verified scatter and one verdict wait
    # a chunk (8), no other scatter, no index upload, and no Fletcher pass
    # on the swap-in side: a cut-down run may reclaim synchronously here,
    # and each swap-out chunk launches one compacting gather and at most
    # one Fletcher pass, so the swap-in's own are those beyond the gathers
    in0, b0 = m.mp_swapped_in, m.swap_in_batches
    l0, x0 = dict(ops.launches), dict(ops.transfers)
    t0 = time.perf_counter()
    for g in active:
        s.engine.swap_in_ms(g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lpm = per_ms(dict(ops.launches), l0, len(active))
    xpm = per_ms(dict(ops.transfers), x0, len(active))
    chunks = (m.swap_in_batches - b0) / len(active)
    want_chunks = mps / cfg.swap.batch_mps
    swap_in_fletcher = max(0.0, lpm.get("fletcher", 0) - lpm.get("gather", 0))
    phases.update(swap_in_s=dt,
                  swap_in_mp_per_s=(m.mp_swapped_in - in0) / dt,
                  launches_per_ms_swapped_in=lpm,
                  transfers_per_ms_swapped_in=xpm,
                  chunks_per_ms_swapped_in=chunks)
    log(f"main: active swap-in {len(active)} MSs, "
        f"{m.mp_swapped_in - in0} MPs in {dt:.1f} s; per MS: {chunks} chunks, "
        f"{lpm.get('scatter_verified', 0)} verified scatters, "
        f"{lpm.get('scatter', 0)} plain scatters, {swap_in_fletcher} Fletcher "
        f"passes on the swap-in side ({lpm.get('fletcher', 0)} in all, "
        f"{lpm.get('gather', 0)} swap-out gathers), {xpm['verdict_wait']} host "
        f"waits, {xpm['index_upload']} index uploads")
    if not (chunks == want_chunks
            and lpm.get("scatter_verified", 0) == want_chunks
            and lpm.get("scatter", 0) == 0 and swap_in_fletcher == 0
            and xpm["verdict_wait"] == want_chunks and xpm["index_upload"] == 0):
        fail(f"active swap-in: per MS {chunks} chunks, launches {lpm}, "
             f"transfers {xpm}; want {want_chunks} chunks, as many verified "
             f"scatters and host waits, no other scatter, no Fletcher pass on "
             f"the swap-in side, no index upload")

    # 4. hv_sched background reclaim under guest reads and writes: the
    # reclaim task launches the kernels from the scheduler's threads. The
    # guest traffic goes to a working set pinned (and swapped in) before
    # hv_sched starts, because the reference's lock-free access fast path
    # races a concurrent swap-out of the same MS (lost writes)
    gfns = list(want)
    hot = [gfns[i] for i in rng.choice(len(gfns), size=min(256, managed // 8),
                                       replace=False)]
    out0, reads, writes = m.mp_swapped_out, 0, 0
    with guest.pin(hot):
        s.start_background()
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 4.0:
                g = hot[int(rng.integers(len(hot)))]
                if rng.random() < 0.5:
                    if guest.read(g) != images[want[g]].tobytes():
                        fail(f"read of gfn {g} under background reclaim differs")
                    reads += 1
                else:
                    j = int(rng.integers(n_img))
                    guest.write(g, images[j])
                    want[g] = j
                    writes += 1
        finally:
            s.stop_background()
    torch.cuda.synchronize()
    phases.update(background_reads=reads, background_writes=writes,
                  background_mp_swapped_out=m.mp_swapped_out - out0)
    log(f"main: background 4 s: {reads} reads, {writes} writes on "
        f"{len(hot)} pinned MSs; {m.mp_swapped_out - out0} MPs reclaimed "
        f"by hv_sched")
    if m.mp_swapped_out == out0:
        fail("hv_sched reclaimed nothing in the background phase")
    launches, transfers = dict(ops.launches), dict(ops.transfers)
    if transfers["index_upload"]:
        fail(f"{transfers['index_upload']} index vectors uploaded on the main "
             f"path; every swap kernel takes its indices by value")
    phases["host_copy_us"] = host_copy_costs(torch, np, s, want, images)
    log(f"main: host copies (median us): {phases['host_copy_us']}")

    # 5. every live MS byte-exact through export_ms
    t0 = time.perf_counter()
    resident_ms = 0
    for g, j in want.items():
        rows, resident = s.export_ms(g)
        resident_ms += bool(resident.all())
        if not np.array_equal(rows.reshape(-1), images[j]):
            fail(f"export of gfn {g} differs from its image")
    phases["verify_s"] = time.perf_counter() - t0
    m.sync()
    counters = {k: getattr(m, k) for k in (
        "ms_swapped_out", "mp_swapped_out", "ms_swapped_in", "mp_swapped_in",
        "faults", "readahead_extents", "crc_checks", "crc_failures")}
    log(f"main: verified {len(want)} live MSs byte-exact in "
        f"{phases['verify_s']:.1f} s ({resident_ms} fully resident)")
    if counters["crc_failures"]:
        fail(f"{counters['crc_failures']} CRC failures on the main path")
    check_swap_launches("main", launches, SWAP_OUT_IN + ("scatter_verified",))
    log(json.dumps({"main_path": {
        "frames_gib": frames_gib, "managed_ms": managed,
        "reserve_ms": reserve, "live_ms": len(want), **phases,
        "counters": counters, "launches": launches, "transfers": transfers}}))
    return s, launches


def host_copy_costs(torch, np, s, want, images, n: int = 200) -> dict:
    """Host-clock medians of the copies the port adds around the device
    frames: a guest read (device-to-host, waits for the stream) and write
    (host-to-device) of one resident, unsplit MS, a 64-byte guest read,
    and the upload of one 64-entry index vector."""
    from repro_torch.core.virt import F_SPLIT, NO_PFN
    table = s.virt.table
    g = next(g for g in want if int(table.pfn[g]) != NO_PFN
             and not int(table.flags[g]) & F_SPLIT)
    img = images[want[g]]
    idx = np.arange(0, 512, 8, dtype=np.int64)

    def median_us(fn):
        times = []
        for _ in range(n):
            t0 = time.perf_counter_ns()
            fn()
            times.append(time.perf_counter_ns() - t0)
        return float(np.median(times)) / 1e3

    def upload():
        torch.from_numpy(idx).to("cuda")
        torch.cuda.synchronize()

    return {"guest_read_2MiB": median_us(lambda: s.guest.read(g)),
            "guest_write_2MiB": median_us(lambda: s.guest.write(g, img)),
            "guest_read_64B": median_us(lambda: s.guest.read(g, 64, off=4096)),
            "index_upload_64": median_us(upload)}


def corruption(torch, np, s, core):
    """Phase 4: flip one stored Fletcher tag; the next load must fail on
    the device-side check, and succeed once the tag is restored."""
    be = s.backend
    with be._ext_lock:
        key, ext = next((k, e) for k, e in be._extents.items()
                        if e.tags is not None)
    gfn = key[0]
    ext.tags[0] ^= 1
    try:
        s.engine.swap_in_ms(gfn)
    except core.CorruptionError as e:
        if "extent tag mismatch" not in str(e):
            fail(f"corruption raised the wrong check: {e}")
        log(f"corrupt: flipped tag of extent {key} -> CorruptionError: {e}")
    else:
        fail("a flipped extent tag was not detected")
    finally:
        ext.tags[0] ^= 1
    s.engine.swap_in_ms(gfn)
    torch.cuda.synchronize()


# ------------------------------------------------------------ hot switch
class Service(threading.Thread):
    """One PCPU's running workload on the plain system: write 16 bytes,
    then read them back, through the system's accessor, walking every MP
    of its own MSs at an offset of its own; one pair every 200 us. Keeps
    each pair's start and latency (ns) and the last payload written at
    each address."""

    def __init__(self, plain, pcpu: int, pfns) -> None:
        super().__init__(daemon=True)
        self.plain, self.pcpu, self.pfns = plain, pcpu, list(pfns)
        self.start_ns, self.lat_ns = array("q"), array("q")
        self.last = {}                       # (pfn, offset in MS) -> payload
        self.errors = []
        self.stop_flag = threading.Event()

    def run(self) -> None:
        try:
            self._loop()
        except Exception as e:          # reported by the phase, which fails
            self.errors.append(repr(e))

    def _loop(self) -> None:
        cfg = self.plain.cfg
        n, i = len(self.pfns), 0
        while not self.stop_flag.is_set():
            p = self.pfns[i % n]
            off = (i // n) % cfg.mps_per_ms * cfg.mp_bytes + 64 + 32 * self.pcpu
            payload = bytes([i % 251 + 1]) * 16
            t0 = time.perf_counter_ns()
            self.plain.write(self.pcpu, p * cfg.ms_bytes + off, payload)
            got = self.plain.read(self.pcpu, p * cfg.ms_bytes + off, 16)
            t1 = time.perf_counter_ns()
            if got != payload:
                self.errors.append(f"pfn {p} offset {off}: read {got!r} "
                                   f"after writing {payload!r}")
                return
            self.last[(p, off)] = payload
            self.start_ns.append(t0)
            self.lat_ns.append(t1 - t0)
            i += 1
            time.sleep(200e-6)


def _latency_us(np, services, lo_ns: int, hi_ns: int) -> dict:
    """p50/p99/max (us) of the services' pairs started in [lo, hi). Copies
    first: a running service cannot grow an array whose buffer is lent."""
    parts = []
    for sv in services:
        start = np.array(sv.start_ns[:], np.int64)
        lat = np.array(sv.lat_ns[:], np.int64)
        k = min(len(start), len(lat))
        parts.append(lat[:k][(start[:k] >= lo_ns) & (start[:k] < hi_ns)])
    lat = np.concatenate(parts)
    if not len(lat):
        return {"ops": 0}
    lat = np.sort(lat) / 1e3
    return {"ops": len(lat), "p50_us": float(lat[len(lat) // 2]),
            "p99_us": float(lat[int(0.99 * (len(lat) - 1))]),
            "max_us": float(lat[-1])}


def hot_switch_phase(torch, np, core, ops, managed: int, seed: int, smi: str):
    """Phase 5: a running plain system with ``managed`` MSs of guest
    frames in HBM is switched into Taiji under its services, its swap
    engine installed and hot-upgraded v1 -> v2 under load, then every MS
    is checked byte for byte."""
    from repro_torch.core.virt import F_SPLIT, NO_PFN

    dev = torch.device("cuda")
    cfg, _ = swap_config(managed)
    images = paper_mix_images(np, N_IMAGES, cfg.mps_per_ms, cfg.mp_bytes, seed + 11)
    dev_images = torch.from_numpy(images).to(dev)
    rng = np.random.default_rng(seed + 12)
    ops.reset_launches()
    out = {}

    # the host OS: every managed frame allocated, identity-mapped, filled
    plain = core.PlainMemorySystem(cfg, device=dev)
    n_pcpu = len(plain.pcpu_locks)
    t0 = time.perf_counter()
    pfns = [plain.alloc_ms() for _ in range(managed)]
    want = {p: i % N_IMAGES for i, p in enumerate(pfns)}
    for i, p in enumerate(pfns):
        plain.write(i % n_pcpu, p * cfg.ms_bytes, images[want[p]])
    torch.cuda.synchronize()
    out["fill_s"] = time.perf_counter() - t0
    svc = [pfns[k * SERVICE_MS:(k + 1) * SERVICE_MS] for k in range(n_pcpu)]
    rest = pfns[n_pcpu * SERVICE_MS:]
    services = [Service(plain, k, svc[k]) for k in range(n_pcpu)]
    for sv in services:
        sv.start()
    try:
        time.sleep(1.0)

        # the switch, under the services
        stamps = {}
        t_sw0 = time.perf_counter_ns()
        system = core.hot_switch(plain, on_stage=lambda c, st: stamps.setdefault(
            (c, st), time.perf_counter_ns()))
        t_sw1 = time.perf_counter_ns()
        time.sleep(1.0)
        t_after = time.perf_counter_ns()
        # the identity map's _free_gfns.remove loop, replayed on a fresh
        # free list of the same size in the same order
        free = list(range(cfg.n_virt_ms - 1, cfg.mpool_reserve_ms - 1, -1))
        t0 = time.perf_counter()
        for p in pfns:
            free.remove(p)
        remove_s = time.perf_counter() - t0
        pauses = [(stamps[(c, "stage2")] - stamps[(c, "stage1")]) / 1e3
                  for c in range(n_pcpu)]
        out.update(
            switch_s=(t_sw1 - t_sw0) / 1e9,
            switch_to_first_stage1_s=(stamps[(0, "stage1")] - t_sw0) / 1e9,
            free_gfns_remove_s=remove_s,
            pcpu_pause_us=pauses, pcpu_pause_max_us=max(pauses),
            service_before=_latency_us(np, services, t_sw0 - 10**9, t_sw0),
            service_across=_latency_us(np, services, t_sw0, t_sw1 + 1),
            service_after=_latency_us(np, services, t_sw1 + 1, t_after))
        log(f"hot-switch: {managed} MSs ({managed * cfg.ms_bytes / 2**30:.0f} GiB) "
            f"filled in {out['fill_s']:.1f} s; switch {out['switch_s']:.3f} s, "
            f"{out['switch_to_first_stage1_s']:.3f} s to the first stage 1 "
            f"(identity map; its _free_gfns.remove loop {remove_s:.3f} s); "
            f"PCPU pause max {out['pcpu_pause_max_us']:.1f} us; service "
            f"pairs before/across/after: {out['service_before']} / "
            f"{out['service_across']} / {out['service_after']}")

        # the engine module, v1: swap out switched MSs through the entry table
        entry = core.EntryOps()
        t0 = time.perf_counter()
        core.install_module(system, entry, core.EngineModule(system))
        out.update(attach_v1_s=time.perf_counter() - t0, records_v1=len(system.reqs))
        m = system.metrics
        scale = min(1.0, managed / HOT_SWITCH_FULL_MS)
        n_v1, n_up = int(V1_SWAP_MS * scale), int(UPGRADE_SWAP_MS * scale)
        order = rng.permutation(len(rest))
        v1_set = [rest[i] for i in order[:n_v1]]
        up_set = [rest[i] for i in order[n_v1:n_v1 + n_up]]
        mp0, t0 = m.mp_swapped_out, time.perf_counter()
        for g in v1_set:
            entry.call("swap_out_ms", g)
        torch.cuda.synchronize()
        out["v1_swap_out_mp_per_s"] = (m.mp_swapped_out - mp0) / (time.perf_counter() - t0)

        # half of each service's MSs swapped out under it (every PCPU
        # quiesced at its stop point), so the services fault from here on
        svc_out = [p for ms in svc for p in ms[:SERVICE_MS // 2]]
        for lock in plain.pcpu_locks:
            lock.acquire()
        try:
            for g in svc_out:
                entry.call("swap_out_ms", g)
        finally:
            for lock in plain.pcpu_locks:
                lock.release()

        # the upgrade, while the services fault and a swapper thread
        # swaps out through the entry table. The swapper leaves 1 ms
        # between calls: EntryOps.swap_all waits for a moment with no call
        # in flight and does not hold new calls back, so back-to-back
        # calls would starve the upgrade (ROADMAP Queue C)
        swap_log = []

        def swapper():
            for g in up_set:
                a = time.perf_counter_ns()
                n = entry.call("swap_out_ms", g)
                swap_log.append((a, time.perf_counter_ns(), n))
                time.sleep(1e-3)
        faults0 = m.faults
        th = threading.Thread(target=swapper, daemon=True)
        th.start()
        deadline = time.perf_counter() + 120
        while len(swap_log) < n_up // 4 and th.is_alive():
            if time.perf_counter() > deadline:
                fail("hot-switch: the swapper thread made no progress")
            time.sleep(0.005)
        module = core.EngineModuleV2(system)
        timed = {}

        def timing(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    timed[name] = time.perf_counter() - t
            return call
        module.attach = timing("attach", module.attach)
        entry.swap_all = timing("swap_all", entry.swap_all)
        t_up0 = time.perf_counter_ns()
        core.hot_upgrade(system, entry, module)
        t_up1 = time.perf_counter_ns()
        th.join(timeout=300)
        if th.is_alive() or len(swap_log) != n_up:
            fail(f"hot-switch: the swapper thread swapped {len(swap_log)} of "
                 f"{n_up} MSs")
        v1 = [r for r in swap_log if r[1] <= t_up1]
        v2 = [r for r in swap_log if r[0] >= t_up1]

        def rate(rows):
            return (sum(r[2] for r in rows) / ((rows[-1][1] - rows[0][0]) / 1e9)
                    if rows else None)
        out.update(
            upgrade_s=(t_up1 - t_up0) / 1e9, attach_v2_s=timed["attach"],
            records_v2=len(system.reqs), swap_all_drain_s=timed["swap_all"],
            upgrade_swapper_mp_per_s_v1=rate(v1), upgrade_swapper_mp_per_s_v2=rate(v2),
            service_faults_across_upgrade=m.faults - faults0,
            service_across_upgrade=_latency_us(np, services, t_up0, t_up1 + 1))
        log(f"hot-switch: v1 attach {out['attach_v1_s']:.4f} s over "
            f"{out['records_v1']} records, swap-out {out['v1_swap_out_mp_per_s']:.0f} "
            f"MP/s; upgrade {out['upgrade_s']:.4f} s (v2 attach "
            f"{out['attach_v2_s']:.4f} s over {out['records_v2']} records, "
            f"swap_all drain {out['swap_all_drain_s'] * 1e3:.2f} ms) under "
            f"{out['service_faults_across_upgrade']} faults; swapper "
            f"{out['upgrade_swapper_mp_per_s_v1']} MP/s under v1, "
            f"{out['upgrade_swapper_mp_per_s_v2']} under v2")
        if entry.call("version") != 2 or system.module_version != 2:
            fail(f"hot-switch: module v{entry.call('version')} after the upgrade")

        # v2 reclaims under pressure: whenever a round reclaims nothing,
        # the switched guest allocates new MSs until free falls below the
        # low watermark. The services' MSs are pinned, as the reference's
        # lock-free access path races a swap-out of the MS it writes
        # (ROADMAP Queue C)
        # (each reclaimed MS is allocated again at most once, so v2
        # reclaims no more than the guest can allocate past the watermark)
        added = {}
        room = len(system._free_gfns) - (system.phys.free_count - system.watermark.low_ms)
        n_v2 = min(int(V2_RECLAIM_MS * scale), room - SERVICE_MS * n_pcpu)
        if n_v2 < 1:
            fail(f"hot-switch: no room for v2 to reclaim ({room} MSs to allocate)")
        out.update(v1_swap_ms=n_v1, upgrade_swap_ms=n_up, v2_room_ms=room,
                   v2_reclaim_target_ms=n_v2)
        with system.guest.pin([p for ms in svc for p in ms]):
            ms0, mp0, rounds, scan_s, dt = m.ms_swapped_out, m.mp_swapped_out, 0, 0.0, 0.0
            n = 0
            while m.ms_swapped_out - ms0 < n_v2:
                while n == 0 and system.phys.free_count >= system.watermark.low_ms:
                    g = system.guest.alloc_ms()
                    added[g] = int(rng.integers(N_IMAGES))
                    system.guest.write(g, images[added[g]])
                t0 = time.perf_counter()
                system.step_background(reclaim=False)       # LRU scans
                t1 = time.perf_counter()
                n = entry.call("reclaim_round")
                torch.cuda.synchronize()
                scan_s, dt = scan_s + t1 - t0, dt + time.perf_counter() - t1
                rounds += 1
                if rounds > 20_000:
                    fail(f"hot-switch: v2 reclaimed {m.ms_swapped_out - ms0} MSs "
                         f"in {rounds} rounds")
        out.update(allocated_after_switch=len(added), v2_room_left_ms=len(system._free_gfns),
                   v2_reclaim_rounds=rounds,
                   v2_reclaim_ms=m.ms_swapped_out - ms0, v2_reclaim_s=dt,
                   v2_lru_scan_s=scan_s,
                   v2_reclaim_mp_per_s=(m.mp_swapped_out - mp0) / dt)
        log(f"hot-switch: v2 reclaimed {out['v2_reclaim_ms']} MSs in {rounds} "
            f"rounds: {dt:.1f} s in reclaim_round ({out['v2_reclaim_mp_per_s']:.0f} "
            f"MP/s), {scan_s:.1f} s in LRU scans; {len(added)} MSs allocated "
            f"after the switch")
    finally:
        for sv in services:
            sv.stop_flag.set()
        for sv in services:
            sv.join(timeout=10)
    errors = [e for sv in services for e in sv.errors]
    if errors or any(sv.is_alive() for sv in services):
        fail(f"hot-switch: service errors {errors[:4]}")

    # every MS byte-exact: resident, unsplit MSs against the images on
    # the device; swapped ones through guest reads (a sample: the faults
    # after the switch) and export_ms; services' MSs hold their last payloads
    m.sync()
    m.reset_fault_latency()
    t0 = time.perf_counter()
    expect = {p: images[j] for p, j in want.items()}
    for sv in services:
        for p in sv.pfns:
            expect[p] = expect[p].copy()
        for (p, off), payload in sv.last.items():
            expect[p][off:off + 16] = np.frombuffer(payload, np.uint8)
    touched = {p for sv in services for p in sv.pfns}
    expect.update({g: images[j] for g, j in added.items()})
    index = {**want, **added}
    table, guest = system.virt.table, system.guest
    sampled = resident = 0
    for g, img in expect.items():
        pfn = int(table.pfn[g])
        if pfn != NO_PFN and not int(table.flags[g]) & F_SPLIT and g not in touched:
            resident += 1
            if not torch.equal(system.phys.ms_view(pfn), dev_images[index[g]]):
                fail(f"hot-switch: resident MS {g} differs from its image")
        elif sampled < FAULT_SAMPLE_MS or g in touched:
            sampled += 1
            if guest.read(g) != img.tobytes():
                fail(f"hot-switch: guest read of MS {g} differs")
        else:
            rows, _ = system.export_ms(g)
            if not np.array_equal(rows.reshape(-1), img):
                fail(f"hot-switch: export of MS {g} differs")
    torch.cuda.synchronize()
    out["verify_s"] = time.perf_counter() - t0
    m.sync()
    fl = m.fault_latency.snapshot()
    launches = dict(ops.launches)
    out.update(verified_ms=len(expect), resident_ms=resident, read_ms=sampled,
               fault_after_switch=fl, crc_failures=m.crc_failures,
               service_ops=sum(len(sv.lat_ns) for sv in services),
               launches=launches, entry_version=entry.call("version"))
    if m.crc_failures:
        fail(f"hot-switch: {m.crc_failures} CRC failures")
    check_swap_launches("hot-switch", launches, SWAP_OUT_IN)
    log(f"hot-switch: verified {len(expect)} MSs byte-exact in "
        f"{out['verify_s']:.1f} s ({resident} resident on the device, "
        f"{sampled} read through the guest: fault p50 {fl['p50_us']:.2f} us "
        f"p90 {fl['p90_us']:.2f} us); {out['service_ops']} service pairs, "
        f"0 errors; module v2; {smi}")
    log(json.dumps({"hot_switch": out}))
    system.close()
    return out


# ----------------------------------------------------------------- serve
def _device_times(torch, prof) -> tuple:
    """(device us of every kernel and copy, of the paged-attention
    kernels, the eight largest entries as [name, us, count]) summed over
    a profiler window; (None, None, []) if the trace holds no device
    time. Only device-side events count: an operator's entry repeats the
    time of the kernels it launched."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(evt.key, float(evt.self_device_time_total), evt.count)
            for evt in prof.key_averages()
            if getattr(evt, "device_type", None) == cuda]
    total = sum(t for _, t, _ in rows)
    attn = sum(t for k, t, _ in rows if "paged_attn" in k)
    top = [[k[:60], t, n] for k, t, n in sorted(rows, key=lambda r: -r[1])[:8]]
    return (total, attn, top) if total > 0 else (None, None, [])


def serve_path(torch, ops, seed: int) -> dict:
    """Phase 5: qwen3-4b decode at full width through ``serve_step``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train.steps import serve_step

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    M.cast_params(model)                      # f32 master -> bf16, once
    cache = M.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ, device="cuda")
    torch.cuda.synchronize()
    pool_gb = cache["kv_pool"].numel() * cache["kv_pool"].element_size() / 1e9
    log(f"serve: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads vocab {cfg.vocab}: "
        f"{n_params / 1e9:.3f} B params ({n_params * 4 / 1e9:.2f} GB f32, "
        f"{n_params * 2 / 1e9:.2f} GB bf16), KV pool {pool_gb:.2f} GB, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cpu").manual_seed(seed + 5)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=g).to("cuda")

    ops.reset_launches()
    t0 = time.perf_counter()
    for t in range(SERVE_PROMPT):    # the reference has no cache-filling prefill
        logits, cache = serve_step(model, prompts[:, t], cache, cfg)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    tok = logits.argmax(-1)
    step_ms, generated = [], [tok]
    t_gen = time.perf_counter()
    for _ in range(SERVE_GEN):
        t0 = time.perf_counter()
        logits, cache = serve_step(model, tok, cache, cfg)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(tok)
    gen_s = time.perf_counter() - t_gen      # the whole decode window
    mean_ms = gen_s / SERVE_GEN * 1e3
    launches = ops.launches.get("paged_attn", 0)
    steps = SERVE_PROMPT + SERVE_GEN
    if launches != cfg.n_layers * steps:
        fail(f"serve: {launches} paged-attention launches in {steps} steps "
             f"of {cfg.n_layers} layers")
    if logits.shape != (SERVE_BATCH, cfg.vocab) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"serve: logits {tuple(logits.shape)} not finite")
    if cache["kv_len"].tolist() != [steps] * SERVE_BATCH:
        fail(f"serve: kv_len {cache['kv_len'].tolist()} after {steps} steps")
    toks = torch.stack(generated, dim=1)
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        fail("serve: a generated token is outside the vocabulary")

    # the step's byte bound: every weight read once (the embedding only
    # for the batch's rows), and each layer's K/V at the mean length
    emb = cfg.vocab * cfg.d_model
    weight_bytes = (n_params - emb + SERVE_BATCH * cfg.d_model) * 2
    mean_len = SERVE_PROMPT + (SERVE_GEN + 1) / 2
    kv_bytes = (cfg.n_layers * SERVE_BATCH * mean_len * 2 * cfg.n_kv_heads
                * cfg.head_dim_ * 2)
    bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    med = sorted(step_ms)[len(step_ms) // 2]

    # device time over 8 profiled decode steps, per step; the shares are
    # of the unprofiled window's mean step (tracing slows the host side)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            logits, cache = serve_step(model, tok, cache, cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    prof_total, prof_attn, prof_top = _device_times(torch, prof)
    if prof_total is None:
        log("serve: the profiler recorded no device time")
    result = {
        "arch": cfg.name, "params": n_params, "batch": SERVE_BATCH,
        "prompt_tokens": SERVE_PROMPT, "new_tokens": SERVE_GEN,
        "prompt_steps_s": prompt_s, "decode_window_s": gen_s,
        "decode_step_ms_mean": mean_ms, "decode_step_ms_median": med,
        "decode_step_ms_min": min(step_ms),
        "tokens_per_s": SERVE_BATCH * SERVE_GEN / gen_s,
        "step_bound_ms": bound_ms, "weight_bytes": weight_bytes,
        "kv_bytes_mean": kv_bytes, "paged_attn_launches": launches,
        "steps": steps,
        "device_us_per_step": (None if prof_total is None
                               else prof_total / 8),
        "device_busy_share": (None if prof_total is None
                              else prof_total / 8 / (mean_ms * 1e3)),
        "paged_attn_us_per_step": (None if prof_attn is None
                                   else prof_attn / 8),
        "paged_attn_share_of_step": (None if prof_attn is None
                                     else prof_attn / 8 / (mean_ms * 1e3)),
        "profiled_step_ms": window_us / 8 / 1e3,
        "device_top_us_8_steps": prof_top}
    log(f"serve: {steps} steps; {SERVE_BATCH} x {SERVE_GEN} tokens in "
        f"{gen_s:.3f} s = {result['tokens_per_s']:.1f} tokens/s, decode step "
        f"{mean_ms:.3f} ms (median {med:.3f}, min {min(step_ms):.3f}) against "
        f"a byte bound of {bound_ms:.3f} ms; {launches} paged-attention "
        f"launches = {cfg.n_layers} x {steps}")
    log(json.dumps({"serve": result}))
    del model, cache, logits
    free_device(torch)
    return result


def serve_parity(torch, ops, seed: int) -> float:
    """Phase 6: reduced qwen3-4b, the same parameters and tokens on the
    card (kernel) and on the CPU (plain version); f32 matrix products in
    full f32 on both."""
    import copy

    from repro_torch.configs.reduce import reduced_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(SERVE_ARCH)
    cpu_model = M.init_params(cfg, seed=seed, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    B, S = 4, 24
    g = torch.Generator(device="cpu").manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    c_cpu = M.init_cache(cfg, B, S, device="cpu")
    c_gpu = M.init_cache(cfg, B, S, device="cuda")
    ops.reset_launches()
    worst = 0.0
    for t in range(S):
        l_cpu, c_cpu = M.decode_step(cpu_model, cfg, toks[:, t], c_cpu)
        l_gpu, c_gpu = M.decode_step(gpu_model, cfg, toks[:, t].cuda(), c_gpu)
        l_gpu = l_gpu.cpu()
        worst = max(worst, float((l_gpu - l_cpu).abs().max()
                                 / l_cpu.abs().max()))
    launches = ops.launches.get("paged_attn", 0)
    if launches != cfg.n_layers * S:
        fail(f"serve-parity: {launches} launches, expected {cfg.n_layers * S}")
    if not worst < 2e-3:
        fail(f"serve-parity: card vs CPU logits differ by relative {worst}")
    pool_err = float((c_gpu["kv_pool"].cpu().float()
                      - c_cpu["kv_pool"].float()).abs().max())
    log(json.dumps({"serve_parity": {
        "arch": cfg.name + " (reduced)", "batch": B, "steps": S,
        "logits_max_rel_err": worst, "tolerance": 2e-3,
        "kv_pool_max_abs_err": pool_err, "paged_attn_launches": launches}}))
    del gpu_model, c_gpu
    free_device(torch)
    return worst


def elastic_kv(torch, ops, seed: int) -> dict:
    """Phase 7: the serving driver with qwen3-4b's KV geometry, frames in
    HBM. The default traffic of launch/serve.py (24 sequences, 30 turns of
    batch 4, prompt 24, gen 8) fills ~33 blocks of 64 tokens: under its 48
    physical blocks nothing would be reclaimed, so 24 physical blocks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving

    ops.reset_launches()
    t0 = time.perf_counter()
    stats = run_serving(get_config(SERVE_ARCH), n_seqs=24, phys_blocks=24,
                        turns=30, batch=4, prompt_len=24, gen_len=8,
                        seed=seed, device="cuda", verify=True)
    dt = time.perf_counter() - t0
    launches = {k: ops.launches.get(k, 0) for k in SWAP_COUNTERS}
    m, res = stats["metrics"], stats["residency"]
    if m["ms_swapped_out"] <= 0:
        fail("elastic-kv: no KV block was swapped out")
    if m["crc_failures"]:
        fail(f"elastic-kv: {m['crc_failures']} CRC failures")
    if stats["verified_blocks"] != res["total_blocks"]:
        fail(f"elastic-kv: read back {stats['verified_blocks']} of "
             f"{res['total_blocks']} blocks")
    check_swap_launches("elastic-kv", launches, SWAP_OUT)
    out = {"seconds": dt, "residency": res,
           "verified_blocks": stats["verified_blocks"],
           "launches": launches, **{k: m[k] for k in (
               "ms_swapped_out", "mp_swapped_out", "mp_swapped_in", "faults",
               "zero_mps", "compressed_mps", "compression_ratio", "crc_failures")},
           "fault_latency": m["fault_latency"]}
    log(json.dumps({"elastic_kv": out}))
    free_device(torch)
    return out


def elastic_serving(torch, ops, seed: int) -> dict:
    """Phase 9: the elastic-serving flow (``repro_torch.examples.
    elastic_serving.run``) with qwen3-4b's KV geometry, frames in HBM and
    hv_sched in the background; the swap engine is hot-upgraded v1 -> v2
    at turn 20 of 40 under load. 24 physical blocks, not the example's 48:
    its traffic needs ~48 blocks of 64 tokens, so 48 would barely
    reclaim (as the elastic-KV phase)."""
    from repro_torch.configs import get_config
    from repro_torch.examples.elastic_serving import run

    log("elastic-serving: qwen3-4b KV geometry (9 MiB MS per 64-token "
        "block), 24 physical blocks (the example's default 48, cut)")
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = run(get_config(SERVE_ARCH), phys_blocks=24, device="cuda", seed=seed)
    dt = time.perf_counter() - t0
    launches = {k: ops.launches.get(k, 0) for k in SWAP_COUNTERS}
    m = stats["metrics"]
    if stats["entry_version"] != 2 or stats["module_version"] != 2:
        fail(f"elastic-serving: module v{stats['entry_version']} at the end")
    if m["ms_swapped_out"] <= 0:
        fail("elastic-serving: no MS was swapped out")
    if m["crc_failures"]:
        fail(f"elastic-serving: {m['crc_failures']} CRC failures")
    check_swap_launches("elastic-serving", launches, SWAP_OUT)
    out = {"seconds": dt, "module_version": stats["entry_version"],
           "upgrade_turn": stats["upgrade_turn"], "residency": stats["residency"],
           "launches": launches, **{k: m[k] for k in (
               "ms_swapped_out", "mp_swapped_out", "mp_swapped_in", "faults",
               "compression_ratio", "crc_failures")},
           "fault_latency": m["fault_latency"]}
    log(json.dumps({"elastic_serving": out}))
    free_device(torch)
    return out


def expert_cache_phase(torch, np, core, ops, seed: int) -> dict:
    """Phase 10: the elastic expert cache at deepseek-moe-16b's full expert
    width. One ElasticExpertCache per MoE layer over one GuestSpace whose
    frames hold half the experts; each round routes every layer (note
    the routing, swap in and pin its active set, gather it) and checks
    every gathered expert bit for bit against the weights last put, then
    reads one random expert unpinned (a swapped one faults back in) and
    steps the background (LRU aging, reclaim)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.core.config import BackendConfig, HotPathConfig, SwapConfig
    from repro_torch.core.virt import NO_PFN

    arch = get_config(EXPERT_ARCH)
    moe = arch.moe
    shape = (3, arch.d_model, moe.d_ff_expert)   # w_gate, w_up, w_down^T
    dtype = np.dtype(arch.param_dtype)
    n_exp, top_k, n_layers = moe.n_routed, moe.top_k, EXPERT_LAYERS
    n_all = n_layers * n_exp
    expert_bytes = int(np.prod(shape)) * dtype.itemsize
    cfg = core.make_expert_taiji_config(
        expert_bytes, n_all // 2, n_all,
        backend=BackendConfig(extent_max_rows=EXPERT_EXTENT_ROWS),
        swap=SwapConfig(hot_path=HotPathConfig(compress_workers=EXPERT_ZLIB_WORKERS)))
    workers = ThreadPoolExecutor(8)

    def draw(key, scale):
        x = np.random.default_rng(key).standard_normal(shape, dtype=np.float32)
        x *= scale
        return x.astype(dtype, copy=False)

    def same(got, want) -> bool:
        return np.array_equal(got.view(np.uint32), want.view(np.uint32))

    t0 = time.perf_counter()
    weights = [list(workers.map(lambda e, layer=layer: draw([seed, layer, e], 0.02),
                                range(n_exp))) for layer in range(n_layers)]
    gen_s = time.perf_counter() - t0
    # what the backend's zlib does with such weights, on the host
    mp = weights[0][0].reshape(-1).view(np.uint8)[: cfg.mp_bytes].tobytes()
    t0 = time.perf_counter()
    blob = zlib.compress(mp, cfg.backend.compression_level)
    zlib_s = time.perf_counter() - t0
    rng = np.random.default_rng([seed, 1])
    ranks = 1.0 / np.arange(1, n_exp + 1) ** EXPERT_ZIPF
    pops = []
    for _ in range(n_layers):                   # a popularity order per layer
        p = np.empty(n_exp)
        p[rng.permutation(n_exp)] = ranks / ranks.sum()
        pops.append(p)
    log(f"expert-cache: {EXPERT_ARCH} x {n_layers} MoE layers, {n_all} experts "
        f"of {shape} {dtype} ({expert_bytes} B, {cfg.mps_per_ms} MPs of "
        f"{cfg.mp_bytes} B), {cfg.n_phys_ms - cfg.mpool_reserve_ms} in HBM; "
        f"weights drawn in {gen_s:.1f} s")

    s = core.TaijiSystem(cfg, device="cuda")
    try:
        space = s.guest
        caches = [core.ElasticExpertCache(space, n_exp, shape, dtype)
                  for _ in range(n_layers)]
        ops.reset_launches()
        t0 = time.perf_counter()
        for layer, cache in enumerate(caches):
            for e, w in enumerate(weights[layer]):
                cache.put_expert(e, w)
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        dispatch_ms, n_active, mismatches = [], [], 0
        t0 = time.perf_counter()
        try:
            for r in range(EXPERT_ROUNDS):
                for layer, cache in enumerate(caches):
                    active = sorted({int(e) for _ in range(EXPERT_TOKENS)
                                     for e in rng.choice(n_exp, top_k, replace=False,
                                                         p=pops[layer])})
                    cache.note_routing(active)
                    t1 = time.perf_counter()
                    with cache.prepare_dispatch(active):
                        got = cache.get_experts(active)
                        dispatch_ms.append((time.perf_counter() - t1) * 1e3)
                    n_active.append(len(active))
                    mismatches += sum(not same(got[i], weights[layer][e])
                                      for i, e in enumerate(active))
                    del got
                    if r % EXPERT_UPDATE_EVERY == EXPERT_UPDATE_EVERY - 1:
                        new = list(workers.map(
                            lambda e, layer=layer, r=r: weights[layer][e]
                            + draw([seed, layer, e, r], 0.01), active))
                        for e, w in zip(active, new):
                            weights[layer][e] = w
                            cache.put_expert(e, w)
                # one expert read unpinned: its swapped MPs fault back in
                layer, e = int(rng.integers(n_layers)), int(rng.integers(n_exp))
                mismatches += not same(caches[layer].get_expert(e), weights[layer][e])
                space.step_background(2)
                if (r + 1) % EXPERT_UPDATE_EVERY == 0:
                    log(f"expert-cache: round {r + 1}/{EXPERT_ROUNDS} at "
                        f"{time.perf_counter() - t0:.1f} s, {s.metrics.ms_swapped_out} "
                        f"experts out, {s.metrics.ms_swapped_in} in")
        except core.PinnedError as exc:
            fail(f"expert-cache: {exc}")
        torch.cuda.synchronize()
        rounds_s = time.perf_counter() - t0
        launches = {k: ops.launches.get(k, 0) for k in SWAP_COUNTERS}
        m = s.stats()["metrics"]
        hot_res, cold_res = [], []
        for cache in caches:
            order = np.argsort(-cache.route_counts, kind="stable")
            res = [int(s.virt.table.pfn[cache._view_of(int(e)).gfn]) != NO_PFN
                   for e in order]
            hot_res += res[:EXPERT_HOT]
            cold_res += res[EXPERT_HOT:]
    finally:
        s.close()
        workers.shutdown()
    if mismatches:
        fail(f"expert-cache: {mismatches} experts read back different from "
             f"the weights last put")
    if m["crc_failures"]:
        fail(f"expert-cache: {m['crc_failures']} CRC failures")
    if m["ms_swapped_out"] <= 0 or m["ms_swapped_in"] <= 0:
        fail("expert-cache: no expert was swapped out and back in")
    check_swap_launches("expert-cache", launches, SWAP_OUT_IN + ("scatter_verified",))
    out = {
        "arch": EXPERT_ARCH, "layers": n_layers, "experts": n_all,
        "expert_shape": list(shape), "dtype": str(dtype), "expert_bytes": expert_bytes,
        "mps_per_expert": cfg.mps_per_ms, "mp_bytes": cfg.mp_bytes,
        "experts_in_hbm": cfg.n_phys_ms - cfg.mpool_reserve_ms,
        "rounds": EXPERT_ROUNDS, "update_every": EXPERT_UPDATE_EVERY,
        "update_rounds": EXPERT_ROUNDS // EXPERT_UPDATE_EVERY,
        "backend": {"extent_max_rows": EXPERT_EXTENT_ROWS,
                    "compress_workers": EXPERT_ZLIB_WORKERS},
        "tokens": EXPERT_TOKENS, "top_k": top_k,
        "active_per_layer_mean": float(np.mean(n_active)),
        "weights_drawn_s": gen_s, "put_s": put_s, "rounds_s": rounds_s,
        "dispatch_ms": {"median": float(np.median(dispatch_ms)),
                        "p90": float(np.percentile(dispatch_ms, 90)),
                        "n": len(dispatch_ms)},
        "experts_read_bit_exact": sum(n_active) + EXPERT_ROUNDS,
        "experts_swapped_out": m["ms_swapped_out"], "experts_swapped_in": m["ms_swapped_in"],
        "mp_swapped_out": m["mp_swapped_out"], "mp_swapped_in": m["mp_swapped_in"],
        "faults": m["faults"], "compression_ratio": m["compression_ratio"],
        "crc_failures": m["crc_failures"],
        "resident_share_hot16": float(np.mean(hot_res)),
        "resident_share_rest": float(np.mean(cold_res)),
        "host_zlib_one_mp": {"level": cfg.backend.compression_level,
                             "ratio": len(blob) / len(mp),
                             "mb_per_s": len(mp) / zlib_s / 1e6},
        "launches": launches}
    log(json.dumps({"expert_cache": out}))
    del weights
    free_device(torch)
    return out


def dead_node_frames(torch, cfg) -> dict:
    """A killed node holds no frames on the card, and its recovery boots
    one set: device memory after a kill and a recovery of each of two
    nodes of a 4-node fleet, against one node's frames."""
    import gc

    from repro_torch.fleet.harness import build_fleet

    frames = cfg.n_phys_ms * cfg.ms_bytes
    fleet = build_fleet(FLEET_NODES, 2, cfg, device="cuda")
    try:
        steps = []
        for victim in (1, 2):
            before = torch.cuda.memory_allocated()
            fleet.kill_node(victim)
            killed = torch.cuda.memory_allocated()
            fleet.recover_node(victim)
            gc.collect()
            steps.append({"node": victim, "freed_by_kill": before - killed,
                          "after_recovery": torch.cuda.memory_allocated() - before})
    finally:
        fleet.close()
    for st in steps:
        if st["freed_by_kill"] < frames or st["after_recovery"] > 0:
            fail(f"fleet: a killed node kept its frames ({st}, {frames} B a node)")
    return {"frames_per_node": frames, "kill_recover": steps}


def fleet_phase(torch, np, ops, node_ms: int, seed: int) -> dict:
    """Phase 11: the fleet control plane through the port's
    ``benchmarks/fleet.py``, 4 nodes of the paper's 2 MiB / 4 KiB
    geometry in 2 failure domains, each node's frames in HBM: the paper
    trace and the chaos trace (remote-peer tier on) each replayed twice,
    both captured workloads replayed twice on 2 nodes, and a paper trace
    at the small test size replayed on the CPU and on the card."""
    import gc

    from repro_torch.benchmarks import fleet as bench
    from repro_torch.core.config import small_test_config
    from repro_torch.fleet import paper_trace
    from repro_torch.fleet.harness import first_divergence, replay

    cfg, reserve = swap_config(node_ms)
    log(f"fleet: {FLEET_NODES} nodes x {node_ms} managed MSs (+{reserve} "
        f"reserved) of {cfg.ms_bytes} B, {cfg.mps_per_ms} MPs each, frames in "
        f"HBM ({FLEET_NODES * cfg.n_phys_ms * cfg.ms_bytes / 2**30:.2f} GiB)")
    ops.reset_launches()
    t0 = time.perf_counter()
    paper = bench.run(verbose=False, device="cuda", cfg=cfg, burst=FLEET_PAPER_BURST)
    log(f"fleet: paper trace, {paper['trace_ops']} ops, replayed twice in "
        f"{paper['replay_s']:.1f} s")
    gc.collect()
    base = torch.cuda.memory_allocated()
    chaos = bench.run_chaos(verbose=False, device="cuda", cfg=cfg,
                            burst=FLEET_CHAOS_BURST, migrations=FLEET_MIGRATIONS)
    gc.collect()
    kept = torch.cuda.memory_allocated() - base
    log(f"fleet: chaos trace, {chaos['trace_ops']} ops, replayed twice in "
        f"{chaos['replay_s']:.1f} s; device memory kept after it {kept} B")
    cap = bench.run_capture(verbose=False, device="cuda")
    launches = {k: ops.launches.get(k, 0) for k in SWAP_COUNTERS}
    small = small_test_config()
    lines = paper_trace(seed, small.ms_bytes, small.mps_per_ms, fill_ms=120,
                        burst=600, churn_frees=20).lines()
    on_cpu = replay(lines, cfg=small, device="cpu")
    on_card = replay(lines, cfg=small, device="cuda")
    cross = first_divergence(on_cpu.bytes, on_card.bytes)
    dead = dead_node_frames(torch, cfg)
    dt = time.perf_counter() - t0

    for name, r in (("paper", paper), ("chaos", chaos), ("capture", cap)):
        if r["deterministic"] != 1.0:
            fail(f"fleet: {name} replays differ: {r.get('divergence')}")
        if r["verify_failures"]:
            fail(f"fleet: {name}: {r['verify_failures']} verify failures")
    if paper["upgrade_batches_done"] < 1 or paper["upgrade_aborted"]:
        fail(f"fleet: rolling upgrade: {paper['upgrade_batches_done']} batches, "
             f"aborted {paper['upgrade_aborted']}")
    if chaos["kills"] != 2 or chaos["recovers"] != 2 or chaos["migrations"] < 1:
        fail(f"fleet: chaos: {chaos['kills']} kills, {chaos['recovers']} "
             f"recoveries, {chaos['migrations']} migrations")
    if chaos["remote_puts"] < 1:
        fail("fleet: chaos: the remote-peer tier placed no replica")
    if cross is not None:
        fail(f"fleet: the card's replay differs from the CPU's: {cross}")
    if kept > FLEET_KEPT_SLACK:
        fail(f"fleet: {kept} B of device memory kept after the chaos replays")
    check_swap_launches("fleet", launches, SWAP_OUT_IN + ("scatter_verified",))
    out = {
        "nodes": FLEET_NODES, "domains": 2, "node_managed_ms": node_ms,
        "ms_bytes": cfg.ms_bytes, "mps_per_ms": cfg.mps_per_ms, "seconds": dt,
        "paper": {k: paper[k] for k in (
            "trace_ops", "replay_s", "admitted", "rejected_overcommit",
            "reclaimed_mps", "upgrade_batches_done", "verify_failures", "faults",
            "swap_in_p50_us", "swap_in_p90_us", "swap_in_p99_us",
            "frac_under_10us", "fault_mean_us", "stage_us")},
        "chaos": {k: chaos[k] for k in (
            "trace_ops", "replay_s", "kills", "recovers", "migrations",
            "migration_mps", "ms_replaced", "ms_lost", "verify_failures",
            "remote_puts", "remote_recovered", "remote_rereplicated",
            "remote_dropped", "remote_evicted", "remote_held")},
        "capture": {k: cap[k] for k in (
            "trace_ops", "replay_s", "payload_writes", "payload_reads",
            "verify_failures", "kv_serving_ops", "expert_churn_ops")},
        "cross_device": {"trace_ops": len(lines) - 1, "equal": cross is None},
        "device_memory_kept_after_chaos": kept, "dead_nodes": dead,
        "launches": launches}
    log(json.dumps({"fleet": out}))
    free_device(torch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--managed-ms", type=int, default=2048,
                    help="managed 2 MiB MSs of guest frames in HBM "
                         "(16384 = the paper's 32 GiB)")
    ap.add_argument("--fleet-node-ms", type=int, default=256,
                    help="managed 2 MiB MSs of each of the fleet phase's 4 "
                         "nodes (the paper's node holds 16384)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-sources", type=Path, default=None,
                    help="a directory with earlier swap_kernels.cu, "
                         "paged_attention.cu and quantize.cu: time the "
                         "swap-in's chunk write (host clock), Fletcher, "
                         "paged attention, quantize and, where the earlier "
                         "sources allow, the swap-out's chunk read against "
                         "them, in turns")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.kernels import _build, ops, ref

    # 1. build (the earlier sources, if asked for, beside it)
    t0 = time.perf_counter()
    old_build = (start_old_build(args.compare_sources.resolve())
                 if args.compare_sources else None)
    lib = _build.build(verbose=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # 2. kernels
    timed = check_kernels(torch, ops, ref, args.seed)
    timed.update(check_paged_attention(torch, ops, ref, args.seed))
    timed.update(check_quantize(torch, ops, ref, args.seed))
    if old_build:
        compare_old_new(torch, ops, load_old_build(*old_build), args.seed)
    else:
        log("old-vs-new: not measured (no --compare-sources)")

    # 3. main path, 4. corruption
    s, launches = main_path(torch, np, core, ops, args.managed_ms, args.seed)
    try:
        corruption(torch, np, s, core)
    finally:
        s.close()
    del s
    free_device(torch)

    # 5. hot switch and hot upgrade
    hot_switch_phase(torch, np, core, ops, args.managed_ms, args.seed, smi)
    free_device(torch)

    # 6. serve, 7. serve-parity, 8. elastic-kv, 9. elastic-serving
    served = serve_path(torch, ops, args.seed)
    launches["paged_attn"] = served["paged_attn_launches"]
    serve_parity(torch, ops, args.seed)
    elastic_kv(torch, ops, args.seed)
    elastic_serving(torch, ops, args.seed)

    # 10. expert cache, 11. fleet: their launches join the main paths'
    for phase in (expert_cache_phase(torch, np, core, ops, args.seed),
                  fleet_phase(torch, np, ops, args.fleet_node_ms, args.seed)):
        for k, n in phase["launches"].items():
            launches[k] = launches.get(k, 0) + n

    rows = []
    for name, (counter, replaces, source, path) in KERNELS.items():
        r = timed[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(counter, 0) if path else r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
            "bound_ms": r["bound"][0] / 1e3, "bound_by": r["bound"][1],
            "library_ms": (None if r["library_us"] is None
                           else r["library_us"] / 1e3),
            "main_path": path or "none: launches are its check's own"})
    log(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
