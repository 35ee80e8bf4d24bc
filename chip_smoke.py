#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--managed-ms 1024] [--fleet-node-ms 32]
                          [--bench-ms 512] [--seed 0]

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
                   block), paged attention also at jamba's and qwen2-vl's
                   head groups, paged latent attention (MLA) within its
                   tolerances at the DeepSeek-V2-Lite cell's shape (64
                   sequences, 16 heads of 576 / 512, bf16 and f32);
                   time kernel, plain version and library call,
                   paged attention also at the kv_len of ``ATTN_SWEEP``,
                   paged MLA also at 256, 1024 and the cell's lengths,
                   the swap kernels, paged attention and the quantize pair also
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
                   layer of every step must launch the paged kernel; then,
                   on the same model, phase 12's decode overhead;
7. serve-parity -- reduced qwen3-4b, the same parameters and tokens
                   decoded on the card (kernel) and on the CPU (plain
                   version);
8. elastic-kv   -- ``run_serving`` with qwen3-4b's KV geometry (one 9 MiB
                   MS per 64-token block, frames in HBM) under pressure;
                   every block read back equal to its host mirror;
9. elastic-serving -- the elastic-serving flow with that geometry: the
                   swap engine hot-upgraded v1 -> v2 halfway, under load;
10. expert-cache -- deepseek-moe-16b's routed experts at full width (one
                   34.6 MB MS of 16 MPs per expert), 1 MoE layer of 64,
                   HBM for half: 2 rounds of 8-token decode batches
                   routed top-6 from a Zipf(1.2) popularity, dispatched
                   layer by layer (swap in, pin, gather), the active
                   experts written back updated in the 2nd round, one
                   swapped-out expert read unpinned each round (its MPs
                   fault in), every expert read back bit for bit;
11. fleet       -- 4 nodes of ``--fleet-node-ms`` managed 2 MiB MSs each
                   in HBM, through ``repro_torch.benchmarks.fleet``: the
                   paper trace (rolling hot-upgrade) and the chaos trace
                   (kills, recoveries, live migrations, the remote-peer
                   tier), each replayed twice to equal bytes; both
                   captured workloads replayed twice; one small trace
                   replayed on the CPU and on the card to equal bytes;
                   killed nodes free their frames;
12. bench       -- the paper's benchmarks through ``repro_torch.
                   benchmarks`` at the paper's geometry in HBM: fault
                   latency by the paper's method over ``--bench-ms`` MSs
                   and its scalar reference, the extent sweep, swap
                   throughput, the slot allocator at 128 / 256 / 2048 MSs,
                   LRU accuracy, metadata, overcommit and the backend
                   mix, with the decode overhead of phase 6; every
                   swapping module must launch the compacting gather and
                   Fletcher and no zero scan, elasticity >= 0.5, the
                   backend's zero share within 0.02 of the workload's,
                   and metadata, backend_ratio and lru_accuracy at the
                   reference's sizes equal on the CPU and the card; prints
                   every row beside the paper's figure;
13. train       -- training and prefill of the dense and MoE families:
                   (a) three train steps of reduced qwen3-4b and
                   deepseek-moe-16b (f32) on the card and on the CPU from
                   the same state and batches, within the CPU parity
                   test's tolerances; (b) qwen3-4b at full width cut to 16
                   of 36 layers through ``run_training``, 6 steps of batch
                   4 x 512 (step ms, tokens/s, peak memory, device busy
                   share, FLOP share; the loss must fall), then a
                   64-token prompt through
                   ``prefill_step`` against paged decode; (c) the
                   quickstart's 100M config, a checkpoint at step 10 of
                   20 restored bit for bit into a fresh state and resumed;
                   (d) the elastic MoE training example at deepseek-moe-
                   16b's full width, 4 layers, one step, its first MoE
                   layer's 64 experts in an expert cache with HBM for 32,
                   every expert bit-exact at the end, then paged decode against
                   prefill;
14. families    -- the SSM, hybrid, VLM and audio families: (a) three
                   train steps of each at its reduced config (f32) on the
                   card and on the CPU from the same state and batches,
                   and for the decoder families token-by-token decode
                   against the forward on the card; (b) falcon-mamba-7b
                   at full width and depth (bf16): 8 requests of 256
                   prompt tokens through ``serve_step``, 64 greedy tokens,
                   every position's logits against one forward (decode
                   step ms, tokens/s, byte bound, device busy share,
                   peak memory), then ``run_training`` cut to 16 of 64
                   layers, 3 steps of 4 x 512; (c) one full-width jamba
                   group (8 layers, 4 of its 16 experts), 8 x (200 + 16)
                   decoded against the forward, the paged kernel launched
                   at every step; (d) qwen2-vl-2b at full width, its
                   256-token vision prefix fed as ``input_embeds`` with
                   M-RoPE positions, 4 x 320 decoded against the forward,
                   every layer through the paged kernel; (e)
                   hubert-xlarge at full width, 3 steps of 4 x 1024
                   frames through ``run_training``;
15. mla-serve   -- DeepSeek-V2-Lite at full width cut to 4 of 27 layers
                   (bf16): 64 requests of 256 prompt tokens fed through
                   ``serve_step`` over the latent pool, then 32 greedy
                   tokens; every attention layer of every step must launch
                   the paged MLA kernel and none the GQA kernel (decode
                   step ms, tokens/s, byte bound, device busy share, peak
                   memory).

The last two lines of standard output are the kernel table and the
device line as JSON; the ``{"bench": ...}``, ``{"train": ...}``,
``{"families": ...}`` and ``{"mla_serve": ...}`` lines come before them. No
card, or no ``src/repro_torch`` beside this file: a non-zero exit and no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
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
MLA_SOURCE = "src/repro_torch/csrc/paged_mla.cu"
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
    # the port's own: the TPU package has no latent attention
    "paged_mla_decode": ("paged_mla", "none (no TPU kernel)", MLA_SOURCE,
                         "serve (deepseek-v2-lite)"),
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
# the families' (query heads, KV heads) of 128 that decode through the
# paged kernel: jamba's group of 8, qwen2-vl's of 6 (phase 14)
ATTN_GROUPS = {"jamba-1.5-large-398b": (64, 8), "qwen2-vl-2b": (12, 2)}
# paged latent attention (phases 2 and 15) at the shape of the benchmark's
# DeepSeek-V2-Lite decode cell: 64 sequences over a 1024-position table of
# 64-token blocks, sequence i at context 256 + i when its window opens;
# tests/test_torch_mla.py's kernel tolerances (atol and rtol alike)
MLA_ARCH, MLA_BATCH, MLA_MAX_SEQ, MLA_BT = "deepseek-v2-lite", 64, 1024, 64
MLA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the MLA serve (phase 15): DeepSeek-V2-Lite at full width cut to 4 of its
# 27 layers (layer 0 dense, 3 MoE: 2.25 B parameters), as the families
# phase cuts jamba; the cell's 256-token prompt through serve_step, then
# 32 greedy tokens
MLA_LAYERS, MLA_PROMPT, MLA_GEN = 4, 256, 32
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
# (64 of (3, 2048, 1408) float32 a layer: w_gate, w_up, w_down^T) in 1 of
# its 27 MoE layers, HBM for half of them; each round routes a decode
# batch of 8 tokens top-6 per layer from a Zipf(1.2) popularity and
# dispatches layer by layer; every 2nd round writes the active experts
# back updated (1 update round of 2); the residency of each layer's 16
# most-routed experts is reported against the rest. A round swaps ~45
# experts out and in over 4 layers (23-29 s on the H100's host): 1
# layer and 2 rounds, cut from 4 and 4 for the script's time limit
# (PERF.md §4)
EXPERT_ARCH, EXPERT_LAYERS, EXPERT_ROUNDS = "deepseek-moe-16b", 1, 2
EXPERT_TOKENS, EXPERT_ZIPF, EXPERT_UPDATE_EVERY, EXPERT_HOT = 8, 1.2, 2, 16
# float32 weights compress to ~0.93 under zlib level 1, at ~30 MB/s a
# host core: the expert cache's backend compresses each expert (one MS)
# as 8 streams of 2 MPs on 8 host threads, not as one 34.6 MB stream
EXPERT_EXTENT_ROWS, EXPERT_ZLIB_WORKERS = 2, 8
# the fleet phase: 4 nodes of the paper's geometry in 2 failure domains,
# each node's frames in HBM; the paper trace's and the chaos trace's fault
# bursts and the chaos trace's live migrations. Each trace's front fill
# writes 1.35 (paper) or 1.1 (chaos) times the fleet's managed MSs, MP by
# MP: at 128-MS nodes 390209 + 294950 ops, 236 s for both traces twice on
# the H100's host; at 32-MS nodes (``--fleet-node-ms``) and these bursts,
# cut from 20000 and 6000 for the script's time limit (PERF.md §4)
FLEET_NODES, FLEET_PAPER_BURST, FLEET_CHAOS_BURST, FLEET_MIGRATIONS = 4, 8000, 3000, 8
# device memory the chaos replays may leave allocated (their killed and
# recovered nodes' frames must all be gone; one node's are 100s of MB)
FLEET_KEPT_SLACK = 4 << 20
# the bench phase: the port's benchmark modules at the paper's geometry
# (2 MiB MSs of 512 x 4 KiB, frames in HBM). Managed MSs of the fault
# latency and LRU accuracy runs (``--bench-ms``), of the extent sweep, of
# swap_throughput (its 16 MSs and 4 spare, as the reference's), of the
# slot allocator (the fleet's node sizes and the main path's) and of the
# figure benchmarks; faults a window and in the scalar reference run.
# --bench-ms is at its floor, 512 (1024 before phase 13 came; PERF.md §4)
BENCH_MS, BENCH_SWEEP_MS, BENCH_THROUGHPUT_MS = 512, 32, 20
BENCH_SLOT_MS, BENCH_FIGURE_MS = (128, 256, 2048), 256
BENCH_FAULTS, BENCH_REF_FAULTS = 3000, 1000
# MSs of paper-mix data drawn to time the workload generator
BENCH_MIX_MS = 32
# the decode overhead: the serve phase's model at batch 4 (the module's),
# native/elastic pairs and traced pairs of 30-step windows, each elastic
# window's manager with 512 managed MSs (4 + 2 pairs, the module's smoke
# setting, cut from 8 + 6 for the script's time limit; PERF.md §4)
OVERHEAD_PAIRS, OVERHEAD_TRACED_PAIRS, OVERHEAD_ITERS = 4, 2, 30
OVERHEAD_MANAGER_MS = 512
# the backend mix may stray this far from the workload's zero fraction
BENCH_ZERO_TOL = 0.02
# the paper's figure of a row, as its ``derived`` string carries it
# ("paper=0.7679", "paper_target<10us_p90"); the figures a row's
# ``derived`` lacks, or rounds ("paper~0.47"), are given here
PAPER_IN_DERIVED = re.compile(r"paper(?:_target)?[<>=~][^_]*(?:_p\d+)?")
PAPER_NOT_IN_ROWS = {"lru_cold_ratio": "paper=0.5279",
                     "mpool_utilization": "paper=0.4669"}
# the train phase (13). (a) card-against-CPU parity: reduced qwen3-4b and
# deepseek-moe-16b in f32, attention tiles 32/64, 3 train steps of batch 2
# x 128 tokens, held to tests/test_torch_train.py's tolerances
TRAIN_PARITY_ARCHS, TRAIN_PARITY_STEPS = ("qwen3-4b", "deepseek-moe-16b"), 3
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 128
TRAIN_PARITY_TOL, TRAIN_PARITY_ABS = 1e-5, 2e-5
# (b) qwen3-4b at full width (f32 parameters and AdamW state, bf16
# compute) cut to 16 of 36 layers: its 2.39 B parameters, gradients and
# two moments take 38.3 GB (36 layers: 70.6 GB before activations);
# run_training for 6 steps of batch 4 x 512, remat on, at a tenth of the
# reference's lr 3e-4: with run_training's 1-step warmup, Adam's first
# step at 3e-4 moves every weight by about lr, and the loss at step 6
# stands at 18-25 against 12.5 at step 1 (at 3e-5: 10.8-11.4; 2 seeds,
# tools/prefill_decode_spread.py); the loss at the last step must be
# below step 1's. Then a 64-token prompt at batch 4 through prefill_step
# against serve_step token by token (the paged kernel): last-token
# logits within PREFILL_DECODE_TOL of their largest, here and in (d).
# tests/test_models.py's 2e-3 is for decode against the forward in f32;
# in bf16 the two paths round at different points (prefill rounds
# q*scale, the scores and the probabilities to bf16; the paged kernel
# keeps them in f32). Sound decodes read 2.9e-2 to 3.6e-2 (qwen3-4b as
# initialised and trained at 3e-5) and 1.2e-2 to 5.8e-2 (deepseek-moe-
# 16b); a decode whose kv_len is one short, or that lost one token's K/V
# write, reads 0.32 or more, and a MoE decode without layer0 1.3 or more
# (tools/prefill_decode_spread.py; PERF.md §6)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-4b", 16, 6, 4, 512
TRAIN_LR, PREFILL_BATCH, PREFILL_PROMPT = 3e-5, 4, 64
PREFILL_DECODE_TOL = 1e-1
# the H100 SXM's dense bf16 tensor-core peak (data sheet)
BF16_FLOPS_PER_S = 989e12
# (b)'s roofline row: the same config and batch traced on the meta device
# by the dry run (repro_torch.launch.dryrun, op_count). Its counted FLOPs
# must lie within TRAIN_FLOPS_RATIO of the script's model_flops_per_step,
# which counts attention already: about 4/3 from the per-layer recompute
# (1.22 on the CPU trace); and its larger roofline term (compute or the
# eager, unfused byte count over 3.35 TB/s) may not exceed the measured
# median step. Its memory estimate is reported beside the measured peak
TRAIN_FLOPS_RATIO = (1.0, 1.6)
# (c) checkpoint and resume at the quickstart's 100M config: 20 steps of
# batch 8 x 256, a checkpoint at step 10, steps 11-20 again from it;
# resumed losses within CKPT_LOSS_TOL relative (the embedding's backward
# adds with atomics on the card, so the runs are not bit-equal)
CKPT_STEPS, CKPT_AT, CKPT_BATCH, CKPT_SEQ, CKPT_LOSS_TOL = 20, 10, 8, 256, 1e-2
# (d) the elastic MoE training example at deepseek-moe-16b's full width,
# 4 of 28 layers (layer0 and 3 MoE layers: 2.27 B parameters, 36.3 GB of
# training state): the first MoE layer's 64 routed experts mirrored in an
# expert cache with HBM for 32, phase 10's backend settings; steps of the
# example's batch 4 x 64; then 8 decode steps at batch 4 against
# prefill_step, within PREFILL_DECODE_TOL. All 64 experts are routed
# every step, so each step swaps ~140 experts out and ~140 in
# through host zlib: 55-77 s a step on the H100's host. 1 step, cut from
# 6, 4 and then 2 for the script's time limit, the last two cuts to pay
# for phase 14 (PERF.md §4)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_BATCH, MOE_SEQ, MOE_DECODE = 4, 1, 4, 64, 8
# the families phase (14). (a) card-against-CPU parity of the four
# families at their reduced configs (f32, attention tiles 32/64): three
# train steps of 2 x 128 on each, within TRAIN_PARITY_TOL / _ABS; for
# the three decoder families also token-by-token decode on the card
# against the card's forward at every position, within relative 1e-4
# (tests/test_torch_models.py's f32 decode tolerance; also (b)'s and
# (c)'s f32 readings, below)
FAMILY_ARCHS = ("falcon-mamba-7b", "jamba-1.5-large-398b", "qwen2-vl-2b",
                "hubert-xlarge")
FAMILY_F32_DECODE_TOL = 1e-4
# (b) falcon-mamba-7b at full width and depth (64 layers, d 4096, DI
# 8192, 7.27 B parameters, bf16): 8 requests of 256 prompt tokens through
# serve_step, 64 greedy tokens, then one forward over the 320 tokens
# (chunk 128: the last chunk padded) against the decode's logits at every
# position; then run_training at full width cut to 16 of 64 layers (2.2
# B; f32 weights, gradients and AdamW moments, bf16 compute), 3 steps of
# 4 x 512
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN = "falcon-mamba-7b", 8, 256, 64
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 16, 3, 4, 512
# (c) jamba-1.5-large-398b at full width, one period: a group of 8 layers
# (7 mamba, attention at 4; MLP and MoE FFNs in turn), with 4 of the 16
# routed experts (top-2, the router over the 4 held): one group's 4 MoE
# layers of 16 experts at 8192 x 24576 are 77 GB in bf16; with 4 the
# group is 16.2 B parameters, 32.5 GB. The capacity factor is E / top-k
# (2.0), so that the forward drops no token: decode, one token a
# sequence, never drops, and a dropped token would make the two differ.
# 8 requests of 200 prompt tokens and 16 greedy tokens (chunk 64: 216
# positions, the last chunk padded)
HYBRID_ARCH, HYBRID_EXPERTS, HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN = \
    "jamba-1.5-large-398b", 4, 8, 200, 16
# (d) qwen2-vl-2b at full width (28 layers, 12/2 heads, M-RoPE; f32
# parameters cast once to bf16): 4 requests of the config's 256-token
# vision prefix and 64 text tokens from the pipeline, teacher-forced
# through serve_step (input_embeds over the prefix, mrope_pos at every
# step)
VLM_ARCH, VLM_BATCH, VLM_TEXT = "qwen2-vl-2b", 4, 64
# (e) hubert-xlarge at full width (48 layers, non-causal, frontend 512 ->
# 1280): run_training, 3 steps of 4 x 1024 frames
AUDIO_ARCH, AUDIO_STEPS, AUDIO_BATCH, AUDIO_FRAMES = "hubert-xlarge", 3, 4, 1024
# decode against the forward at every position, relative to the largest
# forward logit, from sound decodes and planted faults
# (tools/prefill_decode_spread.py --families; PERF.md §6). In bf16:
# falcon-mamba 1e-1 (sound 2.3e-2 to 2.4e-2; a conv window not shifted
# 0.87; a lost SSM state, in decode or in a forward chunk, reads as
# sound: at the initial dt ~ 1 each state decays by e^-1 or faster a
# step, and what it carries is below bf16 rounding); qwen2-vl 6e-2
# (sound 3.9e-2 to 4.2e-2; one lost K/V write 7.7e-2 to 1.0e-1, kv_len
# one short 0.25, no M-RoPE ids 0.77); jamba's group not held (None): in
# 88 to 112 of its 1728 positions bf16 rounding sends a token to another
# expert in one of the 4 MoE layers than the forward does (0.69 to
# 0.81; 5.7e-2 to 6.1e-2 where every route agrees). So (b) and (c) also
# decode the same tokens with the weights cast to f32 and f32 compute,
# within FAMILY_F32_DECODE_TOL: sound 3.8e-6 to 4.1e-6 (falcon-mamba)
# and 1.8e-5 to 2.4e-5 (jamba); every fault 9.0e-4 or more
FAMILY_DECODE_TOL = {SSM_ARCH: 1e-1, HYBRID_ARCH: None, VLM_ARCH: 6e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def done(phase: str) -> None:
    log(f"chip_smoke: {phase} done at {time.perf_counter() - T0:.1f} s")


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


def _attn_library(torch, q, pool, table, kv: int):
    """The library call for paged decode attention at every sequence's
    length ``kv``: ``index_select`` of the table's blocks, then
    ``scaled_dot_product_attention`` with GQA."""
    import torch.nn.functional as F
    B, H, hd = q.shape
    _, bt, _, KV, _ = pool.shape
    n_blk = -(-kv // bt)
    pos = torch.arange(n_blk * bt, device=q.device)
    mask = (pos[None, :] < kv)[:, None, None, :]              # (1,1,1,S)
    idx = table[:, :n_blk].reshape(-1)

    def call():
        kvs = pool.index_select(0, idx).view(B, n_blk * bt, 2, KV, hd)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kvs[:, :, 0].transpose(1, 2),
            kvs[:, :, 1].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)[:, :, 0]
    return call


def check_paged_attention(torch, ops, ref, seed: int) -> dict:
    """Phase 2, paged decode attention: the kernel against its plain
    version within the tolerances of tests/test_kernels.py -- at the serve
    phase's shape (8 sequences, qwen3-4b's 32/8 heads of 128, 64-token
    blocks, 2048 positions, a permuted table, bf16), with lengths from 0
    to 2048, and on the f32/f16 sweep and the reduced configs' f32-over-
    bf16 pair; then timed at kv_len 512 against the plain version and
    ``index_select`` + ``scaled_dot_product_attention``, L2-warm and
    L2-cold, and at each kv_len of ``ATTN_SWEEP`` beside the library
    call, L2-warm. The same check and times (kernel, plain version,
    library call, kv_len 512) at the families' head groups of 128,
    ``ATTN_GROUPS``: jamba's 64/8 and qwen2-vl's 12/2."""
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
    main_lens = [0, 1, 63, 64, 65, 512, 2048, 1000]
    cases = [("main", main_shape, bf16, bf16, main_lens),
             ("reduced", (2, 4, 2, 32, 8, 4), f32, bf16, [0, 29]),
             ("mqa48", (2, 48, 1, 128, 64, 4), bf16, bf16, [200, 256])]
    cases += [(arch, (SERVE_BATCH, H, KV, 128, 64, SERVE_MAX_SEQ // 64), bf16,
               bf16, main_lens) for arch, (H, KV) in ATTN_GROUPS.items()]
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
    # call beside each, and the kv_len 512 row L2-cold; then at the
    # families' head groups
    B, H, KV, hd, bt, mbs = main_shape
    q, pool, table, kv_len = inputs(*main_shape, bf16, bf16, [512] * B)
    out = torch.empty_like(q)
    groups = {}
    for arch, (Hg, KVg) in ATTN_GROUPS.items():
        shape = (B, Hg, KVg, hd, bt, mbs)
        a = inputs(*shape, bf16, bf16, [512] * B)
        o = torch.empty_like(a[0])
        kv_bytes = B * 512 * 2 * KVg * hd * 2
        io_bytes = 2 * a[0].numel() * 2 + a[2].numel() * 4 + B * 4
        bnd = bound_us(kv_bytes + io_bytes, 4 * B * Hg * 512 * hd, FP32_OPS_PER_S)
        groups[arch] = dict(
            shape=f"q {tuple(a[0].shape)} bf16, pool {tuple(a[1].shape)} bf16, "
                  f"group {Hg // KVg}, kv_len 512",
            max_abs_err=err[arch],
            kernel_us=time_us(torch, lambda a=a, o=o: ops.launch_paged_attn(*a, o)),
            plain_us=time_us(torch, lambda a=a: ref.paged_decode_attention(*a),
                             inner=10),
            library_us=time_us(torch, _attn_library(torch, *a[:3], 512)),
            bound_us=bnd[0], bound_by=bnd[1])
        del a, o
    log(json.dumps({"paged_attention_groups": groups, "tolerance": ATTN_TOL}))

    def library(kv):
        return _attn_library(torch, q, pool, table, kv)

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


def _mla_library(torch, q, pool, table, kv: int, rank: int, scale: float):
    """The library call for paged MLA decode at every sequence's length
    ``kv``: ``index_select`` of the table's blocks, then
    ``scaled_dot_product_attention`` with the heads as the queries of one
    head over the shared latent rows, whose first ``rank`` values are the
    value."""
    import torch.nn.functional as F
    B, H, W = q.shape
    _, bt, _ = pool.shape
    n_blk = -(-kv // bt)
    mask = (torch.arange(n_blk * bt, device=q.device) < kv)[None, None, None, :]
    idx = table[:, :n_blk].reshape(-1)

    def call():
        rows = pool.index_select(0, idx).view(B, 1, n_blk * bt, W)
        return F.scaled_dot_product_attention(
            q[:, None], rows, rows[..., :rank], attn_mask=mask, scale=scale)[:, 0]
    return call


def check_paged_mla(torch, ops, ref, seed: int) -> dict:
    """Phase 2, paged latent attention (MLA): the kernel against its plain
    version within tests/test_torch_mla.py's tolerances at the
    DeepSeek-V2-Lite cell's shape (64 sequences, 16 heads of 576 / 512, a
    permuted table of 16 blocks of 64 tokens), bf16 and f32, with lengths
    0, 1, partial and whole blocks, one and several 256-position splits,
    1024, and the cell's 256 + i for the rest; then, bf16, timed at kv_len
    512 against the plain version and ``index_select`` +
    ``scaled_dot_product_attention``, L2-warm and L2-cold, and at 256,
    1024 and the cell's lengths beside the library call (the cell's:
    beside none), L2-warm. The bound is the larger of the bytes
    (``ops.paged_mla_cost``'s, with every sequence's latent rows) over
    HBM_BYTES_PER_S and the FLOPs over the tensor cores' bf16 peak."""
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed + 23)
    H, W, R = ops.MLA_SHAPE
    scale = get_config(MLA_ARCH).softmax_scale()
    B, bt, mbs = MLA_BATCH, MLA_BT, MLA_MAX_SEQ // MLA_BT
    n_blocks = B * mbs
    table = torch.randperm(n_blocks, generator=g).to(torch.int32).view(B, mbs).to(dev)
    cell = [256 + i for i in range(B)]
    edges = [0, 1, 37, 63, 64, 65, 255, 256, 257, 600, 1023, 1024]
    lens = edges + cell[len(edges):]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    err, data = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        pool = torch.randn((n_blocks, bt, W), generator=g).to(dev, dt)
        q = torch.randn((B, H, W), generator=g).to(dev, dt)
        got = ops.paged_mla_decode(q, pool, table, kv_len, R, scale).float()
        want = ref.paged_mla_decode(q.float(), pool.float(), table, kv_len, R, scale)
        torch.cuda.synchronize()
        tol = MLA_TOL[name]
        err[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            fail(f"paged_mla_decode differs from plain at B {B}, {name}: max abs "
                 f"err {err[name]} beyond atol = rtol = {tol}")
        if float(got[0].abs().max()) != 0.0:
            fail(f"paged_mla_decode: kv_len 0 did not give zeros ({name})")
        data[name] = (q, pool)
    log(json.dumps({"paged_mla_check": err, "tolerance": MLA_TOL}))

    q, pool = data["bfloat16"]
    del data
    out = torch.empty((B, H, R), dtype=q.dtype, device=dev)

    def launch(kv):
        return lambda: ops.launch_paged_mla(q, pool, table, kv, out, scale)

    def bound(rows):
        flops, nbytes = ops.paged_mla_cost(q, pool, table, 0, R)
        flops += 2 * rows * H * (W + R)
        nbytes += rows * W * pool.element_size()
        return bound_us(nbytes, flops, BF16_FLOPS_PER_S)

    def lengths(ls):
        return torch.tensor(ls, dtype=torch.int32, device=dev)

    sweep = {}
    for label, ls in (("256", [256] * B), ("1024", [1024] * B), ("cell", cell)):
        sweep[label] = dict(
            kernel_us=time_us(torch, launch(lengths(ls))),
            library_us=(None if label == "cell" else time_us(
                torch, _mla_library(torch, q, pool, table, ls[0], R, scale))),
            bound_us=bound(sum(ls))[0])
        log(json.dumps({"paged_mla_kv_len": label, "l2": "warm", **sweep[label]}))
    kv512 = lengths([512] * B)
    lib_err = float((_mla_library(torch, q, pool, table, 512, R, scale)().float()
                     - ops.paged_mla_decode(q, pool, table, kv512, R, scale).float()
                     ).abs().max())
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cold = time_cold_us(torch, launch(kv512), flush)
    del flush
    r = dict(shape=f"q {tuple(q.shape)} bf16, pool {tuple(pool.shape)} bf16, "
                   f"kv_len 512", max_abs_err=err["bfloat16"],
             kernel_us=time_us(torch, launch(kv512)),
             plain_us=time_us(torch, lambda: ref.paged_mla_decode(
                 q, pool, table, kv512, R, scale), inner=10),
             library_us=time_us(torch, _mla_library(torch, q, pool, table, 512,
                                                    R, scale)),
             bound=bound(512 * B))
    log(json.dumps({"kernel": "paged_mla_decode", "shape": r["shape"],
                    "max_abs_err": err, "tolerance": MLA_TOL,
                    "library_max_abs_err": lib_err,
                    "kernel_us": r["kernel_us"], "plain_us": r["plain_us"],
                    "bound_us": r["bound"][0], "bound_by": r["bound"][1],
                    "library_us": r["library_us"], "l2_cold_us": cold[0],
                    "flush_plus_kernel_us": cold[1], "flush_us": cold[2],
                    "kv_len_sweep_l2_warm": sweep}))
    return {"paged_mla_decode": r}


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
            cold=time_cold_us(torch, lambda: ops.launch_dequantize(q, s, out), flush),
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


def serve_path(torch, ops, seed: int) -> tuple:
    """Phase 6: qwen3-4b decode at full width through ``serve_step``;
    returns the result and the model (bf16, on the card)."""
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
    del cache, logits
    free_device(torch)
    return result, model


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
    reads one swapped-out expert unpinned (it faults back in through the
    plain scatter) and steps the background (LRU aging, reclaim)."""
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
                # one swapped-out expert read unpinned: its MPs fault back in
                layer = int(rng.integers(n_layers))
                out_now = [x for x in range(n_exp) if int(s.virt.table.pfn[
                    caches[layer]._view_of(x).gfn]) == NO_PFN]
                e = int(rng.choice(out_now)) if out_now else int(rng.integers(n_exp))
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


def overhead_bench(torch, ops, model) -> dict:
    """Phase 12, the decode overhead (paper Fig 11/12), run right after
    the serve phase on its model: native and manager-live decode windows
    at batch 4 through ``repro_torch.benchmarks.overhead``, each manager
    a system of the paper's geometry in HBM; every step of every window
    must launch the paged kernel in each layer."""
    from repro_torch.benchmarks import overhead
    from repro_torch.benchmarks.workload import Geometry

    cfg = model.cfg
    ops.reset_launches()
    t0 = time.perf_counter()
    r = overhead.run(verbose=False, device="cuda", model=model, cfg=cfg,
                     pairs=OVERHEAD_PAIRS, traced_pairs=OVERHEAD_TRACED_PAIRS,
                     iters=OVERHEAD_ITERS,
                     geometry=Geometry(OVERHEAD_MANAGER_MS))
    dt = time.perf_counter() - t0
    launches = {"paged_attn": ops.launches.get("paged_attn", 0)}
    # 4 warm-up windows, the pairs' 2 windows and the traced pairs' 2,
    # each one step more than its timed steps
    steps = (OVERHEAD_ITERS + 1) * (4 + 2 * OVERHEAD_PAIRS
                                    + 2 * OVERHEAD_TRACED_PAIRS)
    if launches["paged_attn"] != cfg.n_layers * steps:
        fail(f"bench: overhead: {launches['paged_attn']} paged-attention "
             f"launches in {steps} steps of {cfg.n_layers} layers")
    bad = [k for k, v in r.items() if not math.isfinite(v)]
    if bad:
        fail(f"bench: overhead: not finite: {bad}")
    log(f"bench: overhead ({cfg.name} full width, batch {overhead.BATCH}, "
        f"{OVERHEAD_PAIRS} + {OVERHEAD_TRACED_PAIRS} pairs of "
        f"{OVERHEAD_ITERS}-step windows) in {dt:.1f} s: native "
        f"{r['decode_native_ms']:.3f} ms, manager live "
        f"{r['decode_elastic_ms']:.3f} ms, overhead "
        f"{r['decode_overhead']:+.4f} (paper <0.05), tracer "
        f"{r['tracer_overhead']:+.4f}; guest read direct "
        f"{r['host_direct_us']:.2f} us, translated "
        f"{r['host_translated_us']:.2f} us")
    return {"result": r, "rows": overhead.rows_from(r), "seconds": dt,
            "steps": steps, "launches": launches}


def bench_phase(torch, np, ops, bench_ms: int, overhead: dict) -> dict:
    """Phase 12: the port's benchmark modules (``repro_torch.benchmarks``)
    on the card at the paper's geometry (2 MiB MSs of 512 x 4 KiB MPs,
    frames in HBM): fault latency by the paper's method and its scalar
    reference, the extent sweep, swap throughput, the slot allocator at
    three sizes, LRU accuracy, the backend mix, metadata and overcommit;
    with the decode overhead measured after the serve phase, every row of
    every module. The rows that read no clock of metadata, backend_ratio
    and lru_accuracy at the reference's sizes are equal on the CPU and
    the card."""
    from repro_torch.benchmarks import (backend_ratio, code_size,
                                        fault_latency, lru_accuracy, metadata,
                                        overcommit)
    from repro_torch.benchmarks.workload import (ZERO_FRACTION, Geometry,
                                                 paper_mix_ms)

    t_phase = time.perf_counter()
    launches, modules = {k: 0 for k in SWAP_COUNTERS}, {}
    # the workload's host cost: one Python draw per MP, kept so for the
    # reference's bytes; every module's fill pays it
    geo = Geometry(bench_ms)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(BENCH_MIX_MS):
        paper_mix_ms(rng, geo.ms_bytes, geo.mps_per_ms)
    mix_ms = (time.perf_counter() - t0) / BENCH_MIX_MS * 1e3
    log(f"bench: paper_mix_ms, one {geo.ms_bytes} B MS of {geo.mps_per_ms} "
        f"MPs: {mix_ms:.2f} ms of host time")

    def measured(name, needed, fn):
        """``fn()`` with the swap counters at 0; each of ``needed``
        launched, no zero scan."""
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k: ops.launches.get(k, 0) for k in SWAP_COUNTERS}
        modules[name] = {"seconds": time.perf_counter() - t0, "launches": got}
        check_swap_launches(f"bench: {name}", got, needed)
        for k, n in got.items():
            launches[k] += n
        log(f"bench: {name} in {modules[name]['seconds']:.1f} s; launches {got}")
        return out

    fl = fault_latency
    r = measured("fault_latency", SWAP_OUT_IN, lambda: fl.run(
        n_faults=BENCH_FAULTS, verbose=False, device="cuda",
        geometry=geo))
    log(f"bench: {r['faults']} faults a window over {bench_ms} MSs: p50 "
        f"{r['p50_us']:.2f} us p90 {r['p90_us']:.2f} us p99 "
        f"{r['p99_us']:.2f} us, under 10 us {r['frac_under_10us']:.4f} "
        f"(paper 0.9357); by kind (3 windows) "
        f"{ {k: v['count'] for k, v in r['by_kind_merged'].items()} }")
    ref = measured("fault_latency_scalar_ref", SWAP_OUT, lambda: fl.run(
        n_faults=BENCH_REF_FAULTS, verbose=False, fast_path=False,
        readahead=False, device="cuda", geometry=geo))
    sweep = measured("extent_sweep", SWAP_OUT_IN, lambda: fl.extent_sweep(
        verbose=False, device="cuda", geometry=Geometry(BENCH_SWEEP_MS)))
    thr = measured("swap_throughput", SWAP_OUT + ("scatter_verified",),
                   lambda: fl.swap_throughput(
                       verbose=False, device="cuda",
                       geometry=Geometry(BENCH_THROUGHPUT_MS)))
    slots = measured("slot_alloc", (), lambda: {
        n: fl.slot_alloc_bench(verbose=False, device="cuda",
                               geometry=Geometry(n)) for n in BENCH_SLOT_MS})
    rows = overhead["rows"] + fl.rows_from(r, ref, thr, sweep,
                                           slots[BENCH_SLOT_MS[0]])
    fig = Geometry(BENCH_FIGURE_MS)
    rows += measured("metadata", SWAP_OUT, lambda: metadata.rows(
        device="cuda", geometry=fig))
    rows += measured("overcommit", SWAP_OUT, lambda: overcommit.rows(
        device="cuda", geometry=fig))
    rows += measured("lru_accuracy", (), lambda: lru_accuracy.rows(
        device="cuda", geometry=geo))
    rows += measured("backend_ratio", SWAP_OUT, lambda: backend_ratio.rows(
        device="cuda", geometry=fig))
    rows += code_size.rows()

    # the reference's sizes on both devices: every result reads no clock
    cross = {}
    for name, mod in (("metadata", metadata), ("backend_ratio", backend_ratio),
                      ("lru_accuracy", lru_accuracy)):
        on_cpu = mod.run(verbose=False, device="cpu")
        on_card = mod.run(verbose=False, device="cuda")
        if on_card != on_cpu:
            fail(f"bench: {name} differs on the card: {on_card} != {on_cpu}")
        cross[name] = on_card
    if (cross["lru_accuracy"]["precision"], cross["lru_accuracy"]["recall"]) \
            != (1.0, 1.0):
        fail(f"bench: lru_accuracy at the reference's size: {cross['lru_accuracy']}")
    dt = time.perf_counter() - t_phase

    table = {}
    for name, value, derived in rows:
        found = PAPER_IN_DERIVED.search(derived)
        table[name] = {"value": value, "derived": derived,
                       "paper": PAPER_NOT_IN_ROWS.get(
                           name, found and found.group(0))}
    bad = [n for n, row in table.items() if not math.isfinite(row["value"])]
    if bad:
        fail(f"bench: rows not finite: {bad}")
    if table["overcommit_elasticity"]["value"] < 0.5:
        fail(f"bench: elasticity {table['overcommit_elasticity']['value']} < 0.5")
    zero = table["backend_zero_fraction"]["value"]
    if abs(zero - ZERO_FRACTION) > BENCH_ZERO_TOL:
        fail(f"bench: backend zero fraction {zero} is not within "
             f"{BENCH_ZERO_TOL} of the workload's {ZERO_FRACTION}")
    for name, row in table.items():
        if row["paper"]:
            log(f"bench: {name} {row['value']:.6g} ({row['paper']})")
    out = {
        "seconds": dt, "overhead_seconds": overhead["seconds"],
        "paper_mix_ms_host_ms": mix_ms,
        "geometry": {"ms_bytes": 2 << 20, "mps_per_ms": 512,
                     "bench_ms": bench_ms, "sweep_ms": BENCH_SWEEP_MS,
                     "throughput_ms": BENCH_THROUGHPUT_MS,
                     "figure_ms": BENCH_FIGURE_MS},
        "rows": table,
        "fault": {k: r[k] for k in (
            "faults", "p50_us", "p90_us", "p99_us", "mean_us",
            "frac_under_10us", "frac_under_15us", "zero_page_faults",
            "compressed_faults", "fast_path_faults", "readahead_extents",
            "readahead_mps", "compressed_seeded", "window_deltas")},
        "fault_by_kind": r["by_kind_merged"],
        "slot_alloc_us": {n: slots[n] for n in BENCH_SLOT_MS},
        "extent_sweep": sweep, "swap_throughput": thr,
        "overhead": overhead["result"], "overhead_steps": overhead["steps"],
        "cross_device": {"equal": True, **cross},
        "modules": modules, "launches": launches}
    log(json.dumps({"bench": out}))
    free_device(torch)
    return out


# ----------------------------------------------------------------- train
def _copy_state(torch, state, device):
    """A train state's model and moments copied to ``device``."""
    import copy

    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.steps import TrainState
    return TrainState(state.step, copy.deepcopy(state.model).to(device),
                      AdamWState([t.to(device, copy=True) for t in state.opt.mu],
                                 [t.to(device, copy=True) for t in state.opt.nu]))


def train_parity(torch, ops, seed: int, archs, where: str,
                 decode: bool = False) -> dict:
    """Phase 13 (a) and 14 (a): three train steps of each of ``archs`` at
    its reduced config (f32) from the same state and batches on the card
    and on the CPU; loss, grad norm and every parameter within the CPU
    parity test's tolerances. With ``decode``, first, on the initial
    parameters, each decoder's token-by-token decode on the card against
    the card's forward within FAMILY_F32_DECODE_TOL (a near-tie in a
    trained router can send a token elsewhere in one of the two)."""
    import dataclasses

    from repro_torch.configs.reduce import reduced_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.optim import adamw
    from repro_torch.train import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(reduced_config(arch), attn_chunk_q=32,
                                  attn_chunk_kv=64)
        cpu = S.init_train_state(cfg, opt, seed=seed, device="cpu")
        gpu = _copy_state(torch, cpu, "cuda")
        out[arch] = {}
        if decode and cfg.family != "audio":
            # 2 x 30 tokens: a padded chunk, and a MoE capacity of all 60
            # (the forward drops no token, as decode never does)
            b = S.to_device(SyntheticPipeline(cfg, 2, 30, seed=seed + 1).next_batch(),
                            "cuda")
            r, _ = decode_against_forward(torch, ops, gpu.model, cfg, b, 0)
            _check_decode(cfg, r, FAMILY_F32_DECODE_TOL, f"{where}: {arch}")
            out[arch].update(decode_vs_forward_rel_err=r["decode_vs_forward_rel_err"],
                             paged_attn_launches=r["paged_attn_launches"])
        pipe = SyntheticPipeline(cfg, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, seed=seed)
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for _ in range(TRAIN_PARITY_STEPS):
            b = pipe.next_batch()
            cpu, mc = S.train_step(cpu, S.to_device(b, "cpu"), cfg, opt)
            gpu, mg = S.train_step(gpu, S.to_device(b, "cuda"), cfg, opt)
            for k in worst:
                a, g = float(mc[k]), float(mg[k])
                if not (math.isfinite(g) and abs(g - a) <= TRAIN_PARITY_TOL * abs(a)):
                    fail(f"{where}: {arch} {k} {g} on the card, {a} on the CPU")
                worst[k] = max(worst[k], abs(g - a) / abs(a))
        param_err, param_name = 0.0, None
        for (name, pc), pg in zip(cpu.model.named_parameters(), gpu.model.parameters()):
            err = float((pg.detach().cpu() - pc.detach()).abs().max())
            lim = max(TRAIN_PARITY_TOL * float(pc.detach().abs().max()), TRAIN_PARITY_ABS)
            if not err <= lim:
                fail(f"{where}: {arch} {name} differs by {err} (> {lim})")
            if err > param_err:
                param_err, param_name = err, name
        out[arch].update(loss_rel_err=worst["loss"],
                         grad_norm_rel_err=worst["grad_norm"],
                         param_max_abs_err=param_err, param_worst=param_name)
        del cpu, gpu
    free_device(torch)
    return out


def _attn_flops(cfg, layers: int, batch: int, seq: int) -> int:
    """Forward score and value products of every (query, key) pair the
    chunked attention computes (its tiles cover the whole S x S)."""
    return 4 * layers * batch * cfg.n_heads * seq * seq * cfg.head_dim_


def train_full_width(torch, ops, seed: int, smi: str) -> dict:
    """Phase 13 (b): qwen3-4b at full width, TRAIN_LAYERS layers, through
    ``run_training``; then prefill against token-by-token paged decode."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_training
    from repro_torch.train import steps as S

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = run_training(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     lr=TRAIN_LR, ckpt_dir=None, ckpt_every=TRAIN_STEPS,
                     seed=seed, log_every=TRAIN_STEPS, device="cuda")
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    state = r["state"]
    n_params = sum(p.numel() for p in state.model.parameters())
    bad = [i + 1 for i, (lo, g) in enumerate(zip(r["loss"], r["grad_norm"]))
           if not (math.isfinite(lo) and math.isfinite(g))]
    if bad:
        fail(f"train: steps {bad} have a loss or grad norm that is not finite")
    if not r["loss"][-1] < r["loss"][0]:
        fail(f"train: loss {r['loss'][-1]} at step {TRAIN_STEPS} not below "
             f"{r['loss'][0]} at step 1")
    steady = sorted(r["step_ms"][1:])
    med_ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # 6 flops a parameter and token for the matrix products; an untied
    # input embedding is a lookup, not a product
    matmul_params = n_params - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    flops = 6 * matmul_params * tokens + 3 * _attn_flops(cfg, cfg.n_layers,
                                                          TRAIN_BATCH, TRAIN_SEQ)
    # one more step under the profiler: its device time against the
    # unprofiled median step
    batch = S.to_device(r["pipeline"].next_batch(), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, met = S.train_step(state, batch, cfg, r["opt_cfg"])
        float(met["loss"])
        prof_ms = (time.perf_counter() - t1) * 1e3
    dev_us, _, top = _device_times(torch, prof)
    for i, (lo, g) in enumerate(zip(r["loss"], r["grad_norm"])):
        log(f"train: step {i + 1} loss {lo:.4f} grad_norm {g:.4f} "
            f"{r['step_ms'][i]:.1f} ms")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "layers_full": get_config(TRAIN_ARCH).n_layers, "params": n_params,
           "state_gb": n_params * 16 / 1e9, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "remat": True,
           "loss": r["loss"], "grad_norm": r["grad_norm"], "lr": r["lr"],
           "step_ms": r["step_ms"], "step_ms_median_2_6": med_ms,
           "tokens_per_s": tokens / med_ms * 1e3,
           "peak_memory_gb": peak / 1e9, "run_s": run_s,
           "matmul_params": matmul_params, "model_flops_per_step": flops,
           "flop_share_bf16_peak": flops / (med_ms / 1e3) / BF16_FLOPS_PER_S,
           "profiled_step_ms": prof_ms,
           "device_us_per_step": dev_us,
           "device_busy_share": None if dev_us is None else dev_us / (med_ms * 1e3),
           "device_top_us": top}
    log(f"train: {cfg.name} {cfg.n_layers}/{out['layers_full']} layers, "
        f"{n_params / 1e9:.3f} B params ({out['state_gb']:.1f} GB of params, "
        f"grads and moments), batch {TRAIN_BATCH} x {TRAIN_SEQ}: step "
        f"{med_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak {peak / 1e9:.2f} GB, device "
        f"busy {out['device_busy_share']}, {flops / 1e12:.1f} TFLOP a step = "
        f"{out['flop_share_bf16_peak']:.3f} of the bf16 peak; {smi}")
    out["roofline"] = train_roofline(cfg, med_ms, flops, peak, smi)

    # prefill against paged decode, on the trained parameters
    g = torch.Generator(device="cpu").manual_seed(seed + 11)
    prompt = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_PROMPT),
                           generator=g).to("cuda")
    out.update(_prefill_vs_decode(torch, ops, state.model, cfg, prompt,
                                  PREFILL_DECODE_TOL, "train"))
    del state, r, batch, met, prof
    free_device(torch)
    return out


def train_roofline(cfg, med_ms: float, model_flops: float, peak: int,
                   smi: str) -> dict:
    """Phase 13 (b)'s roofline row: (b)'s config and batch counted and
    sized on the meta device by the dry run (on the host, nothing runs on
    the card), held to the measured step."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun, op_count

    shape = ShapeSpec("train_full_width", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    m = dryrun.measure(cfg, shape)
    mem = dryrun.memory_bytes(cfg, shape, m, None)
    terms = op_count.roofline_terms(m["cost"])
    counted = m["cost"].flops
    ratio = counted / model_flops
    bound_s = max(terms["compute_s"], terms["memory_s"])
    row = {"counted_flops": counted, "model_flops_per_step": model_flops,
           "ratio": ratio, "compute_s": terms["compute_s"],
           "memory_s": terms["memory_s"], "dominant": terms["dominant"],
           "measured_step_ms": med_ms, "memory_estimate_gb": mem["total"] / 1e9,
           "measured_peak_gb": peak / 1e9, "trace_s": time.perf_counter() - t0}
    log(f"roofline: {cfg.name} {cfg.n_layers} layers, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: counted {counted:.4e} FLOP, model_flops_per_step "
        f"{model_flops:.4e}, ratio {ratio:.3f}; compute_s {terms['compute_s']:.4f} "
        f"memory_s {terms['memory_s']:.4f} (eager bytes {m['cost'].hbm_bytes:.4e}), "
        f"dominant {terms['dominant']}; measured median step {med_ms:.1f} ms; "
        f"memory estimate {row['memory_estimate_gb']:.2f} GB against measured "
        f"peak {row['measured_peak_gb']:.2f} GB; traced in {row['trace_s']:.1f} s; {smi}")
    lo, hi = TRAIN_FLOPS_RATIO
    if not lo <= ratio <= hi:
        fail(f"roofline: counted FLOPs are {ratio:.3f} x model_flops_per_step, "
             f"outside [{lo}, {hi}]")
    if not bound_s <= med_ms / 1e3:
        fail(f"roofline: the roofline bound {bound_s:.4f} s exceeds the measured "
             f"step {med_ms / 1e3:.4f} s")
    return row


def prefill_decode_err(torch, ops, model, cfg, prompt) -> dict:
    """Last-token logits of ``prefill_step`` against the same prompt fed
    through ``serve_step`` token by token (the paged kernel in every
    attention layer of every step): the largest difference relative to
    the largest logit, the share of equal argmaxes, the paged launches."""
    from repro_torch.models import model as M
    from repro_torch.train import steps as S

    B, T = prompt.shape
    t0 = time.perf_counter()
    want, _ = S.prefill_step(model, {"tokens": prompt}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache = M.init_cache(cfg, B, -(-T // cfg.kv_block_tokens) * cfg.kv_block_tokens,
                         device="cuda")
    ops.reset_launches()
    for t in range(T):
        got, cache = S.serve_step(model, prompt[:, t], cache, cfg)
    want, got = want.float(), got.float()
    finite = bool(torch.isfinite(got).all() & torch.isfinite(want).all())
    return {"prefill_tokens": T, "prefill_batch": B, "prefill_ms": prefill_ms,
            "prefill_vs_decode_rel_err": (float((got - want).abs().max()
                                                / want.abs().max())
                                          if finite else math.inf),
            "argmax_equal": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()),
            "paged_attn_launches": ops.launches.get("paged_attn", 0)}


def _prefill_vs_decode(torch, ops, model, cfg, prompt, tol: float,
                       where: str) -> dict:
    """``prefill_decode_err``, held to ``tol``; every attention layer of
    every decode step must launch the paged kernel."""
    B, T = prompt.shape
    r = prefill_decode_err(torch, ops, model, cfg, prompt)
    if r["paged_attn_launches"] != cfg.n_layers * T:
        fail(f"{where}: {r['paged_attn_launches']} paged-attention launches in "
             f"{T} decode steps of {cfg.n_layers} layers")
    err = r["prefill_vs_decode_rel_err"]
    if not err < tol:
        fail(f"{where}: prefill and paged decode logits differ by relative {err}")
    log(f"{where}: prefill of {B} x {T} tokens in {r['prefill_ms']:.1f} ms; "
        f"last-token logits against {T} paged decode steps: relative {err:.2e} "
        f"(tolerance {tol}), argmax equal {r['argmax_equal']:.2f}")
    return {**r, "tolerance": tol}


def train_checkpoint(torch, seed: int) -> dict:
    """Phase 13 (c): the quickstart's 100M config, 20 steps with a
    checkpoint at step 10, then steps 11-20 again from a fresh state and
    pipeline restored from it."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.examples.quickstart import config_100m
    from repro_torch.optim import adamw
    from repro_torch.train import steps as S

    cfg = config_100m()
    opt = adamw.AdamWConfig(lr=6e-4, total_steps=CKPT_STEPS,
                            warmup_steps=max(1, CKPT_STEPS // 20))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        ckpt = CheckpointManager(str(tmp))
        state = S.init_train_state(cfg, opt, seed=seed, device="cuda")
        pipe = SyntheticPipeline(cfg, CKPT_BATCH, CKPT_SEQ, seed=seed)
        losses, step_ms = [], []
        t0 = time.perf_counter()
        for i in range(CKPT_STEPS):
            t1 = time.perf_counter()
            state, met = S.train_step(state, S.to_device(pipe.next_batch(), "cuda"),
                                      cfg, opt)
            losses.append(float(met["loss"]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if i + 1 == CKPT_AT:
                t1 = time.perf_counter()
                ckpt.save(CKPT_AT, state, pipe.snapshot())
                save_s = time.perf_counter() - t1
                saved = [t.detach().clone() for t in (*state.model.parameters(),
                                                      *state.opt.mu, *state.opt.nu)]
                cursor = pipe.snapshot()
        run_s = time.perf_counter() - t0
        del state
        fresh = S.init_train_state(cfg, opt, seed=seed + 1, device="cuda")
        pipe2 = SyntheticPipeline(cfg, CKPT_BATCH, CKPT_SEQ, seed=seed + 1)
        t1 = time.perf_counter()
        fresh, manifest = ckpt.restore(fresh)
        pipe2.restore(manifest["pipeline"])
        restore_s = time.perf_counter() - t1
        got = [*fresh.model.parameters(), *fresh.opt.mu, *fresh.opt.nu]
        unequal = sum(not torch.equal(a.detach(), b) for a, b in zip(got, saved))
        if len(got) != len(saved) or unequal:
            fail(f"train-ckpt: {unequal} of {len(saved)} restored tensors differ")
        if fresh.step != CKPT_AT or pipe2.snapshot() != cursor:
            fail(f"train-ckpt: restored step {fresh.step}, cursor "
                 f"{pipe2.snapshot()} (saved {CKPT_AT}, {cursor})")
        resumed = []
        for _ in range(CKPT_AT, CKPT_STEPS):
            fresh, met = S.train_step(fresh, S.to_device(pipe2.next_batch(), "cuda"),
                                      cfg, opt)
            resumed.append(float(met["loss"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errs = [abs(a - b) / abs(b) for a, b in zip(resumed, losses[CKPT_AT:])]
    if not all(math.isfinite(x) for x in losses + resumed) or max(errs) > CKPT_LOSS_TOL:
        fail(f"train-ckpt: resumed losses {resumed} against {losses[CKPT_AT:]}")
    if not losses[-1] < losses[0]:
        fail(f"train-ckpt: loss {losses[-1]} at step {CKPT_STEPS} not below "
             f"{losses[0]} at step 1")
    steady = sorted(step_ms[1:])
    out = {"arch": cfg.name, "params": cfg.param_count(), "batch": CKPT_BATCH,
           "seq": CKPT_SEQ, "steps": CKPT_STEPS, "checkpoint_at": CKPT_AT,
           "restored_tensors_bit_equal": len(saved), "loss": losses,
           "resumed_loss": resumed, "resumed_max_rel_err": max(errs),
           "tolerance": CKPT_LOSS_TOL, "step_ms_median": steady[len(steady) // 2],
           "run_s": run_s, "save_s": save_s, "restore_s": restore_s}
    log(f"train-ckpt: {cfg.name} ({out['params'] / 1e6:.1f} M), {CKPT_STEPS} steps "
        f"of {CKPT_BATCH} x {CKPT_SEQ}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"step {out['step_ms_median']:.1f} ms; checkpoint at {CKPT_AT} saved in "
        f"{save_s:.1f} s, restored in {restore_s:.1f} s, {len(saved)} tensors "
        f"bit-equal; resumed losses within relative {max(errs):.2e}")
    del fresh, saved
    free_device(torch)
    return out


def train_elastic_moe(torch, ops, core, seed: int) -> dict:
    """Phase 13 (d): the elastic MoE training example at deepseek-moe-16b's
    full width, MOE_TRAIN_LAYERS layers, its first MoE layer's experts in
    an expert cache with HBM for half of them; then paged decode against
    prefill on the trained model."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import HotPathConfig, SwapConfig
    from repro_torch.examples import elastic_moe_training

    cfg = dataclasses.replace(get_config(EXPERT_ARCH), n_layers=MOE_TRAIN_LAYERS)
    free_device(torch)
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        r = elastic_moe_training.run(
            cfg, steps=MOE_TRAIN_STEPS, batch=MOE_BATCH, seq=MOE_SEQ, seed=seed,
            device="cuda", log_every=1,
            backend=core.BackendConfig(extent_max_rows=EXPERT_EXTENT_ROWS),
            swap=SwapConfig(hot_path=HotPathConfig(compress_workers=EXPERT_ZLIB_WORKERS)))
    except AssertionError as exc:
        fail(f"train-moe: an expert differs from the training state: {exc}")
    except core.PinnedError as exc:
        fail(f"train-moe: {exc}")
    run_s = time.perf_counter() - t0
    launches = {k: ops.launches.get(k, 0) for k in SWAP_COUNTERS}
    if not all(math.isfinite(x) for x in r["loss"]):
        fail(f"train-moe: losses {r['loss']}")
    if r["crc_failures"]:
        fail(f"train-moe: {r['crc_failures']} CRC failures")
    check_swap_launches("train-moe", launches, SWAP_OUT_IN + ("scatter_verified",))
    model = r["state"].model
    n_params = sum(p.numel() for p in model.parameters())
    steady = sorted(r["step_ms"][1:] or r["step_ms"])   # one step: its own
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "layers_full": get_config(EXPERT_ARCH).n_layers, "params": n_params,
           "state_gb": n_params * 16 / 1e9, "batch": MOE_BATCH, "seq": MOE_SEQ,
           "steps": MOE_TRAIN_STEPS, "loss": r["loss"], "step_ms": r["step_ms"],
           "step_ms_median": steady[len(steady) // 2],
           "active_experts": r["active"], "experts": cfg.moe.n_routed,
           "experts_in_hbm": cfg.moe.n_routed // 2,
           "experts_verified_bit_exact": r["verified"], "residency": r["residency"],
           "run_s": run_s, "setup_s": r["setup_s"], "verify_s": r["verify_s"],
           "launches": launches, **{k: r[k] for k in (
               "ms_swapped_out", "ms_swapped_in", "mp_swapped_out",
               "mp_swapped_in", "faults", "crc_failures")}}
    log(f"train-moe: {cfg.name} {cfg.n_layers}/{out['layers_full']} layers, "
        f"{n_params / 1e9:.3f} B params, {MOE_TRAIN_STEPS} steps of {MOE_BATCH} x "
        f"{MOE_SEQ} in {run_s:.1f} s (set-up {r['setup_s']:.1f} s, median step "
        f"{out['step_ms_median']:.0f} ms, final check {r['verify_s']:.1f} s), "
        f"{sum(r['active']) / len(r['active']):.1f} of {cfg.moe.n_routed} experts active a step; "
        f"experts swapped out {r['ms_swapped_out']}, in {r['ms_swapped_in']}, "
        f"faults {r['faults']}, residency {r['residency']}; all "
        f"{r['verified']} experts bit-exact")
    g = torch.Generator(device="cpu").manual_seed(seed + 13)
    prompt = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_DECODE),
                           generator=g).to("cuda")
    out.update(_prefill_vs_decode(torch, ops, model, cfg, prompt,
                                  PREFILL_DECODE_TOL, "train-moe"))
    del r, model
    free_device(torch)
    return out


def train_phase(torch, ops, core, seed: int, smi: str) -> dict:
    """Phase 13: training and prefill of the dense and MoE families."""
    t0 = time.perf_counter()
    parity = train_parity(torch, ops, seed, TRAIN_PARITY_ARCHS, "train-parity")
    log(f"train-parity: {json.dumps(parity)}")
    full = train_full_width(torch, ops, seed, smi)
    ckpt = train_checkpoint(torch, seed)
    moe = train_elastic_moe(torch, ops, core, seed)
    launches = dict(moe["launches"])
    launches["paged_attn"] = (full["paged_attn_launches"]
                              + moe["paged_attn_launches"])
    out = {"seconds": time.perf_counter() - t0, "device": smi,
           "parity": parity, "full_width": full, "checkpoint": ckpt,
           "elastic_moe": moe, "launches": launches}
    log(json.dumps({"train": out}))
    return out


# ------------------------------------------------------------- families
def decode_against_forward(torch, ops, model, cfg, batch: dict, gen: int
                           ) -> tuple:
    """``batch``'s tokens (B, P) through ``serve_step`` one position at a
    time -- for the VLM family with ``input_embeds`` over the vision
    prefix and ``mrope_pos`` at every step -- then ``gen`` greedy tokens;
    then one ``forward`` over the P + gen tokens fed, its logits against
    the decode's at every position (the pool in the compute dtype): the
    largest difference relative to the largest forward logit, the share
    of equal argmaxes, the paged launches, the greedy steps' wall times.
    Returns (result, extras): the cache, the next greedy token, the
    tokens fed (B, P + gen) and each position's error (B, P + gen)."""
    from repro_torch.models import model as M
    from repro_torch.train import steps as S

    tokens = batch["tokens"]
    B, P = tokens.shape
    T = P + gen
    bt = cfg.kv_block_tokens
    nv = batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0
    cache = M.init_cache(cfg, B, -(-T // bt) * bt,
                         dtype=M.DTYPES[cfg.compute_dtype], device="cuda")
    before = ops.launches.get("paged_attn", 0)
    fed, got = [tokens[:, t] for t in range(P)], []
    t0 = time.perf_counter()
    for t in range(P):
        mp = batch["mrope_pos"][:, :, t:t + 1] if "mrope_pos" in batch else None
        ie = batch["vision_embeds"][:, t] if t < nv else None
        logits, cache = S.serve_step(model, tokens[:, t], cache, cfg, mp, ie)
        got.append(logits)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    tok, step_ms = logits.argmax(-1), []
    t_gen = time.perf_counter()
    for _ in range(gen):
        t1 = time.perf_counter()
        fed.append(tok)
        logits, cache = S.serve_step(model, tok, cache, cfg)
        got.append(logits)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    gen_s = time.perf_counter() - t_gen
    launches = ops.launches.get("paged_attn", 0) - before
    t0 = time.perf_counter()
    with torch.no_grad():
        seq = torch.stack([t.long() for t in fed], 1)
        hidden, _ = M.forward(model, cfg, dict(batch, tokens=seq), remat=False)
        want = M.logits_from_hidden(model, cfg, hidden)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    got = torch.stack(got, 1)
    finite = bool(torch.isfinite(got).all() & torch.isfinite(want).all())
    pos_err = torch.stack([(got[:, t].float() - want[:, t].float()).abs().amax(-1)
                           for t in range(T)], 1) / want.abs().max().float()
    r = {"batch": B, "prompt_tokens": P, "new_tokens": gen, "positions": T,
         "prompt_steps_s": prompt_s, "decode_window_s": gen_s,
         "decode_step_ms": step_ms, "forward_ms": forward_ms,
         "decode_vs_forward_rel_err": float(pos_err.max()) if finite else math.inf,
         "argmax_equal": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
         "paged_attn_launches": launches}
    del got, want, hidden
    return r, {"cache": cache, "next_token": tok, "tokens": seq, "pos_err": pos_err}


def _check_decode(cfg, r: dict, tol, where: str) -> None:
    """Every attention layer of every decode step launched the paged
    kernel once; decode within ``tol`` of the forward (``None``: not
    held to one)."""
    from repro_torch.models import model as M
    want = M.attn_layer_count(cfg) * r["positions"]
    if r["paged_attn_launches"] != want:
        fail(f"{where}: {r['paged_attn_launches']} paged-attention launches, "
             f"{want} expected ({M.attn_layer_count(cfg)} attention layers x "
             f"{r['positions']} steps)")
    if tol is not None and not r["decode_vs_forward_rel_err"] < tol:
        fail(f"{where}: decode and forward logits differ by relative "
             f"{r['decode_vs_forward_rel_err']} (tolerance {tol})")


def family_model(torch, part: str, seed: int) -> tuple:
    """(cfg, bf16 model on the card, decode batch on the card, greedy
    tokens) of phase 14's part ``ssm`` (b), ``hybrid`` (c) or ``vlm``
    (d); the decode batch's tokens are drawn from ``seed``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import model as M
    from repro_torch.train import steps as S

    g = torch.Generator(device="cpu").manual_seed(seed + 17)
    if part == "vlm":
        cfg = get_config(VLM_ARCH)
        nv = cfg.max_vision_tokens
        batch = S.to_device(SyntheticPipeline(cfg, VLM_BATCH, nv + VLM_TEXT,
                                              seed=seed).next_batch(), "cuda")
        batch = {k: batch[k] for k in ("tokens", "vision_embeds", "mrope_pos")}
        gen = 0
    else:
        if part == "ssm":
            cfg, B, P, gen = get_config(SSM_ARCH), SSM_BATCH, SSM_PROMPT, SSM_GEN
        else:
            full = get_config(HYBRID_ARCH)
            cfg = dataclasses.replace(
                full, n_layers=full.hybrid_group,
                moe=dataclasses.replace(full.moe, n_routed=HYBRID_EXPERTS,
                                        capacity_factor=HYBRID_EXPERTS
                                        / full.moe.top_k))
            B, P, gen = HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=g).cuda()}
    model = M.cast_params(M.init_params(cfg, seed=seed, device="cuda"))
    return cfg, model, batch, gen


def _params_b(model) -> float:
    return sum(p.numel() for p in model.parameters()) / 1e9


def _decode_bound_ms(cfg, model, r: dict) -> tuple:
    """The decode step's byte bound: every weight read once in its dtype
    (the embedding only for the batch's rows), the mamba states read and
    written once, each attention layer's K/V at the greedy window's mean
    length read once. Returns (ms, bytes)."""
    from repro_torch.models import model as M
    B = r["batch"]
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    w -= model.embed.numel() * model.embed.element_size()
    w += B * cfg.d_model * model.embed.element_size()
    nm = M.mamba_layer_count(cfg)
    state = 0 if cfg.mamba is None else 2 * 4 * nm * B * cfg.d_inner * (
        cfg.mamba.d_conv - 1 + cfg.mamba.d_state)
    mean_len = r["prompt_tokens"] + (r["new_tokens"] + 1) / 2
    kv = (M.attn_layer_count(cfg) * B * mean_len * 2 * cfg.n_kv_heads
          * cfg.head_dim_ * 2)
    nbytes = w + state + kv
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def family_decode(torch, ops, part: str, seed: int, smi: str,
                  profile_steps: int = 0) -> dict:
    """Phase 14 (b), (c) or (d)'s decode: ``family_model``'s bf16 model
    and batch through ``decode_against_forward`` within
    FAMILY_DECODE_TOL (jamba's bf16 reading is reported, not held:
    FAMILY_DECODE_TOL); decode step ms (median of the greedy steps),
    tokens/s and the byte bound where there are greedy steps; with
    ``profile_steps`` the device busy share of that many more steps;
    peak memory. For the mamba families (b) and (c) then the same fed
    tokens again with the weights cast to f32 and f32 compute, within
    FAMILY_F32_DECODE_TOL: in bf16 a lost SSM state is below rounding."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import steps as S

    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, batch, gen = family_model(torch, part, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    where = f"families-{part}"
    tol = FAMILY_DECODE_TOL[cfg.name]
    r, ex = decode_against_forward(torch, ops, model, cfg, batch, gen)
    _check_decode(cfg, r, tol, where)
    r.update(arch=cfg.name, layers=cfg.n_layers, params_b=_params_b(model),
             setup_s=setup_s, tolerance=tol)
    if gen:
        steps = sorted(r["decode_step_ms"])
        r.update(decode_step_ms_median=steps[len(steps) // 2],
                 decode_step_ms_mean=r["decode_window_s"] / gen * 1e3,
                 tokens_per_s=r["batch"] * gen / r["decode_window_s"])
        r["step_bound_ms"], r["step_bound_bytes"] = _decode_bound_ms(cfg, model, r)
    if profile_steps:
        cache, tok = ex["cache"], ex["next_token"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                logits, cache = S.serve_step(model, tok, cache, cfg)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        dev_us, _, top = _device_times(torch, prof)
        r.update(profiled_step_ms=window_us / profile_steps / 1e3,
                 device_us_per_step=(None if dev_us is None
                                     else dev_us / profile_steps),
                 device_busy_share=(None if dev_us is None else
                                    dev_us / profile_steps
                                    / (r["decode_step_ms_mean"] * 1e3)),
                 device_top_us=top)
        del cache, prof
    r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    msg = (f"{where}: {cfg.name} {cfg.n_layers} layers, {r['params_b']:.3f} B "
           f"params bf16, {r['batch']} x {r['positions']} positions "
           f"({r['prompt_tokens']} fed + {gen} greedy); decode against forward: "
           f"relative {r['decode_vs_forward_rel_err']:.2e} (tolerance {tol}), "
           f"argmax equal {r['argmax_equal']:.3f}; {r['paged_attn_launches']} "
           f"paged launches")
    if gen:
        msg += (f"; decode step {r['decode_step_ms_mean']:.2f} ms (median "
                f"{r['decode_step_ms_median']:.2f}), {r['tokens_per_s']:.1f} "
                f"tokens/s, byte bound {r['step_bound_ms']:.3f} ms")
    if profile_steps:
        msg += f"; device busy {r['device_busy_share']}"
    log(f"{msg}; peak {r['peak_memory_gb']:.2f} GB; {smi}")
    if cfg.mamba is not None:
        tokens = ex["tokens"]
        del ex
        free_device(torch)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model.float()
        r32, _ = decode_against_forward(torch, ops, model, cfg32,
                                        {"tokens": tokens}, 0)
        _check_decode(cfg32, r32, FAMILY_F32_DECODE_TOL, f"{where} f32")
        r["f32"] = {k: r32[k] for k in ("positions", "forward_ms",
                                        "decode_vs_forward_rel_err",
                                        "argmax_equal", "paged_attn_launches")}
        r["f32"].update(tolerance=FAMILY_F32_DECODE_TOL,
                        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        r["paged_attn_launches"] += r32["paged_attn_launches"]
        log(f"{where}: the same {r['batch']} x {r32['positions']} tokens in f32: "
            f"decode against forward relative "
            f"{r32['decode_vs_forward_rel_err']:.2e} (tolerance "
            f"{FAMILY_F32_DECODE_TOL}), argmax equal {r32['argmax_equal']:.3f}; "
            f"peak {r['f32']['peak_memory_gb']:.2f} GB; {smi}")
    del model, batch
    free_device(torch)
    return r


def family_train(torch, part: str, seed: int, smi: str) -> dict:
    """Phase 14 (b)'s training (falcon-mamba-7b at full width, 16 of 64
    layers, f32 parameters) or (e) (hubert-xlarge at full width) through
    ``run_training``: step ms and peak memory."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_training

    if part == "ssm":
        cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_TRAIN_LAYERS,
                                  param_dtype="float32")
        steps, B, S = SSM_TRAIN_STEPS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ
    else:
        cfg = get_config(AUDIO_ARCH)
        steps, B, S = AUDIO_STEPS, AUDIO_BATCH, AUDIO_FRAMES
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = run_training(cfg, steps=steps, batch=B, seq=S, lr=TRAIN_LR,
                     ckpt_dir=None, ckpt_every=steps, seed=seed,
                     log_every=steps, device="cuda")
    run_s = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in r["loss"] + r["grad_norm"]):
        fail(f"families-{part}: losses {r['loss']}, grad norms {r['grad_norm']}")
    n = sum(p.numel() for p in r["state"].model.parameters())
    steady = sorted(r["step_ms"][1:])
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "layers_full": get_config(cfg.name).n_layers, "params_b": n / 1e9,
           "state_gb": n * 16 / 1e9, "batch": B, "seq": S, "steps": steps,
           "loss": r["loss"], "grad_norm": r["grad_norm"], "step_ms": r["step_ms"],
           "step_ms_median": steady[len(steady) // 2],
           "tokens_per_s": B * S / steady[len(steady) // 2] * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "run_s": run_s}
    log(f"families-{part}-train: {cfg.name} {cfg.n_layers}/{out['layers_full']} "
        f"layers, {n / 1e9:.3f} B params ({out['state_gb']:.1f} GB of f32 params, "
        f"grads and moments), {steps} steps of {B} x {S}: step "
        f"{out['step_ms_median']:.1f} ms (median of steps 2-{steps}), losses "
        f"{[round(x, 4) for x in r['loss']]}, peak {out['peak_memory_gb']:.2f} GB; {smi}")
    del r
    free_device(torch)
    return out


def families_phase(torch, ops, seed: int, smi: str) -> dict:
    """Phase 14: the SSM, hybrid, VLM and audio families."""
    t0 = time.perf_counter()
    ops.reset_launches()
    parity = train_parity(torch, ops, seed, FAMILY_ARCHS, "families-parity",
                          decode=True)
    log(f"families-parity: {json.dumps(parity)}")
    out = {"parity": parity,
           "ssm": family_decode(torch, ops, "ssm", seed, smi, profile_steps=8)}
    out["ssm_train"] = family_train(torch, "ssm", seed, smi)
    out["hybrid"] = family_decode(torch, ops, "hybrid", seed, smi)
    out["vlm"] = family_decode(torch, ops, "vlm", seed, smi)
    out["audio_train"] = family_train(torch, "audio", seed, smi)
    out.update(seconds=time.perf_counter() - t0, device=smi,
               launches={"paged_attn": ops.launches.get("paged_attn", 0)})
    log(json.dumps({"families": out}))
    return out


def mla_serve(torch, ops, seed: int, smi: str) -> dict:
    """Phase 15: DeepSeek-V2-Lite at full width (d 2048, 16 heads of MLA
    over a 512 + 64 latent, 64 routed experts of 1408 top-6 + 2 shared,
    vocab 102400; weights from ``seed``, cast once to bf16), cut to
    MLA_LAYERS layers, decoding MLA_BATCH requests through ``serve_step``
    over the latent pool: a MLA_PROMPT-token prompt fed token by token,
    then MLA_GEN greedy tokens. From a reset just before the prompt,
    every attention layer of every step must launch the paged MLA kernel
    once and the GQA kernel never; the pool is 576 values a token and
    layer; logits finite, ``kv_len`` the steps taken. Reports the decode
    step (mean and median ms), tokens/s, its byte bound (every weight
    read once, the embedding only for the batch's rows, and each layer's
    latent rows at the greedy window's mean length), the device busy
    share of 8 profiled steps and the peak memory."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train.steps import serve_step

    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    model = M.cast_params(M.init_params(cfg, seed=seed, device="cuda"))
    cache = M.init_cache(cfg, MLA_BATCH, MLA_MAX_SEQ, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    pool = cache.get("latent_pool")
    n_attn = M.attn_layer_count(cfg)
    if pool is None or "kv_pool" in cache or (pool.shape[0], pool.shape[-1]) != (
            n_attn, full.mla.kv_lora_rank + full.mla.qk_rope_head_dim):
        fail(f"mla-serve: the cache holds {sorted(cache)}, latent pool "
             f"{None if pool is None else tuple(pool.shape)}; wanted "
             f"({n_attn}, n_blocks, bt, 576) and no K/V pool")
    g = torch.Generator(device="cpu").manual_seed(seed + 29)
    prompts = torch.randint(0, cfg.vocab, (MLA_BATCH, MLA_PROMPT),
                            generator=g).to("cuda")

    ops.reset_launches()
    t0 = time.perf_counter()
    for t in range(MLA_PROMPT):
        logits, cache = serve_step(model, prompts[:, t], cache, cfg)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    tok = logits.argmax(-1)
    step_ms = []
    t_gen = time.perf_counter()
    for _ in range(MLA_GEN):
        t0 = time.perf_counter()
        logits, cache = serve_step(model, tok, cache, cfg)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    gen_s = time.perf_counter() - t_gen
    steps = MLA_PROMPT + MLA_GEN
    launches = ops.launches.get("paged_mla", 0)
    if launches != n_attn * steps or ops.launches.get("paged_attn", 0):
        fail(f"mla-serve: {launches} paged MLA and "
             f"{ops.launches.get('paged_attn', 0)} paged GQA launches in "
             f"{steps} steps of {n_attn} attention layers")
    if logits.shape != (MLA_BATCH, cfg.vocab) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"mla-serve: logits {tuple(logits.shape)} not finite")
    if cache["kv_len"].tolist() != [steps] * MLA_BATCH:
        fail(f"mla-serve: kv_len {cache['kv_len'].tolist()} after {steps} steps")

    emb = model.embed
    weight_bytes = (sum(p.numel() * p.element_size() for p in model.parameters())
                    - (emb.numel() - MLA_BATCH * cfg.d_model) * emb.element_size())
    mean_len = MLA_PROMPT + (MLA_GEN + 1) / 2
    latent_bytes = (n_attn * MLA_BATCH * mean_len * pool.shape[-1]
                    * pool.element_size())
    bound_ms = (weight_bytes + latent_bytes) / HBM_BYTES_PER_S * 1e3
    mean_ms = gen_s / MLA_GEN * 1e3
    med = sorted(step_ms)[len(step_ms) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            logits, cache = serve_step(model, tok, cache, cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    dev_us, _, top = _device_times(torch, prof)
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "layers_full": full.n_layers,
        "params": n_params, "batch": MLA_BATCH, "prompt_tokens": MLA_PROMPT,
        "new_tokens": MLA_GEN, "setup_s": setup_s, "prompt_steps_s": prompt_s,
        "decode_window_s": gen_s, "decode_step_ms_mean": mean_ms,
        "decode_step_ms_median": med, "tokens_per_s": MLA_BATCH * MLA_GEN / gen_s,
        "step_bound_ms": bound_ms, "weight_bytes": weight_bytes,
        "latent_bytes_mean": latent_bytes, "paged_mla_launches": launches,
        "steps": steps,
        "device_busy_share": (None if dev_us is None
                              else dev_us / 8 / (mean_ms * 1e3)),
        "device_top_us_8_steps": top,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"mla-serve: {cfg.name} {cfg.n_layers}/{full.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params bf16, latent pool {tuple(pool.shape)}; "
        f"{MLA_BATCH} x ({MLA_PROMPT} fed + {MLA_GEN} greedy): decode step "
        f"{mean_ms:.2f} ms (median {med:.2f}) against a byte bound of "
        f"{bound_ms:.3f} ms, {result['tokens_per_s']:.1f} tokens/s; {launches} "
        f"paged MLA launches = {n_attn} x {steps}; device busy "
        f"{result['device_busy_share']}; peak {result['peak_memory_gb']:.2f} GB; "
        f"{smi}")
    log(json.dumps({"mla_serve": result}))
    del model, cache, logits, prof
    free_device(torch)
    result["launches"] = {"paged_mla": launches}
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--managed-ms", type=int, default=1024,
                    help="managed 2 MiB MSs of guest frames in HBM "
                         "(16384 = the paper's 32 GiB)")
    ap.add_argument("--fleet-node-ms", type=int, default=32,
                    help="managed 2 MiB MSs of each of the fleet phase's 4 "
                         "nodes (the paper's node holds 16384)")
    ap.add_argument("--bench-ms", type=int, default=BENCH_MS,
                    help="managed 2 MiB MSs of the bench phase's fault "
                         "latency and LRU accuracy runs")
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
    timed.update(check_paged_mla(torch, ops, ref, args.seed))
    if old_build:
        compare_old_new(torch, ops, load_old_build(*old_build), args.seed)
    else:
        log("old-vs-new: not measured (no --compare-sources)")
    done("build and kernels")

    # 3. main path, 4. corruption
    s, launches = main_path(torch, np, core, ops, args.managed_ms, args.seed)
    try:
        corruption(torch, np, s, core)
    finally:
        s.close()
    del s
    free_device(torch)
    done("main and corrupt")

    # 5. hot switch and hot upgrade
    hot_switch_phase(torch, np, core, ops, args.managed_ms, args.seed, smi)
    free_device(torch)
    done("hot-switch")

    # 6. serve, 7. serve-parity, 8. elastic-kv, 9. elastic-serving
    served, model = serve_path(torch, ops, args.seed)
    launches["paged_attn"] = served["paged_attn_launches"]
    # phase 12's decode overhead runs here, on the serve phase's model
    overhead = overhead_bench(torch, ops, model)
    launches["paged_attn"] += overhead["launches"]["paged_attn"]
    del model
    free_device(torch)
    done("serve and the decode overhead")
    serve_parity(torch, ops, args.seed)
    elastic_kv(torch, ops, args.seed)
    elastic_serving(torch, ops, args.seed)
    done("serve-parity, elastic-kv and elastic-serving")

    # 10. expert cache, 11. fleet, 12. bench, 13. train, 14. families,
    # 15. mla-serve:
    # their launches join the main paths'
    for name, run in (
            ("expert-cache", lambda: expert_cache_phase(torch, np, core, ops, args.seed)),
            ("fleet", lambda: fleet_phase(torch, np, ops, args.fleet_node_ms, args.seed)),
            ("bench", lambda: bench_phase(torch, np, ops, args.bench_ms, overhead)),
            ("train", lambda: train_phase(torch, ops, core, args.seed, smi)),
            ("families", lambda: families_phase(torch, ops, args.seed, smi)),
            ("mla-serve", lambda: mla_serve(torch, ops, args.seed, smi))):
        for k, n in run()["launches"].items():
            launches[k] = launches.get(k, 0) + n
        done(name)

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
