"""Workload capture: real serving loops -> replayable fleet traces.

The ROADMAP's missing seam -- "trace capture from the elastic_kv /
elastic_params integrations so real serving workloads become replayable
fleet traces" -- closed through the unified GuestSpace surface: the
loops below drive the *actual* integrations (``ElasticKVCache`` decode
turns, ``ElasticExpertCache`` routing churn) against one instrumented
:class:`~repro_torch.core.guest.GuestSpace` with a
:class:`~.trace.TraceRecorder` attached, and hand back trace lines any
fleet can replay.  Because the recorder captures payload (``wdata``) and
content-hash (``rdata``) ops, a replay rewrites the application's real
bytes and verifies every read against what the application saw --
``harness.assert_deterministic`` then proves the run-twice-compare
contract over the captured workload.

Both capture loops are fully seeded and use deterministic stepped
background rounds, so the same seed captures the same trace.

Port: a copy of ``repro/fleet/capture.py`` whose capture node is the
port's :class:`TaijiSystem` on ``device`` (the card by default, ``"cpu"``
for the parity runs); the same seed captures the reference's trace.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List

import numpy as np

from ..core.config import LRUConfig, TaijiConfig, WatermarkConfig
from ..core.elastic_kv import ElasticKVCache, KVGeometry, make_kv_taiji_config
from ..core.elastic_params import (ElasticExpertCache,
                                   make_expert_taiji_config)
from ..core.system import TaijiSystem
from .trace import OP_RDATA, OP_WDATA, TraceRecorder


@dataclasses.dataclass
class CapturedTrace:
    """One captured workload.

    ``cfg`` is the capture node's TaijiConfig; ``fleet_cfg`` is the
    per-node config a replay fleet should use -- physical capacity is
    scaled down so a multi-node replay sees the same overcommit pressure
    the capture node did (an N-node fleet at full capture size would
    have N times the memory and never reclaim, making the replay a
    write-only exercise).
    """

    name: str
    lines: List[str]
    cfg: TaijiConfig
    fleet_cfg: TaijiConfig
    n_ops: int
    payload_writes: int
    payload_reads: int


def _scaled_node_cfg(cfg: TaijiConfig, managed_ms: int) -> TaijiConfig:
    """Per-node replay config with ``managed_ms`` guest-backing MSs."""
    scaled = dataclasses.replace(
        cfg, n_phys_ms=managed_ms + cfg.mpool_reserve_ms)
    scaled.validate()
    return scaled


def _capture(name: str, cfg: TaijiConfig, fleet_cfg: TaijiConfig,
             seed: int, loop, device) -> CapturedTrace:
    system = TaijiSystem(cfg, device=device)
    space = system.guest
    rec = space.attach(TraceRecorder.for_space(space, seed=seed))
    try:
        loop(system, space)
    finally:
        space.detach(rec)
        system.close()
    counts = rec.op_counts()
    return CapturedTrace(name=name, lines=rec.lines(), cfg=cfg,
                         fleet_cfg=fleet_cfg, n_ops=rec.n_ops,
                         payload_writes=counts.get(OP_WDATA, 0),
                         payload_reads=counts.get(OP_RDATA, 0))


def capture_kv_serving(seed: int = 11, *, n_seqs: int = 6, turns: int = 8,
                       batch: int = 2, smoke: bool = False,
                       device=None) -> CapturedTrace:
    """Capture a multi-turn elastic-KV serving loop.

    The loop is the integration's real shape: prompts fill blocks, each
    turn pins + decodes a scheduled batch (appends real fp16 KV), reads
    a block back (content-hash verified at replay), ages the LRU through
    stepped background rounds, and recycles finished conversations.
    """
    if smoke:
        turns = min(turns, 5)
    geom = KVGeometry(n_layers=2, kv_heads=2, head_dim=16, block_tokens=4,
                      dtype_bytes=2)
    # watermarks sit high so elasticity stays active even when the trace
    # is replayed on a fleet with more aggregate physical memory than the
    # capture node (a 2-node replay still ages + reclaims)
    cfg = make_kv_taiji_config(
        geom, n_phys_blocks=16, overcommit=1.2,
        lru=LRUConfig(scan_interval_s=0.001, workers=1, stabilize_scans=1),
        watermark=WatermarkConfig(high=0.5, low=0.3, min=0.05,
                                  reclaim_batch=4))
    prompt, gen = 8, 4
    # a conversation is recycled at max_ctx, which bounds a scheduled
    # batch's pinned working set (batch * max_ctx/block_tokens blocks +
    # in-step allocs) well under physical memory -- the DMA contract
    # says pinned blocks cannot be reclaimed to satisfy a new alloc
    max_ctx = 16
    # replay nodes carry 10 managed MSs each: a 2-node fleet holds 20
    # against a live set that peaks at n_seqs * max_ctx/4 = 24 blocks
    # (admission cap 1.25 * 20 = 25 admits everything), so the replay
    # ages, reclaims and faults like the capture node did.  Replay never
    # pins, so the per-node pin-fit bound does not apply there.
    fleet_cfg = _scaled_node_cfg(cfg, 10)

    def loop(system: TaijiSystem, space) -> None:
        pyrng = random.Random(seed)
        nprng = np.random.default_rng(seed)
        cache = ElasticKVCache(geom, space)

        def token():
            return nprng.standard_normal(
                (geom.n_layers, 2, geom.kv_heads, geom.head_dim)
            ).astype(np.float16)

        for sid in range(n_seqs):
            cache.create_sequence(sid)
            for _ in range(prompt):
                cache.append_kv(sid, token())
        for _turn in range(turns):
            for sid in range(n_seqs):
                if cache.seq_len(sid) + gen > max_ctx:   # finished: recycle
                    cache.drop_sequence(sid)
                    cache.create_sequence(sid)
                    for _ in range(prompt):
                        cache.append_kv(sid, token())
            ids = pyrng.sample(range(n_seqs), batch)
            with cache.prepare_step(ids):                # pin + decode
                for _ in range(gen):
                    for sid in ids:
                        cache.append_kv(sid, token())
            vsid = pyrng.randrange(n_seqs)               # verification read
            nblocks = len(cache.blocks_of(vsid))
            if nblocks:
                cache.read_block(vsid, pyrng.randrange(nblocks))
            space.step_background(2)                     # age + reclaim

    return _capture("kv_serving", cfg, fleet_cfg, seed, loop, device)


def capture_expert_churn(seed: int = 13, *, n_experts: int = 10,
                         n_hot: int = 4, rounds: int = 10,
                         smoke: bool = False, device=None) -> CapturedTrace:
    """Capture MoE expert-weight churn through the elastic expert cache.

    Seeds all experts, then rounds of: routing skewed to a hot set
    (residency hints), dispatch pinning, weight updates for the routed
    experts (real fp32 payloads), a read-back of a random expert
    (faulting cold ones in), and stepped background aging.
    """
    if smoke:
        rounds = min(rounds, 6)
    shape = (24, 16)
    expert_bytes = int(np.prod(shape)) * 4
    cfg = make_expert_taiji_config(
        expert_bytes, n_hot, n_experts,
        lru=LRUConfig(scan_interval_s=0.001, workers=1, stabilize_scans=1),
        watermark=WatermarkConfig(high=0.5, low=0.3, min=0.05,
                                  reclaim_batch=2))
    # n_hot managed MSs per replay node: a 2-node fleet holds 2*n_hot=8
    # physical for 10 live experts -- still overcommitted (cold experts
    # genuinely swapped) while the admission cap (int(1.25*8) = 10)
    # admits every expert
    fleet_cfg = _scaled_node_cfg(cfg, n_hot)

    def loop(system: TaijiSystem, space) -> None:
        pyrng = random.Random(seed)
        nprng = np.random.default_rng(seed)
        cache = ElasticExpertCache(space, n_experts, shape, dtype=np.float32)
        weights = {e: nprng.standard_normal(shape).astype(np.float32)
                   for e in range(n_experts)}
        for e, w in weights.items():
            cache.put_expert(e, w)
        hot = list(range(n_hot))
        for _rnd in range(rounds):
            # routing skewed to the hot set plus an occasional cold pick
            active = sorted(set(pyrng.sample(hot, 2)
                                + [pyrng.randrange(n_experts)]))
            cache.note_routing(active)
            with cache.prepare_dispatch(active):
                pass                                    # the "step"
            for eid in active:                          # optimizer update
                weights[eid] = (weights[eid] + nprng.standard_normal(
                    shape).astype(np.float32) * 0.01)
                cache.put_expert(eid, weights[eid])
            cache.get_expert(pyrng.randrange(n_experts))  # verified read
            space.step_background(2)

    return _capture("expert_churn", cfg, fleet_cfg, seed, loop, device)
