"""Elastic serving: more live sequences than physical KV capacity.

    PYTHONPATH=src python -m repro_torch.examples.elastic_serving

Runs the full Taiji stack under a multi-turn serving workload (reduced
qwen3-4b): idle sequences cool down in the multi-level LRU, the watermark
policy swaps their KV blocks to the zero/compressed backend, and each
scheduled batch pins + faults its blocks back in before decoding (the DMA
contract). Halfway through, the swap engine is HOT-UPGRADED v1 -> v2
under load -- serving never stops (paper §4.4).

All guest memory flows through the system's GuestSpace (the sanctioned
surface), whose frames live on ``device`` (the card's HBM by default);
pass ``--capture trace.tsv`` to attach a TraceRecorder and write the
serving workload as a replayable fleet trace.

Port of ``examples/elastic_serving.py``: the loop is :func:`run`, which
takes the model config, the physical KV blocks and the device and returns
the system's stats, so that a caller can drive it at full width.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from ..configs.reduce import reduced_config
from ..core import EngineModule, EngineModuleV2, EntryOps, hot_upgrade, install_module
from ..core.config import LRUConfig, SchedulerConfig
from ..core.elastic_kv import ElasticKVCache, KVGeometry, make_kv_taiji_config
from ..core.system import TaijiSystem
from ..models import model as M


def run(cfg, *, phys_blocks: int, device=None, turns: int = 40,
        seed: int = 0, capture: Optional[str] = None) -> Dict[str, object]:
    """Serve ``turns`` turns of 4 of 24 sequences over ``phys_blocks``
    physical KV blocks of ``cfg``'s geometry, hot-upgrading the swap
    engine at turn ``turns // 2``. ``device`` holds the guest frames
    (``None``: the card); ``capture`` is a path to write the workload to
    as a fleet trace. Returns ``system.stats()`` plus the cache's
    ``residency``, the module version the entry table serves
    (``entry_version``), the ``upgrade_turn`` and, with ``capture``, the
    trace's ops (``captured_ops``)."""
    n_seqs, batch = 24, 4
    prompt, gen = 24, 8
    geom = KVGeometry(n_layers=M.attn_layer_count(cfg),
                      kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                      block_tokens=cfg.kv_block_tokens)
    worst = n_seqs * (-(-(prompt + turns * gen) // geom.block_tokens))
    tcfg = make_kv_taiji_config(
        geom, phys_blocks, overcommit=worst / phys_blocks,
        lru=LRUConfig(scan_interval_s=0.002, workers=2, stabilize_scans=1),
        scheduler=SchedulerConfig(cycle_ms=2.0, shards=2))
    system = TaijiSystem(tcfg, device=device)
    try:
        space = system.guest                     # the one guest-memory surface
        recorder = None
        if capture:
            from ..fleet.trace import TraceRecorder
            recorder = space.attach(TraceRecorder.for_space(space))
        system.start_background()
        cache = ElasticKVCache(geom, space)

        entry = EntryOps()
        install_module(system, entry, EngineModule(system))

        kv_shape = (geom.n_layers, 2, geom.kv_heads, geom.head_dim)
        rng = np.random.default_rng(seed)
        for sid in range(n_seqs):
            cache.create_sequence(sid)
            for _ in range(prompt):
                cache.append_kv(sid, rng.standard_normal(kv_shape).astype(np.float16))

        # a scheduled batch's pinned working set must fit physical memory (the
        # DMA contract): finished conversations are recycled at max_ctx tokens
        max_ctx = (phys_blocks // (2 * batch)) * geom.block_tokens

        for turn in range(turns):
            if turn == turns // 2:
                print(">>> hot-upgrading swap engine v1 -> v2 under load...")
                hot_upgrade(system, entry, EngineModuleV2(system))
                print(f">>> running module version: {entry.call('version')}")
            for sid in range(n_seqs):
                if cache.seq_len(sid) + gen > max_ctx:   # conversation finished
                    cache.drop_sequence(sid)
                    cache.create_sequence(sid)
                    for _ in range(prompt):
                        cache.append_kv(sid, rng.standard_normal(kv_shape)
                                        .astype(np.float16))
            ids = rng.choice(n_seqs, size=batch, replace=False)
            nxt = rng.choice(n_seqs, size=batch, replace=False)
            prefetch = cache.prefetch_async(nxt)     # overlap next batch's swap-ins
            with cache.prepare_step(ids):            # pin working set (DMA rule)
                for _ in range(gen):
                    for sid in ids:
                        cache.append_kv(int(sid), rng.standard_normal(kv_shape)
                                        .astype(np.float16))
            prefetch.join(timeout=1)
            if (turn + 1) % 10 == 0:
                res = cache.residency()
                print(f"turn {turn+1:3d}: {res['resident_blocks']} resident / "
                      f"{res['swapped_blocks']} swapped blocks, "
                      f"free={system.phys.free_count} MS")

        stats = system.stats()
        stats["residency"] = cache.residency()
        stats["entry_version"] = entry.call("version")
        stats["upgrade_turn"] = turns // 2
        st = stats["metrics"]
        print("\nfault latency:", st["fault_latency"])
        print(f"swapped out {st['ms_swapped_out']} MSes; compression ratio "
              f"{st['compression_ratio']:.3f}; module v{stats['entry_version']}")
        if recorder is not None:
            recorder.write(capture)
            stats["captured_ops"] = recorder.n_ops
            print(f"captured {recorder.n_ops} trace ops -> {capture} "
                  f"(replay with repro_torch.fleet.harness.replay)")
        return stats
    finally:
        system.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--capture", metavar="PATH", default=None,
                    help="record the serving workload as a replayable "
                         "fleet trace (TSV) at PATH")
    args = ap.parse_args()
    run(reduced_config("qwen3-4b"), phys_blocks=48, capture=args.capture)


if __name__ == "__main__":
    main()
