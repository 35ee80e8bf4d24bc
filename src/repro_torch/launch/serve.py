"""Serving driver with Taiji elastic KV cache, guest frames on the card.

``python -m repro_torch.launch.serve --arch <id> --reduced`` runs a
multi-turn serving simulation with the KV blocks as MSs of guest frames
in the card's HBM: more live sequences than physical KV capacity, idle
sequences cooling down and getting swapped to the compressed host
backend, scheduled batches faulting their blocks back in before each
decode step (the DMA pin contract). Prints the paper's metrics: fault
latency percentiles, residency, backend composition, water levels.

As ``repro/launch/serve.py``, except that the frames' device is a
parameter (the card by default) and that no model parameters are made:
the reference's ``init_params`` there is never read.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from ..configs.reduce import reduced_config
from ..core.config import LRUConfig, SchedulerConfig
from ..core.elastic_kv import ElasticKVCache, KVGeometry, make_kv_taiji_config
from ..core.system import TaijiSystem


def run_serving(cfg, *, n_seqs: int, phys_blocks: int, turns: int,
                batch: int, prompt_len: int, gen_len: int, seed: int = 0,
                verbose: bool = True, device=None, verify: bool = False):
    """Drive the elastic KV cache with ``n_seqs`` sequences over
    ``phys_blocks`` physical KV blocks; returns ``system.stats()`` plus
    the cache's ``residency`` at the end of the last turn.

    ``device`` holds the guest frames (``None``: the card). ``verify``
    keeps a host mirror of every appended token and, after the last
    turn, reads every sequence back through the cache and raises
    ``RuntimeError`` where a block differs from it; then
    ``stats["verified_blocks"]`` counts the blocks read."""
    geom = KVGeometry.for_config(cfg)
    # virtual space sized for the demo's worst case (every sequence grows
    # to prompt + turns*gen tokens); physical stays at phys_blocks -- the
    # gap is Taiji's elastic memory
    bt = geom.block_tokens
    worst_blocks = n_seqs * (-(-(prompt_len + turns * gen_len) // bt))
    over = max(0.5, worst_blocks / phys_blocks - 1.0)
    tcfg = make_kv_taiji_config(
        geom, phys_blocks, overcommit=over,
        lru=LRUConfig(scan_interval_s=0.002, workers=2, stabilize_scans=1),
        scheduler=SchedulerConfig(cycle_ms=2.0, shards=2))
    system = TaijiSystem(tcfg, device=device)
    try:
        system.start_background()
        cache = ElasticKVCache(geom, system)
        kv_shape = geom.token_shape
        mirror: Dict[int, List[np.ndarray]] = {}

        def append(sid: int, kv: np.ndarray) -> None:
            cache.append_kv(sid, kv)
            if verify:
                mirror.setdefault(sid, []).append(kv)

        npr = np.random.default_rng(seed)
        for sid in range(n_seqs):
            cache.create_sequence(sid)
            # host-side copy of each sequence's KV (what the device would DMA)
            for _ in range(prompt_len):
                append(sid, npr.standard_normal(kv_shape).astype(np.float16))

        step_times = []
        for turn in range(turns):
            batch_ids = npr.choice(n_seqs, size=batch, replace=False)
            t0 = time.perf_counter()
            with cache.prepare_step(batch_ids):  # swap-in + pin (DMA contract)
                # decode gen_len tokens for the scheduled batch
                for _ in range(gen_len):
                    for sid in batch_ids:
                        append(int(sid), npr.standard_normal(kv_shape)
                               .astype(np.float16))
            step_times.append(time.perf_counter() - t0)
            if verbose and (turn + 1) % max(1, turns // 10) == 0:
                res = cache.residency()
                print(f"turn {turn+1:3d}: residency={res} "
                      f"free_ms={system.phys.free_count}")

        stats = system.stats()
        stats["residency"] = cache.residency()
        if verbose:
            print("\n--- Taiji metrics (paper §5 counters) ---")
            print("fault latency:", stats["metrics"]["fault_latency"])
            print("swapped out MS:", stats["metrics"]["ms_swapped_out"],
                  " swapped in MP:", stats["metrics"]["mp_swapped_in"])
            print("zero/compressed MPs:", stats["metrics"]["zero_mps"],
                  "/", stats["metrics"]["compressed_mps"],
                  " compression ratio:",
                  f"{stats['metrics']['compression_ratio']:.3f}")
            print("mpool:", {k: round(v, 3) if isinstance(v, float) else v
                             for k, v in stats["mpool"].items()})
            print(f"mean scheduled-batch latency: "
                  f"{np.mean(step_times)*1e3:.2f} ms")
        if verify:
            stats["verified_blocks"] = _verify(cache, mirror)
        return stats
    finally:
        system.close()


def _verify(cache: ElasticKVCache, mirror: Dict[int, List[np.ndarray]]) -> int:
    """Every sequence read back through the cache equals its host mirror;
    returns the number of blocks read."""
    n_blocks = 0
    for sid, toks in mirror.items():
        got = cache.read_blocks(sid)
        n_blocks += len(got)
        got = got.reshape(-1, *toks[0].shape)[:len(toks)]
        if not np.array_equal(got, np.stack(toks)):
            raise RuntimeError(f"sequence {sid}: KV read back differs from "
                               f"what was appended")
    return n_blocks


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--n-seqs", type=int, default=24)
    ap.add_argument("--phys-blocks", type=int, default=48)
    ap.add_argument("--turns", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=8)
    args = ap.parse_args()

    cfg = reduced_config(args.arch)
    run_serving(cfg, n_seqs=args.n_seqs, phys_blocks=args.phys_blocks,
                turns=args.turns, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len)


if __name__ == "__main__":
    main()
