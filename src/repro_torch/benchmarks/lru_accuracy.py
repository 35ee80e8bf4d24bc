"""Multi-level LRU cold-page identification -- paper Fig 15b / 14c.

Paper: cluster average cold-memory ratio 52.79%; most-utilized nodes stay
above 30%. We drive a known hot/cold access pattern and measure how
accurately the multi-level sets recover it (precision/recall of the cold
set) plus the identified cold ratio.

Port: a copy of ``benchmarks/lru_accuracy.py``. ``device`` holds the
frames (``None``: the card; ``"cpu"`` for parity runs); ``geometry``
(:class:`~.workload.Geometry`) sizes the system, its managed MSs the
guest's sections.
"""
from __future__ import annotations

import numpy as np

from ..core.config import LRUConfig, TaijiConfig
from ..core.lru import INACTIVE
from ..core.system import TaijiSystem
from .workload import sized


def run(n_ms: int = 96, hot_fraction: float = 0.45, scans: int = 12,
        verbose: bool = True, *, device=None, geometry=None) -> dict:
    if geometry is not None:
        n_ms = geometry.managed_ms
    cfg = sized(TaijiConfig(ms_bytes=16 * 1024, mps_per_ms=8,
                            n_phys_ms=n_ms + 4, overcommit_ratio=0.1,
                            mpool_reserve_ms=4,
                            lru=LRUConfig(stabilize_scans=2, workers=2)),
                geometry)
    system = TaijiSystem(cfg, device=device)
    rng = np.random.default_rng(5)
    gfns = [system.guest_alloc_ms() for _ in range(n_ms)]
    hot = set(rng.choice(gfns, size=int(n_ms * hot_fraction), replace=False).tolist())

    for _ in range(scans):
        # hot pages touched every round (with one transient cold touch to
        # exercise the smoothing), cold pages idle
        for g in hot:
            system.virt.table.mark_accessed(g)
        transient = int(rng.choice(gfns))
        system.virt.table.mark_accessed(transient)
        for w in range(cfg.lru.workers):
            system.lru.scan_shard(w, cfg.lru.workers)

    identified_cold = {g for g in gfns
                       if (system.lru.level_of(g) or 0) >= INACTIVE}
    actual_cold = set(gfns) - hot
    tp = len(identified_cold & actual_cold)
    result = {
        "cold_ratio_identified": len(identified_cold) / n_ms,
        "cold_ratio_actual": len(actual_cold) / n_ms,
        "precision": tp / max(1, len(identified_cold)),
        "recall": tp / max(1, len(actual_cold)),
    }
    if verbose:
        print(f"identified cold ratio: {result['cold_ratio_identified']*100:.1f}% "
              f"(actual {result['cold_ratio_actual']*100:.1f}%; paper avg 52.79%)")
        print(f"precision={result['precision']*100:.1f}%  "
              f"recall={result['recall']*100:.1f}%")
    system.close()
    return result


def rows(device=None, geometry=None) -> list:
    r = run(verbose=False, device=device, geometry=geometry)
    return [
        ("lru_cold_ratio", r["cold_ratio_identified"],
         f"actual={r['cold_ratio_actual']:.3f}"),
        ("lru_precision", r["precision"], f"recall={r['recall']:.3f}"),
    ]


if __name__ == "__main__":
    run()
