"""Overcommit benefit -- paper §5.3.3 / Fig 13b.

Paper: 32 GB + 16 GB virtual (50% elasticity); swapping 8,000 MSes frees
15.6 GB stored in only 1.73 GB => 9x overselling gain; benefit-to-cost
vs metadata 125.5x (live) / 39x (reserved).

Port: a copy of ``benchmarks/overcommit.py``. ``device`` holds the
frames (``None``: the card; ``"cpu"`` for parity runs); ``geometry``
(:class:`~.workload.Geometry`) sizes the system. On the card the scalar
fill's swap-outs copy each MP to the host on its own.
"""
from __future__ import annotations

import time

from ..core.config import LRUConfig, SwapConfig, TaijiConfig
from ..core.system import TaijiSystem
from .workload import fill_system, sized


def run(verbose: bool = True, smoke: bool = False,
        batched: bool = True, *, device=None, geometry=None) -> dict:
    cfg = sized(TaijiConfig(ms_bytes=(32 * 1024 if smoke else 128 * 1024),
                            mps_per_ms=32, n_phys_ms=32 if smoke else 64,
                            overcommit_ratio=0.5, mpool_reserve_ms=4,
                            lru=LRUConfig(stabilize_scans=1, workers=1),
                            swap=SwapConfig(batch_enabled=batched)),
                geometry)
    system = TaijiSystem(cfg, device=device)
    n_virt = cfg.n_virt_ms - cfg.mpool_reserve_ms
    t_fill0 = time.perf_counter()
    fill_system(system, n_virt, seed=13)
    fill_s = time.perf_counter() - t_fill0

    managed_phys = cfg.n_phys_ms - cfg.mpool_reserve_ms
    m = system.metrics
    freed_bytes = m.ms_swapped_out * cfg.ms_bytes
    stored = system.backend.stored_bytes()
    mpool = system.mpool.stats()

    result = {
        "fill_s": fill_s,
        "swap_out_batches": m.swap_out_batches,
        "mean_swap_out_batch_mps": m.snapshot()["mean_swap_out_batch_mps"],
        "virtual_ms": n_virt,
        "physical_ms": managed_phys,
        "elasticity": n_virt / managed_phys - 1.0,
        "ms_swapped_out": m.ms_swapped_out,
        "freed_bytes": freed_bytes,
        "backend_stored_bytes": stored,
        "overselling_gain": freed_bytes / max(1, stored),
        "metadata_used_bytes": mpool["used_bytes"],
        "metadata_reserved_bytes": mpool["reserved_bytes"],
        "benefit_vs_metadata_used": freed_bytes / max(1, mpool["used_bytes"]),
        "benefit_vs_metadata_reserved": freed_bytes / max(1, mpool["reserved_bytes"]),
    }
    if verbose:
        print(f"elasticity: +{result['elasticity']*100:.0f}% "
              f"({n_virt} virtual / {managed_phys} physical MSs; paper +50%)")
        print(f"freed {freed_bytes/1e6:.1f} MB stored in {stored/1e6:.2f} MB "
              f"=> overselling gain {result['overselling_gain']:.1f}x (paper 9x)")
        print(f"benefit-to-cost: {result['benefit_vs_metadata_used']:.0f}x live / "
              f"{result['benefit_vs_metadata_reserved']:.0f}x reserved "
              f"(paper 125.5x / 39x)")
    system.close()
    return result


def _best_fill(smoke: bool, batched: bool, device=None, geometry=None) -> dict:
    # the first invocation pays numpy/zlib warmup; min-of-two removes the
    # bias where it's cheap (smoke). The full config runs each mode once,
    # scalar first, so any residual warmup biases *against* the batched
    # speedup row rather than for it.
    runs = [run(verbose=False, smoke=smoke, batched=batched, device=device,
                geometry=geometry)
            for _ in range(2 if smoke else 1)]
    return min(runs, key=lambda r: r["fill_s"])


def rows(smoke: bool = False, device=None, geometry=None) -> list:
    r_scalar = _best_fill(smoke, batched=False, device=device,
                          geometry=geometry)
    r = _best_fill(smoke, batched=True, device=device, geometry=geometry)
    fill_speedup = r_scalar["fill_s"] / max(r["fill_s"], 1e-9)
    return [
        ("overcommit_elasticity", r["elasticity"], "paper>=0.50"),
        ("overselling_gain", r["overselling_gain"], "paper=9x"),
        ("benefit_vs_metadata_used", r["benefit_vs_metadata_used"], "paper=125.5x"),
        ("overcommit_fill_batched_speedup", fill_speedup,
         f"scalar={r_scalar['fill_s']:.2f}s_batched={r['fill_s']:.2f}s"),
        ("mean_swap_out_batch_mps", r["mean_swap_out_batch_mps"],
         f"batches={r['swap_out_batches']}"),
    ]


if __name__ == "__main__":
    run()
