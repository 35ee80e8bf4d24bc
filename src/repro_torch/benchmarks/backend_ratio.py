"""Backend composition + compression ratio -- paper Fig 15c.

Paper: 76.79% zero pages / 23.21% compressed, 47.63% compression ratio,
swapped pages stored in 1.73 GB for 15.6 GB freed.

Port: a copy of ``benchmarks/backend_ratio.py``. ``device`` holds the
frames (``None``: the card; ``"cpu"`` for parity runs); ``geometry``
(:class:`~.workload.Geometry`) sizes the system. Every MS goes out
through ``swap_out_ms``: on the card, the compacting gather and Fletcher.
"""
from __future__ import annotations

from ..core.config import LRUConfig, TaijiConfig
from ..core.system import TaijiSystem
from .workload import fill_system, sized


def run(verbose: bool = True, *, device=None, geometry=None) -> dict:
    cfg = sized(TaijiConfig(ms_bytes=128 * 1024, mps_per_ms=32, n_phys_ms=40,
                            overcommit_ratio=0.5, mpool_reserve_ms=4,
                            lru=LRUConfig(stabilize_scans=1, workers=1)),
                geometry)
    system = TaijiSystem(cfg, device=device)
    fill_system(system, cfg.n_virt_ms - cfg.mpool_reserve_ms, seed=11)
    # swap everything out to measure the full backend composition
    for _ in range(4):
        system.lru.scan_shard(0, 1)
    for gfn in list(system.lru.pick_coldest_any(10_000)):
        try:
            system.engine.swap_out_ms(gfn)
        except Exception:
            pass
    m = system.metrics
    total = m.backend_zero_mps + m.backend_compressed_mps
    result = {
        "zero_fraction": m.backend_zero_mps / max(1, total),
        "compressed_fraction": m.backend_compressed_mps / max(1, total),
        "compression_ratio": m.compression_ratio(),
        "raw_bytes": m.backend_raw_bytes,
        "stored_bytes": m.backend_stored_bytes,
    }
    if verbose:
        print(f"zero={result['zero_fraction']*100:.2f}% (paper 76.79%)  "
              f"compressed={result['compressed_fraction']*100:.2f}% (paper 23.21%)")
        print(f"compression ratio={result['compression_ratio']*100:.2f}% "
              f"(paper 47.63%)")
    system.close()
    return result


def rows(device=None, geometry=None) -> list:
    r = run(verbose=False, device=device, geometry=geometry)
    return [
        ("backend_zero_fraction", r["zero_fraction"], "paper=0.7679"),
        ("backend_compression_ratio", r["compression_ratio"], "paper=0.4763"),
    ]


if __name__ == "__main__":
    run()
