"""Shared synthetic workload matching the paper's production page mix.

Paper Fig 15c: of all swapped MPs, 76.79% are zero pages and 23.21%
compressed with an average compression ratio of 47.63%. The generator
reproduces that mix so backend/latency benchmarks measure the same
distribution the paper reports.

Port: ``paper_mix_ms`` and ``fill_system`` are copies of
``benchmarks/workload.py`` and give its bytes from the same seed: the
draws per MP stay as they are (a vectorised draw would change the random
stream); only the 16-byte shuffle runs over a 1-D view. :class:`Geometry`
carries the size a benchmark runs at on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.config import TaijiConfig, size_mpool_reserve

ZERO_FRACTION = 0.7679
COMPRESS_TARGET = 0.4763


def paper_mix_ms(rng: np.random.Generator, ms_bytes: int,
                 mps_per_ms: int) -> bytes:
    """One MS worth of data with the paper's per-MP mix."""
    mp = ms_bytes // mps_per_ms
    out = bytearray()
    for _ in range(mps_per_ms):
        if rng.random() < ZERO_FRACTION:
            out += bytes(mp)
        else:
            # ~50%-compressible page: half structured, half random
            structured = np.full(mp // 2, rng.integers(0, 256), np.uint8)
            noise = rng.integers(0, 256, mp - mp // 2).astype(np.uint8)
            page = np.concatenate([structured, noise])
            # mix at 16B granularity: 16-byte rows shuffled as one 1-D
            # array of 16-byte items, the reference's permutation from the
            # same draws (a 2-D shuffle swaps row by row, ~30x slower)
            rng.shuffle(page.view("V16"))
            out += page.tobytes()
    return bytes(out)


def fill_system(system, n_ms: int, seed: int = 0):
    """Allocate + fill ``n_ms`` sections with paper-mix data.

    Returns {gfn: data} for later verification."""
    rng = np.random.default_rng(seed)
    space = system.guest
    payload = {}
    for _ in range(n_ms):
        g = space.alloc_ms()
        data = paper_mix_ms(rng, system.cfg.ms_bytes, system.cfg.mps_per_ms)
        space.write(g, data)
        payload[g] = data
    return payload


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A benchmark's size: ``managed_ms`` managed MSs of ``ms_bytes`` in
    ``mps_per_ms`` MPs (default: the paper's 2 MiB of 512 x 4 KiB), and
    the metadata reserve ``size_mpool_reserve`` gives them."""
    managed_ms: int
    ms_bytes: int = 2 * 1024 * 1024
    mps_per_ms: int = 512

    def apply(self, cfg: TaijiConfig) -> TaijiConfig:
        """``cfg`` at this size; its policy (overcommit, LRU, watermarks,
        scheduler, backend, swap) stays."""
        reserve = size_mpool_reserve(self.ms_bytes, self.mps_per_ms,
                                     self.managed_ms, cfg.overcommit_ratio)
        return dataclasses.replace(
            cfg, ms_bytes=self.ms_bytes, mps_per_ms=self.mps_per_ms,
            n_phys_ms=self.managed_ms + reserve, mpool_reserve_ms=reserve)


def sized(cfg: TaijiConfig, geometry) -> TaijiConfig:
    """``cfg`` as it is (the reference's size), or at ``geometry``."""
    return cfg if geometry is None else geometry.apply(cfg)
