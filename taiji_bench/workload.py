"""The benchmark's traffic generators, frozen here so that a change to the
program cannot change what it is measured on.

Copied, not imported:

* :func:`paper_mix_images` from ``chip_smoke.py::paper_mix_images`` (the
  vectorised form of ``repro_torch/benchmarks/workload.py::paper_mix_ms``):
  MS images with the paper's Fig 15c page mix, 76.79% zero MPs and the
  rest half one repeated byte, half random, shuffled at 16-byte grain
  (~48% compressible). The fill cycles through 64 distinct images, as
  ``chip_smoke.py``'s main phase does.
* :func:`zipf_weights` and :func:`next_mp` from
  ``repro_torch/benchmarks/fault_latency.py`` (the Zipf(1.2) MS popularity
  and the sequential MP cursor that wraps).

Every draw comes from ``numpy.random.default_rng`` seeded with the run's
seed and a fixed stream number, so the same seed gives the same inputs.
"""
from __future__ import annotations

import numpy as np

ZERO_FRACTION = 0.7679          # paper Fig 15c

# stream numbers: one generator per purpose, so adding a draw to one
# purpose leaves the others' inputs as they were
STREAM_IMAGES, STREAM_RANKS, STREAM_PAYLOADS, STREAM_GUEST = 1, 2, 3, 4
STREAM_SWAP, STREAM_SAMPLE, STREAM_PROMPTS = 5, 7, 8


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    """The generator of one purpose; ``seed`` may be any whole number up
    to a little over 2**31 (and beyond: it is split into 32-bit words)."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(stream), *map(int, more)]
    return np.random.default_rng(words)


def paper_mix_images(seed: int, n_img: int, mps: int, mp: int) -> np.ndarray:
    """``n_img`` distinct MS images of ``mps`` MPs of ``mp`` bytes, the
    paper's page mix, as an ``(n_img, mps * mp)`` uint8 array. Every image
    holds exactly ``round(ZERO_FRACTION * mps)`` zero MPs (393 of 512), at
    places the seed draws: every seed gets the same mix, in another order
    (``chip_smoke.py`` draws each MP's kind on its own)."""
    g = rng(seed, STREAM_IMAGES)
    imgs = np.zeros((n_img, mps, mp), dtype=np.uint8)
    n_zero = int(round(ZERO_FRACTION * mps))
    nz = np.argsort(g.random((n_img, mps)), axis=1) >= n_zero
    k = int(nz.sum())
    pages = np.empty((k, mp), dtype=np.uint8)
    pages[:, : mp // 2] = g.integers(0, 256, (k, 1), dtype=np.uint8)
    pages[:, mp // 2:] = g.integers(0, 256, (k, mp - mp // 2), dtype=np.uint8)
    order = np.argsort(g.random((k, mp // 16)), axis=1)
    pages = np.take_along_axis(pages.reshape(k, mp // 16, 16),
                               order[:, :, None], axis=1).reshape(k, mp)
    imgs[nz] = pages
    return imgs.reshape(n_img, mps * mp)


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Popularity of ranks 1..n under Zipf(s), normalised."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pop = 1.0 / ranks ** s
    return pop / pop.sum()


def popularity_order(seed: int, items) -> list:
    """``items`` in a seeded order: the first is the most popular."""
    items = list(items)
    perm = rng(seed, STREAM_RANKS).permutation(len(items))
    return [items[i] for i in perm]


def next_mp(cursor: dict, key, mps: int) -> int:
    """The sequential MP cursor of one MS: the next MP, wrapping."""
    mp = cursor.get(key, 0)
    cursor[key] = (mp + 1) % mps
    return mp


def guest_ops(seed: int, worker: int, n: int, n_ms: int, slots: int,
              write_share: float, n_payloads: int, zipf_s: float) -> dict:
    """``n`` guest accesses of one worker, drawn ahead: the MS rank
    (Zipf(``zipf_s``) over ``n_ms``), the 64-byte slot within the MP,
    whether it is a write, and the payload a write stores."""
    g = rng(seed, STREAM_GUEST, worker)
    return {"rank": g.choice(n_ms, size=n, p=zipf_weights(n_ms, zipf_s)).astype(np.int32),
            "slot": g.integers(0, slots, n, dtype=np.int32),
            "write": g.random(n) < write_share,
            "payload": g.integers(0, n_payloads, n, dtype=np.int32)}


def payloads(seed: int, n: int, nbytes: int) -> np.ndarray:
    """``n`` distinct random payloads of ``nbytes`` for guest writes."""
    return rng(seed, STREAM_PAYLOADS).integers(0, 256, (n, nbytes), dtype=np.uint8)
