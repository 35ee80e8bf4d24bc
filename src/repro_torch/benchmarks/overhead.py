"""Virtualization / elasticity overhead -- paper Fig 11 / 12 + §5.2.2.

Paper: CPU+memory benchmarks within 3% of native; cloud workloads within
~3-5%; metadata overhead 0.38% live / 1.2% reserved.

Our data plane is a decode step whose tensors Taiji does not touch
(block tables are native inputs), so the analogue of the paper's
"benchmark under virtualization" is: (a) decode step time with the
elastic manager active vs. absent, and (b) the translated-access penalty
on the host control path (direct frame read vs. block-table translated).

Port: a copy of ``benchmarks/overhead.py`` over the port's
``serve_step``, waiting for the card where the tensors live there.
``run`` takes the window counts (``pairs``, ``traced_pairs``, ``iters``;
the reference's 16, 10 and 150 by default), an optional ``model`` with
its ``cfg`` (default: reduced qwen3-4b from seed 0), ``device`` and the
managers' ``geometry`` (:class:`~.workload.Geometry`). Every window
starts from the same empty cache, sized to hold every position the
window writes (the reference decodes past its 64-position cache). On
the card a direct read is one device-to-host copy, as a translated read
is, so ``host_overhead_x`` is near 1 there.
"""
from __future__ import annotations

import gc
import random
import time

import torch

from ..configs.reduce import reduced_config
from ..core.config import ObsConfig, small_test_config
from ..core.system import TaijiSystem
from ..core.virt import frame_bytes, resolve_device
from ..models import model as M
from ..train.steps import serve_step
from .workload import sized

# the batch every window decodes, as the reference
BATCH = 4
# decode steps of each warm-up window (fewer where ``iters`` is smaller)
WARM_ITERS = 100


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _time_decode(step, params, tok, cache, iters=30):
    logits, c = step(params, tok, cache)
    _sync(logits)
    t0 = time.perf_counter()
    for _ in range(iters):
        logits, c = step(params, tok, c)
    _sync(logits)
    return (time.perf_counter() - t0) / iters


def run(verbose: bool = True, *, device=None, model=None, cfg=None,
        pairs: int = 16, traced_pairs: int = 10, iters: int = 150,
        geometry=None) -> dict:
    # (a) data-plane step: native vs with an active elastic manager
    device = resolve_device(device)
    if model is None:
        cfg = cfg or reduced_config("qwen3-4b")
        model = M.init_params(cfg, seed=0, device=device)
    warm_iters = min(WARM_ITERS, iters)
    bt = cfg.kv_block_tokens
    max_seq = -(-(max(iters, warm_iters) + 1) // bt) * bt
    cache = M.init_cache(cfg, BATCH, max_seq, device=device)
    tok = torch.zeros((BATCH,), dtype=torch.int32, device=device)

    def step(p, t, c):
        return serve_step(p, t, c, cfg)

    # native vs live-manager decode, untraced and with stage tracing on
    # (repro_torch.obs), as TRIMMED MEANS OF PAIRED ADJACENT LONG-WINDOW
    # RATIOS. Three things poison a min-of-short-windows comparison on a
    # shared host, and the design below answers each:
    #   1. The first TaijiSystem constructed in a process runs its
    #      manager-live decode slow for that system's lifetime (a
    #      warm-up pathology that a fresh system clears). -> a
    #      sacrificial warm-up system + decode burst runs first, and
    #      every measured window uses a fresh short-lived system.
    #   2. Machine weather (co-tenant CPU steal) shifts the whole floor
    #      on a 1-3 s timescale, so any comparison whose two sides sit
    #      seconds apart is hostage to it. -> each ratio pairs two
    #      ADJACENT windows (mean-of-iters, which averages spike
    #      outliers instead of gambling a min on them), the in-pair
    #      order alternates and the settle jitters so a periodic
    #      co-tenant cannot phase-lock onto one side, and a trimmed mean
    #      over the pairs absorbs the pairs a weather edge still split.
    #   3. The tracer tax is a second-order effect; dividing two noisy
    #      native-relative ratios doubled its noise. -> it gets its own
    #      directly-paired loop (traced vs untraced manager, adjacent).
    # The settle before each elastic window lets the scheduler's idle
    # backoff engage (cycle_ms=2, ramp to 16x over ~5 idle cycles):
    # production managers are long-lived, so steady-state is the honest
    # comparison. GC is parked during the timed region so collection
    # pauses land between windows, not inside one.
    rng = random.Random(0)

    def _trimmed(xs, k):
        xs = sorted(xs)[k:len(xs) - k]
        return sum(xs) / len(xs)

    def _elastic_window(traced, settle):
        system = TaijiSystem(
            sized(small_test_config(obs=ObsConfig(enabled=traced)), geometry),
            device=device)
        system.start_background()   # manager live: BACK tasks running
        time.sleep(settle)
        t = _time_decode(step, model, tok, cache, iters=iters)
        system.stop_background()
        system.close()
        return t

    gc.collect()
    gc.disable()
    try:
        warm = TaijiSystem(sized(small_test_config(), geometry), device=device)
        warm.start_background()
        time.sleep(0.5)
        for _ in range(4):
            _time_decode(step, model, tok, cache, iters=warm_iters)
        warm.stop_background()
        warm.close()

        ratios, traced_ratios = [], []
        t_native = t_elastic = t_elastic_traced = float("inf")
        for i in range(pairs):
            settle = rng.uniform(0.2, 0.35)
            if i % 2 == 0:
                t_e = _elastic_window(False, settle)
                t_n = _time_decode(step, model, tok, cache, iters=iters)
            else:
                t_n = _time_decode(step, model, tok, cache, iters=iters)
                t_e = _elastic_window(False, settle)
            ratios.append(t_e / t_n)
            t_native = min(t_native, t_n)
            t_elastic = min(t_elastic, t_e)
        for i in range(traced_pairs):
            settle = rng.uniform(0.2, 0.35)
            if i % 2 == 0:
                t_t = _elastic_window(True, settle)
                t_e = _elastic_window(False, settle)
            else:
                t_e = _elastic_window(False, settle)
                t_t = _elastic_window(True, settle)
            traced_ratios.append(t_t / t_e)
            t_elastic_traced = min(t_elastic_traced, t_t)
    finally:
        gc.enable()
    # The warm-up pathology of item 1 recurs at random on a minority of
    # fresh systems, far outside both the true steady-state cost and
    # weather splits of an adjacent pair. Pairs beyond the 1.15 cutoff
    # are excluded as pathological -- but ONLY while they are a
    # minority: a real regression that slowed the steady state >15%
    # would push most pairs over the cutoff and be kept wholesale.
    def _screen(xs, lo, hi):
        kept = [r for r in xs if lo < r < hi]
        return kept if len(kept) >= (len(xs) + 1) // 2 else xs

    ratios = _screen(ratios, 0.0, 1.15)
    traced_ratios = _screen(traced_ratios, 0.85, 1.15)
    # trim ~20% per side of whatever survived the screen
    decode_overhead = _trimmed(ratios, min(len(ratios) // 5,
                                           (len(ratios) - 1) // 2)) - 1.0
    tracer_overhead = _trimmed(
        traced_ratios, min(len(traced_ratios) // 5,
                           (len(traced_ratios) - 1) // 2)) - 1.0

    # (b) host access path: direct frame read vs block-table translation
    s = TaijiSystem(sized(small_test_config(), geometry), device=device)
    space = s.guest
    g = space.alloc_ms()
    n = 20000
    buf = s.phys.ms_view(int(s.virt.table.pfn[g]))
    t0 = time.perf_counter()
    for _ in range(n):
        frame_bytes(buf[:64])
    t_direct = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(n):
        space.read(g, 64)
    t_translated = (time.perf_counter() - t0) / n
    # batched access path: the same 64B reads issued through read_many in
    # vectors of 64 -- bounds/residency/observer dispatch amortized over
    # the batch (the per-access cost upper layers actually pay when they
    # use the batch API)
    batch = [(g, 0, 64)] * 64
    n_batches = max(1, n // 64)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        space.read_many(batch)
    t_batched = (time.perf_counter() - t0) / (n_batches * 64)
    s.close()

    # translated access with the span tracer recording (one guest_access
    # span per read, flushed every ring_capacity pushes)
    s = TaijiSystem(sized(small_test_config(obs=ObsConfig(enabled=True)),
                          geometry), device=device)
    space = s.guest
    g = space.alloc_ms()
    t0 = time.perf_counter()
    for _ in range(n):
        space.read(g, 64)
    t_translated_traced = (time.perf_counter() - t0) / n
    s.close()

    result = {
        "decode_native_ms": t_native * 1e3,
        "decode_elastic_ms": t_elastic * 1e3,
        "decode_overhead": decode_overhead,
        "tracer_overhead": tracer_overhead,
        "decode_traced_ms": t_elastic_traced * 1e3,
        "host_direct_us": t_direct * 1e6,
        "host_translated_us": t_translated * 1e6,
        "host_translated_traced_us": t_translated_traced * 1e6,
        "host_batched_us": t_batched * 1e6,
        "host_overhead_x": t_translated / max(t_direct, 1e-12),
    }
    if verbose:
        print(f"decode step: native {result['decode_native_ms']:.2f} ms, "
              f"with manager {result['decode_elastic_ms']:.2f} ms "
              f"(overhead {result['decode_overhead']*100:+.1f}%; paper <5%), "
              f"traced {result['decode_traced_ms']:.2f} ms "
              f"(tracer {result['tracer_overhead']*100:+.1f}%)")
        print(f"host access: direct {result['host_direct_us']:.2f} us, "
              f"translated {result['host_translated_us']:.2f} us "
              f"(traced {result['host_translated_traced_us']:.2f} us), "
              f"batched {result['host_batched_us']:.2f} us/access")
    return result


def rows_from(r: dict) -> list:
    """The module's rows from one :func:`run` result."""
    return [
        ("decode_overhead_frac", r["decode_overhead"], "paper<0.05"),
        # span-tracer cost on the decode workload (manager live, tracing
        # on vs off, directly paired). The trimmed-mean estimate can come
        # out slightly negative on a noisy box; clamp the reported row at
        # 0.0 so a gate compares against a monotone value, and keep the
        # raw signed measurement in derived
        ("tracer_overhead_frac", max(0.0, r["tracer_overhead"]),
         f"raw={r['tracer_overhead']:+.5f}_"
         f"host_traced={r['host_translated_traced_us']:.2f}us_target<0.05"),
        ("host_translated_access_us", r["host_translated_us"],
         f"direct={r['host_direct_us']:.2f}us"),
        ("host_batched_access_us", r["host_batched_us"],
         "read_many_64x64B"),
    ]


def rows(smoke: bool = False, device=None) -> list:
    """``smoke``: 4 pairs, 2 traced pairs, 30-step windows (the
    reference's ``rows`` always runs 16, 10 and 150)."""
    windows = dict(pairs=4, traced_pairs=2, iters=30) if smoke else {}
    return rows_from(run(verbose=False, device=device, **windows))


if __name__ == "__main__":
    run()
