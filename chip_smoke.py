#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--managed-ms 16384] [--seed 0]

Phases, each fatal on failure (exit code 1):

1. build   -- compile ``csrc/swap_kernels.cu`` with nvcc for sm_90a and
              print the card's name and power limit;
2. kernels -- hold each of the four swap kernels against its plain
              PyTorch version on the card (exact equality) at the
              main-path shapes and at ragged shapes, and time kernel,
              plain version and library call;
3. main    -- Taiji's swap data path at the paper's deployment size
              (2 MiB MS, 4 KiB MP, ``--managed-ms`` managed MSs of guest
              frames in HBM, +50% elastic): fill past physical memory,
              reclaim, passive faults, active swap-in, hv_sched
              background reclaim under guest traffic, then every live MS
              checked byte for byte;
4. corrupt -- a flipped extent tag must raise CorruptionError from the
              device-side check.

The last two lines of standard output are the kernel table and the
device line as JSON. No card, or no ``src/repro_torch`` beside this
file: a non-zero exit and no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks: HBM bandwidth (NVIDIA data sheet) and the INT32 rate
# of the integer kernels' operation bound. The data sheet lists no INT32
# rate; a Hopper SM has 64 INT32 lanes against 128 FP32 lanes (H100
# architecture whitepaper), so it is half the sheet's 67 T/s float32
# rate, a multiply-add counted as two operations as there
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

# paper Fig 15c page mix, as benchmarks/workload.py
ZERO_FRACTION = 0.7679
# distinct MS images the workload cycles through
N_IMAGES = 64
# MSs read per passive-fault window: ~400 faults each, so a window stays
# inside the 200k-sample latency reservoir and the percentiles cover
# every fault of the phase
PASSIVE_WINDOW_MS = 128

KERNELS = {
    # name: (ops counter, TPU kernel it replaces)
    "gather_rows": ("gather", "src/repro/kernels/swap_copy.py:40"),
    "scatter_rows_": ("scatter", "src/repro/kernels/swap_copy.py:69"),
    "zero_rows": ("zero", "src/repro/kernels/zero_detect.py:42"),
    "fletcher_rows": ("fletcher", "src/repro/kernels/crc32c.py:60"),
}
SOURCE = "src/repro_torch/csrc/swap_kernels.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound_us(nbytes: int, nops: int) -> tuple:
    b = nbytes / HBM_BYTES_PER_S * 1e6
    o = nops / INT32_OPS_PER_S * 1e6
    return (b, "bytes") if b >= o else (o, "operations")


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
    # rows (4100 bytes: no 16-byte alignment) and one past the 65521 wrap
    copy_shapes = [("main64", 512, 4096, 64), ("main13", 512, 4096, 13),
                   ("ragged", 37, 4100, 11)]
    row_shapes = [("main64", 64, 4096), ("main16", 16, 4096),
                  ("ragged", 16, 4100), ("wrap", 3, 70001)]

    # gather
    err = 0.0
    for label, n_pool, elems, k in copy_shapes:
        pool, idx = rows(n_pool, elems), perm(n_pool, k)
        got = ops.gather_rows(pool, idx)
        want = ref.gather_blocks(pool, torch.from_numpy(idx).to(dev))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_rows != plain at {label} {(n_pool, elems, k)}")
        err = max(err, max_err(got, want))
    pool, idx = rows(512, 4096), perm(512, 64)
    idx_dev = torch.from_numpy(idx).to(dev)
    out = torch.empty((64, 4096), dtype=torch.uint8, device=dev)
    results["gather_rows"] = dict(
        shape="pool (512, 4096) uint8, 64 indices", max_abs_err=err,
        kernel_us=time_us(torch, lambda: ops.launch_gather(pool, idx_dev, out)),
        plain_us=time_us(torch, lambda: ref.gather_blocks(pool, idx_dev)),
        library_us=time_us(torch, lambda: torch.index_select(pool, 0, idx_dev)),
        bound=bound_us(2 * 64 * 4096 + 8 * 64, 0))

    # scatter (in place: untouched rows must keep their bytes)
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
        kernel_us=time_us(torch, lambda: ops.launch_scatter(pool, idx_dev, blocks)),
        plain_us=time_us(torch, lambda: ref.scatter_blocks_(pool, idx_dev, blocks)),
        library_us=time_us(torch, lambda: pool.index_copy_(0, idx_dev, blocks)),
        bound=bound_us(2 * 64 * 4096 + 8 * 64, 0))

    # zero scan: every third row zero, plus rows zero but for their last byte
    err = 0.0
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
    x = rows(64, 4096, zero_every=3)
    zout = torch.empty(64, dtype=torch.bool, device=dev)
    results["zero_rows"] = dict(
        shape="(64, 4096) uint8", max_abs_err=err,
        kernel_us=time_us(torch, lambda: ops.launch_zero(x, zout)),
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
    results["fletcher_rows"] = dict(
        shape="(64, 4096) uint8", max_abs_err=err,
        kernel_us=time_us(torch, lambda: ops.launch_fletcher(x, fout)),
        plain_us=time_us(torch, lambda: ref.fletcher_checksum(x)),
        library_us=None,
        # two sums of one multiply-add each per byte
        bound=bound_us(64 * 4096 + 4 * 64, 4 * 64 * 4096))

    for name, r in results.items():
        log(json.dumps({"kernel": name, "shape": r["shape"],
                        "equal_to_plain": True, "tolerance": 0,
                        "kernel_us": r["kernel_us"], "plain_us": r["plain_us"],
                        "bound_us": r["bound"][0], "bound_by": r["bound"][1],
                        "library_us": r["library_us"]}))
    return results


# ------------------------------------------------------------- main path
def per_ms(now: dict, before: dict, n_ms: int) -> dict:
    return {k: (now[k] - before[k]) / n_ms for k in now} if n_ms else {}


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


def main_path(torch, np, core, ops, managed: int, seed: int):
    from repro_torch.core.config import (BackendConfig, HotPathConfig,
                                         SwapConfig, TaijiConfig,
                                         size_mpool_reserve)
    from repro_torch.core.virt import NO_PFN

    ms_bytes, mps = 2 * 1024 * 1024, 512
    reserve = size_mpool_reserve(ms_bytes, mps, managed, 0.5)
    cfg = TaijiConfig(
        ms_bytes=ms_bytes, mps_per_ms=mps, n_phys_ms=managed + reserve,
        mpool_reserve_ms=reserve, overcommit_ratio=0.5,
        backend=BackendConfig(compression_level=1, extent_max_rows=16,
                              crc_enabled=True),
        swap=SwapConfig(batch_mps=64,
                        hot_path=HotPathConfig(compress_workers=4)))
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

    # 3. active swap-in
    in0, l0 = m.mp_swapped_in, dict(ops.launches)
    t0 = time.perf_counter()
    for g in active:
        s.engine.swap_in_ms(g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    phases.update(swap_in_s=dt,
                  swap_in_mp_per_s=(m.mp_swapped_in - in0) / dt,
                  launches_per_ms_swapped_in=per_ms(ops.launches, l0,
                                                    len(active)))
    log(f"main: active swap-in {len(active)} MSs, "
        f"{m.mp_swapped_in - in0} MPs in {dt:.1f} s")

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
    launches = dict(ops.launches)
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
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    log(json.dumps({"main_path": {
        "frames_gib": frames_gib, "managed_ms": managed,
        "reserve_ms": reserve, "live_ms": len(want), **phases,
        "counters": counters, "launches": launches}}))
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--managed-ms", type=int, default=16384,
                    help="managed 2 MiB MSs of guest frames in HBM "
                         "(16384 = the paper's 32 GiB)")
    ap.add_argument("--seed", type=int, default=0)
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

    # 1. build
    t0 = time.perf_counter()
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

    # 3. main path, 4. corruption
    s, launches = main_path(torch, np, core, ops, args.managed_ms, args.seed)
    try:
        corruption(torch, np, s, core)
    finally:
        s.close()

    rows = []
    for name, (counter, replaces) in KERNELS.items():
        r = timed[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[counter],
            "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
            "bound_ms": r["bound"][0] / 1e3, "bound_by": r["bound"][1],
            "library_ms": (None if r["library_us"] is None
                           else r["library_us"] / 1e3)})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
