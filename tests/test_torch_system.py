"""The slice as a whole: one seeded workload through the reference
``TaijiSystem`` and the port's (frames on the CPU device), compared with
``repro.fleet.harness.snapshot_diff`` -- the deterministic snapshot and
``backend.stats()`` must not differ -- and byte for byte on every read.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import config as RC  # noqa: E402
from repro.fleet.harness import snapshot_diff  # noqa: E402
from repro_torch.core import config as TC  # noqa: E402
from repro_torch.core.virt import NO_PFN, PhysicalMemory  # noqa: E402


def _paper_ms(rng, ms_bytes, mps):
    """One MS with the paper's page mix (benchmarks/workload.py)."""
    mp = ms_bytes // mps
    out = np.zeros((mps, mp), dtype=np.uint8)
    for i in range(mps):
        if rng.random() < 0.7679:
            continue
        page = np.concatenate([
            np.full(mp // 2, rng.integers(0, 256), np.uint8),
            rng.integers(0, 256, mp - mp // 2).astype(np.uint8)])
        rng.shuffle(page.reshape(-1, 16))
        out[i] = page
    return out.tobytes()


PROFILES = {
    "default": {},
    "legacy_scalar": {"hot_path": "legacy"},
    "scalar_swap": {"batch_mps": 0},
    "crc_off": {"crc": False},
    "small_batches": {"batch_mps": 3, "extent_max_rows": 2},
}


def _cfg(pkg, profile):
    mod = RC if pkg is R else TC
    opts = PROFILES[profile]
    hp = (mod.HotPathConfig.legacy_scalar() if opts.get("hot_path") == "legacy"
          else mod.HotPathConfig())
    return mod.small_test_config(
        swap=mod.SwapConfig(batch_mps=opts.get("batch_mps", 64), hot_path=hp,
                            batch_enabled=opts.get("batch_mps", 64) > 0),
        backend=mod.BackendConfig(crc_enabled=opts.get("crc", True),
                                  extent_max_rows=opts.get("extent_max_rows",
                                                           16)))


def _workload(system, seed):
    """Fill past physical capacity, reclaim in stepped mode, read a seeded
    subset (zero fast path, readahead, scalar loads), swap another subset
    in, free some MSs. Returns every byte read, in order."""
    cfg = system.cfg
    rng = np.random.default_rng(seed)
    guest = system.guest
    data, reads = {}, []
    for _ in range(int((cfg.n_phys_ms - cfg.mpool_reserve_ms) * 1.35)):
        g = guest.alloc_ms()
        data[g] = _paper_ms(rng, cfg.ms_bytes, cfg.mps_per_ms)
        guest.write(g, data[g])
    for _ in range(200):
        system.step_background()
        if system.phys.free_count >= system.watermark.low_ms \
                and not system.watermark.reclaiming:
            break
    gfns = sorted(data)
    for g in rng.choice(gfns, size=len(gfns) // 3, replace=False).tolist():
        mp = int(rng.integers(cfg.mps_per_ms))
        reads.append(guest.read(g, cfg.mp_bytes, off=mp * cfg.mp_bytes))
        reads.append(guest.read(g))
    for g in rng.choice(gfns, size=len(gfns) // 4, replace=False).tolist():
        system.engine.swap_in_ms(g)
    for g in rng.choice(gfns, size=len(gfns) // 5, replace=False).tolist():
        guest.free_ms(g)
        del data[g]
    system.step_background()
    reads.extend(guest.read(g) for g in sorted(data))
    assert reads[-len(data):] == [data[g] for g in sorted(data)]
    return reads


def _run(mod, profile, seed, **kw):
    s = mod.TaijiSystem(_cfg(mod, profile), **kw)
    try:
        reads = _workload(s, seed)
        return reads, s.snapshot()["deterministic"], s.backend.stats()
    finally:
        s.close()


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_workload_matches_reference(profile, seed):
    ref_reads, ref_snap, ref_stats = _run(R, profile, seed)
    port_reads, port_snap, port_stats = _run(T, profile, seed, device="cpu")
    assert snapshot_diff(ref_snap, port_snap) == []
    assert snapshot_diff(ref_stats, port_stats) == []
    assert port_reads == ref_reads
    m = port_snap["metrics"]
    assert m["ms_swapped_out"] > 0 and m["faults"] > 0
    assert m["crc_failures"] == 0


def _live_images(system):
    return {g: system.export_ms(g) for g in range(system.cfg.mpool_reserve_ms,
                                                  system.cfg.n_virt_ms)
            if int(system.virt.table.pfn[g]) != NO_PFN
            or system.reqs.lookup(g) is not None}


@pytest.mark.parametrize("seed", [2, 3])
def test_import_images_round_trips(seed):
    """A reference system's exported state loads into the port: every MS
    reads back byte-identical, and the port's deterministic snapshot is
    that of a second reference system fed the same images in order."""
    src = R.TaijiSystem(_cfg(R, "default"))
    try:
        _workload(src, seed)
        images = _live_images(src)
    finally:
        src.close()
    assert images and any(not res.all() for _, res in images.values())
    port = T.TaijiSystem(_cfg(T, "default"), device="cpu")
    twin = R.TaijiSystem(_cfg(R, "default"))
    try:
        moved = T.import_images(port, images)
        twin_moved = {g: twin.import_ms(*img) for g, img in images.items()}
        assert list(moved) == list(images) and moved == twin_moved
        for g, (rows, resident) in images.items():
            got_rows, got_res = port.export_ms(moved[g])
            np.testing.assert_array_equal(got_rows, rows)
            np.testing.assert_array_equal(got_res, resident)
            assert port.guest.read(moved[g]) == rows.tobytes()
            twin.export_ms(twin_moved[g])     # same counters on both sides
            assert twin.guest.read(twin_moved[g]) == rows.tobytes()
        assert snapshot_diff(twin.snapshot()["deterministic"],
                             port.snapshot()["deterministic"]) == []
        assert snapshot_diff(twin.backend.stats(), port.backend.stats()) == []
    finally:
        port.close()
        twin.close()


def test_port_export_is_reference_format():
    port = T.TaijiSystem(T.small_test_config(), device="cpu")
    ref = R.TaijiSystem(R.small_test_config())
    try:
        for s in (port, ref):
            g = s.guest.alloc_ms()
            s.guest.write(g, bytes(range(256)) * 8, off=64)
            s.engine.swap_out_mps(g, [0, 3])
        a, b = port.export_ms(g), ref.export_ms(g)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    finally:
        port.close()
        ref.close()


def test_no_device_means_the_card(monkeypatch):
    """Without a CUDA device and without ``device=``, construction raises
    instead of carrying on silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.small_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TaijiSystem(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PhysicalMemory(cfg)
    s = T.TaijiSystem(cfg, device="cpu")
    try:
        assert s.phys.frames.device.type == "cpu"
        assert s.phys.frames.dtype == torch.uint8
        # the metadata arena is its own host buffer, not the frames' head
        arena = s.phys.mpool_arena()
        assert isinstance(arena, np.ndarray)
        assert arena.nbytes == cfg.mpool_reserve_ms * cfg.ms_bytes
        assert s.phys.frames.numel() == cfg.n_phys_ms * cfg.ms_bytes
        assert s.phys.free_count == cfg.n_phys_ms - cfg.mpool_reserve_ms
    finally:
        s.close()


def test_config_pickles_like_the_reference():
    a, b = R.small_test_config(), T.small_test_config()
    assert dataclasses.asdict(pickle.loads(pickle.dumps(b))) == \
        dataclasses.asdict(a)


@pytest.mark.parametrize("sibling_bad", [False, True])
def test_readahead_salvage_matches_reference(sibling_bad):
    """A whole-extent CRC that fails sends readahead to per-row salvage
    against the record CRCs: good rows publish, a corrupt sibling stays
    swapped out. The port checks rows on the host before its one copy to
    the device; counters and bytes must be the reference's."""
    out = {}
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        s = pkg.TaijiSystem(_cfg(pkg, "default"), **kw)
        try:
            cfg = s.cfg
            mp = cfg.mp_bytes
            data = b"".join(bytes([i + 1]) * (mp // 2) + bytes(range(256)) * (mp // 512)
                            for i in range(cfg.mps_per_ms))
            g = s.guest.alloc_ms()
            s.guest.write(g, data)
            s.engine.swap_out_ms(g)
            ext = next(e for (gg, _), e in s.backend._extents.items() if gg == g)
            ext.crc ^= 1                      # whole-extent check fails
            rec = s.reqs.lookup(g).record
            if sibling_bad:
                rec.crc[ext.mps[-1]] ^= 1     # one sibling is corrupt too
            first = s.guest.read(g, mp, off=ext.mps[0] * mp)
            swapped = rec.swapped_out_indices().tolist()
            out[pkg.__name__] = (first, swapped,
                                 s.snapshot()["deterministic"],
                                 s.backend.stats())
        finally:
            s.close()
    ref, port = out["repro.core"], out["repro_torch.core"]
    assert port[0] == ref[0]
    assert port[1] == ref[1] and (len(ref[1]) == 1) == sibling_bad
    assert snapshot_diff(ref[2], port[2]) == []
    assert snapshot_diff(ref[3], port[3]) == []
