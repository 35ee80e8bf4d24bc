"""The port's BackendStore against the reference's, on the same batches.

The reference runs with ``pallas_kernels=True`` (interpret mode, as in
tests/test_kernels_backend.py), so it tags extent rows too; the port runs
on the CPU device, where its wrappers take the plain versions. Every
comparison is exact: kinds, CRCs, stored extent bytes and tags, the
compressed map, counters and ``stats()``, then the round trip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backend as rb  # noqa: E402
from repro.core import config as rc  # noqa: E402
from repro.core.errors import CorruptionError as RefCorruption  # noqa: E402
from repro.core.metrics import Metrics as RefMetrics  # noqa: E402
from repro_torch.core import backend as tb  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core.errors import CorruptionError  # noqa: E402
from repro_torch.core.metrics import Metrics  # noqa: E402

MS_BYTES, MPS = 32 * 1024, 32

PROFILES = {
    "default": {},
    "crc_off": {"crc_enabled": False},
    "zero_page_off": {"zero_page_enabled": False},
    "rows4": {"extent_max_rows": 4},
    "serial": {"workers": 0},
    "disk": {"disk": True},
}


def _cfgs(profile, tmp_path):
    """The same configuration built from each package's config module."""
    opts = dict(PROFILES[profile])
    workers = opts.pop("workers", 4)
    disk = opts.pop("disk", False)
    out = []
    for mod, tag in ((rc, "ref"), (tc, "port")):
        be = {"extent_max_rows": 8, **opts}
        if disk:
            be["disk_fallback_path"] = str(tmp_path / f"disk-{tag}.bin")
        out.append(mod.small_test_config(
            ms_bytes=MS_BYTES, mps_per_ms=MPS,
            backend=mod.BackendConfig(**be),
            swap=mod.SwapConfig(hot_path=mod.HotPathConfig(
                pallas_kernels=(tag == "ref"), compress_workers=workers))))
    return out


def _stores(profile, tmp_path):
    ref_cfg, port_cfg = _cfgs(profile, tmp_path)
    ref = rb.BackendStore(ref_cfg, RefMetrics())
    port = tb.BackendStore(port_cfg, Metrics(), device="cpu")
    return ref, port


def _paper_batch(seed, k, mp):
    """Paper-like rows: zero, compressible, incompressible."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((k, mp), dtype=np.uint8)
    for i in range(k):
        r = rng.random()
        if r < 0.5:
            continue                                  # zero page
        if r < 0.85:
            rows[i] = np.tile(rng.integers(1, 256, 64, dtype=np.uint8),
                              mp // 64)               # compressible
        else:
            rows[i] = rng.integers(0, 256, mp, dtype=np.uint8)  # random
    return rows


def _extents(store, gfn):
    return {eid: (e.payload, e.is_raw, e.stored_len, list(e.mps), e.crc,
                  None if e.tags is None else e.tags.tolist())
            for (g, eid), e in store._extents.items() if g == gfn}


def _state(store, gfn):
    return (_extents(store, gfn),
            {k: v for k, v in store._compressed.items() if k[0] == gfn},
            dict(store._disk_offsets),
            store.metrics.deterministic_snapshot(), store.stats(),
            store.stored_bytes())


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("seed,k", [(1, 32), (2, 7), (3, 64)])
def test_store_and_load_batch_match_reference(profile, seed, k, tmp_path):
    ref, port = _stores(profile, tmp_path)
    try:
        mp = ref.cfg.mp_bytes
        data = _paper_batch(seed, k, mp)
        mps = np.random.default_rng(seed).permutation(max(k, MPS))[:k]
        gfn = 900 + seed
        rk, rcrc = ref.store_batch(gfn, mps, data.copy())
        pk, pcrc = port.store_batch(gfn, mps, torch.from_numpy(data.copy()))
        np.testing.assert_array_equal(pk, rk)
        np.testing.assert_array_equal(pcrc, rcrc)
        assert _state(port, gfn) == _state(ref, gfn)

        out_ref = np.zeros_like(data)
        out_port = torch.full(data.shape, 0xA5, dtype=torch.uint8)
        ref.load_batch(gfn, mps, rk, rcrc, out_ref)
        port.load_batch(gfn, mps, pk, pcrc, out_port)
        np.testing.assert_array_equal(out_ref, data)
        np.testing.assert_array_equal(out_port.numpy(), data)
        assert _state(port, gfn) == _state(ref, gfn)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("seed", [4, 5])
def test_flipped_extent_tag_raises_in_both(seed, tmp_path):
    ref, port = _stores("default", tmp_path)
    try:
        data = _paper_batch(seed, 24, ref.cfg.mp_bytes)
        data[1] = np.tile(np.arange(1, 65, dtype=np.uint8), ref.cfg.mp_bytes // 64)
        mps = np.arange(24)
        kinds, crcs = ref.store_batch(7, mps, data.copy())
        port.store_batch(7, mps, torch.from_numpy(data.copy()))
        for store in (ref, port):
            ext = next(e for (g, _), e in store._extents.items() if g == 7)
            ext.tags[0] ^= 1
        with pytest.raises(RefCorruption, match="extent tag mismatch"):
            ref.load_batch(7, mps, kinds, crcs, np.zeros_like(data))
        out = torch.zeros(data.shape, dtype=torch.uint8)
        with pytest.raises(CorruptionError, match="extent tag mismatch"):
            port.load_batch(7, mps, kinds, crcs, out)
        assert not out.any()                  # nothing written on failure
        assert port.metrics.crc_failures == ref.metrics.crc_failures == 1
        assert _state(port, 7) == _state(ref, 7)      # nothing consumed
    finally:
        ref.close()
        port.close()


def test_flipped_record_crc_raises_in_both(tmp_path):
    ref, port = _stores("default", tmp_path)
    try:
        data = _paper_batch(6, 16, ref.cfg.mp_bytes)
        data[3] = 9
        mps = np.arange(16)
        kinds, crcs = ref.store_batch(8, mps, data.copy())
        port.store_batch(8, mps, torch.from_numpy(data.copy()))
        bad = crcs.copy()
        bad[3] ^= 1
        with pytest.raises(RefCorruption, match="CRC mismatch"):
            ref.load_batch(8, mps, kinds, bad, np.zeros_like(data))
        with pytest.raises(CorruptionError, match="CRC mismatch"):
            port.load_batch(8, mps, kinds, bad,
                            torch.zeros(data.shape, dtype=torch.uint8))
        assert _state(port, 8) == _state(ref, 8)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("row", ["zero", "compressible", "random"])
def test_scalar_store_and_load_match_reference(row, tmp_path):
    ref, port = _stores("default", tmp_path)
    try:
        mp = ref.cfg.mp_bytes
        data = {"zero": np.zeros(mp, np.uint8),
                "compressible": np.tile(np.arange(64, dtype=np.uint8), mp // 64),
                "random": np.random.default_rng(9).integers(
                    0, 256, mp, dtype=np.uint8)}[row]
        rk = ref.store(3, 5, data.copy())
        pk = port.store(3, 5, data.copy())
        assert pk == rk
        assert _state(port, 3) == _state(ref, 3)
        out_ref = np.zeros(mp, np.uint8)
        out_port = torch.full((mp,), 0xA5, dtype=torch.uint8)
        ref.load(3, 5, rk[0], rk[1], out_ref)
        port.load(3, 5, pk[0], pk[1], out_port)
        np.testing.assert_array_equal(out_port.numpy(), data)
        assert _state(port, 3) == _state(ref, 3)
    finally:
        ref.close()
        port.close()


def test_config_is_field_for_field_the_reference():
    for make in ("small_test_config", "TaijiConfig"):
        a = getattr(rc, make)()
        b = getattr(tc, make)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(rc.HotPathConfig)] == \
        [f.name for f in dataclasses.fields(tc.HotPathConfig)]
