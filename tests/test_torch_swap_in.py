"""The swap-in's verified write (``ops.scatter_verified_rows_``) and the
load path that goes through it, against the reference.

On the CPU the wrapper runs its plain version
(``ref.scatter_verified_blocks_``), held exactly against the reference's
Fletcher oracle (``repro.kernels.ref.fletcher_checksum``) and its Pallas
``scatter_blocks`` in interpret mode, as tests/test_kernels.py runs it:
with every tag matching, the pool is the Pallas scatter's with the zero
rows zeroed; with any tag differing, nothing is written and the first
such staged row comes back. ``BackendStore.load_batch`` writing straight
into frame rows (``rows=``) must leave the bytes, the backend's state and
its metrics the reference's; a partial swap-in of a seeded system must
leave the reference's deterministic snapshot. The ``cuda`` tests hold the
kernel against the plain version on the card and check that a swap-in
chunk is one launch and one host wait with no index upload and no
separate Fletcher pass; they skip without a card and need neither JAX nor
the reference (``python -m pytest -m cuda tests/test_torch_swap_in.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import repro_torch.core as T  # noqa: E402
from repro_torch.core import backend as tb  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core.errors import CorruptionError  # noqa: E402
from repro_torch.core.metrics import Metrics  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

try:
    import jax.numpy as jnp
    import repro.core as R
    from repro.core import backend as rb
    from repro.core import config as rc
    from repro.core.errors import CorruptionError as RefCorruption
    from repro.core.metrics import Metrics as RefMetrics
    from repro.fleet.harness import snapshot_diff
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:       # a card's machine without JAX: the cuda tests only
    jnp = R = rb = rc = RefCorruption = RefMetrics = snapshot_diff = None
    jops = jref = None

needs_reference = pytest.mark.skipif(jnp is None, reason="needs JAX and the reference")

# (n_pool, elems, staged rows, zero rows): the main-path chunk of a
# (512, 4096) frame, a few rows, rows the Pallas kernel cannot tile (no
# multiple of 128 bytes), zero rows only, no data rows at all
CASES = {
    "chunk64": (512, 4096, 64, 16),
    "few": (32, 1024, 5, 3),
    "ragged": (37, 4100, 11, 4),
    "zero_only": (64, 512, 0, 9),
    "nothing": (16, 256, 0, 0),
}


def _case(label, seed=0):
    """A seeded pool, staged rows with their destinations (every fourth
    row verified only) and expected tags (every third row untagged), and
    zero rows disjoint from the destinations."""
    n_pool, elems, k, z = CASES[label]
    rng = np.random.default_rng([sorted(CASES).index(label), seed])
    pool = rng.integers(0, 256, (n_pool, elems), dtype=np.uint8)
    stage = rng.integers(0, 256, (k, elems), dtype=np.uint8)
    stage[::5] = 0
    rows = rng.permutation(n_pool)
    dst = rows[:k].astype(np.int64)
    dst[3::4] = -1
    zero = rows[k:k + z].astype(np.int64)
    tags = (ref.fletcher_checksum(torch.from_numpy(stage)).numpy().astype(np.int64)
            if k else np.zeros(0, np.int64))
    tags[2::3] = -1
    return pool, stage, dst, tags, zero


def _oracle_tags(stage):
    return np.asarray(jref.fletcher_checksum(jnp.asarray(stage))).astype(np.int64)


def _pallas_write(pool, stage, dst, zero):
    """The reference's write: Pallas scatter_blocks of the rows with a
    destination (interpret mode), then the zero rows."""
    w = dst >= 0
    out = pool.copy()
    if w.any():
        if pool.shape[1] % 128 == 0:
            out = np.array(jops.scatter_blocks(
                jnp.asarray(pool), jnp.asarray(dst[w], jnp.int32),
                jnp.asarray(stage[w])))
        else:                         # rows the Pallas kernel cannot tile
            out = np.array(jref.scatter_blocks(
                jnp.asarray(pool), jnp.asarray(dst[w]), jnp.asarray(stage[w])))
    out[zero] = 0
    return out


@needs_reference
def test_verified_write_matches_reference():
    for label in sorted(CASES):
        pool, stage, dst, tags, zero = _case(label)
        if len(stage):
            has = tags >= 0
            np.testing.assert_array_equal(tags[has], _oracle_tags(stage)[has])
        got = torch.from_numpy(pool.copy())
        assert ops.scatter_verified_rows_(got, torch.from_numpy(stage), dst,
                                          tags, zero) == -1, label
        np.testing.assert_array_equal(got.numpy(),
                                      _pallas_write(pool, stage, dst, zero))


@needs_reference
def test_tag_mismatch_writes_nothing():
    """A tag spoiled at the first, the middle and the last staged row."""
    for label in ("chunk64", "few", "ragged"):
        pool, stage, dst, tags, zero = _case(label, seed=1)
        oracle = _oracle_tags(stage)
        for bad in (0, len(stage) // 2, len(stage) - 1):
            tags = oracle.copy()
            tags[bad] ^= 1
            tags[bad + 1:] ^= 1 << 16       # later rows differ too
            got = torch.from_numpy(pool.copy())
            assert ops.scatter_verified_rows_(got, torch.from_numpy(stage), dst,
                                              tags, zero) == bad, label
            np.testing.assert_array_equal(got.numpy(), pool)


@needs_reference
def test_verify_only_rows_are_checked_not_written():
    pool, stage, dst, tags, zero = _case("chunk64", seed=2)
    none = np.full_like(dst, -1)
    got = torch.from_numpy(pool.copy())
    tags = _oracle_tags(stage)
    assert ops.scatter_verified_rows_(got, torch.from_numpy(stage), none,
                                      tags) == -1
    np.testing.assert_array_equal(got.numpy(), pool)
    tags[40] += 1
    assert ops.scatter_verified_rows_(got, torch.from_numpy(stage), none,
                                      tags) == 40


def test_plain_scatter_is_the_mode_without_tags():
    pool, stage, dst, _, _ = _case("few", seed=3)
    dst = np.abs(dst)
    a = torch.from_numpy(pool.copy())
    b = torch.from_numpy(pool.copy())
    ops.scatter_rows_(a, dst, torch.from_numpy(stage))
    assert ops.scatter_verified_rows_(b, torch.from_numpy(stage), dst) == -1
    assert torch.equal(a, b)


def test_verified_operands_checked_on_host():
    pool = torch.zeros(8, 16, dtype=torch.uint8)
    for bad in ({"dst": [0, 99]}, {"dst": [0, -2]}, {"dst": [0]},
                {"tags": [0, 2 ** 32]}, {"tags": [0]}, {"zero": [99]}):
        args = {"dst": [0, 1], "tags": [-1, -1], "zero": [5], **bad}
        with pytest.raises((IndexError, ValueError)):
            ops.scatter_verified_rows_(pool, torch.zeros(2, 16, dtype=torch.uint8),
                                       args["dst"], args["tags"], args["zero"])


# ------------------------------------------------------------- load_batch
MS_BYTES, MPS = 32 * 1024, 32


def _stores(tmp_path, **backend):
    out = []
    for mod, tag in ((rc, "ref"), (tc, "port")):
        cfg = mod.small_test_config(
            ms_bytes=MS_BYTES, mps_per_ms=MPS,
            backend=mod.BackendConfig(**{"extent_max_rows": 8, **backend}),
            swap=mod.SwapConfig(hot_path=mod.HotPathConfig(
                pallas_kernels=(tag == "ref"), compress_workers=1)))
        out.append(rb.BackendStore(cfg, RefMetrics()) if tag == "ref"
                   else tb.BackendStore(cfg, Metrics(), device="cpu"))
    return out


def _batch(seed, k, mp):
    """Zero, compressible and random rows, as test_torch_backend.py."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((k, mp), dtype=np.uint8)
    for i in range(k):
        r = rng.random()
        if r < 0.5:
            continue
        if r < 0.85:
            rows[i] = np.tile(rng.integers(1, 256, 64, dtype=np.uint8), mp // 64)
        else:
            rows[i] = rng.integers(0, 256, mp, dtype=np.uint8)
    return rows


def _state(store, gfn):
    exts = {eid: (e.payload, e.is_raw, e.stored_len, list(e.mps), e.crc,
                  None if e.tags is None else e.tags.tolist())
            for (g, eid), e in store._extents.items() if g == gfn}
    return (exts, {k: v for k, v in store._compressed.items() if k[0] == gfn},
            dict(store._disk_offsets), store.metrics.deterministic_snapshot(),
            store.stats(), store.stored_bytes())


def _stored(tmp_path, seed, k, **backend):
    """Both stores holding the same batch; returns them and the batch."""
    ref_s, port = _stores(tmp_path, **backend)
    mp = ref_s.cfg.mp_bytes
    data = _batch(seed, k, mp)
    mps = np.random.default_rng(seed).permutation(MPS)[:k]
    kinds, crcs = ref_s.store_batch(5, mps, data.copy())
    pk, pcrc = port.store_batch(5, mps, torch.from_numpy(data.copy()))
    np.testing.assert_array_equal(pk, kinds)
    np.testing.assert_array_equal(pcrc, crcs)
    return ref_s, port, data, mps, kinds, crcs


@needs_reference
def test_load_batch_into_frame_rows_matches_reference(tmp_path):
    """Load straight into frame rows == load into a buffer, then scatter
    == the reference's load_batch: bytes, backend state, metrics; three
    seeded batches of 24, 7 and 32 rows under the default profile, CRCs
    off and extents of three rows."""
    for backend in ({}, {"crc_enabled": False}, {"extent_max_rows": 3}):
        for seed, k in ((1, 24), (2, 7), (3, 32)):
            _load_batch_into_frame_rows(tmp_path, seed, k, backend)


def _load_batch_into_frame_rows(tmp_path, seed, k, backend):
    ref_s, port, data, mps, kinds, crcs = _stored(tmp_path, seed, k, **backend)
    ref2, port2, *_ = _stored(tmp_path, seed, k, **backend)
    try:
        rows = np.random.default_rng(seed + 9).permutation(2 * MPS)[:k]
        out_ref = np.zeros_like(data)
        ref_s.load_batch(5, mps, kinds, crcs, out_ref)
        frame = torch.full((2 * MPS, ref_s.cfg.mp_bytes), 0xA5, dtype=torch.uint8)
        port.load_batch(5, mps, kinds, crcs, frame, rows=rows)
        frame2 = frame.clone().fill_(0xA5)
        buf = torch.empty(data.shape, dtype=torch.uint8)
        port2.load_batch(5, mps, kinds, crcs, buf)
        ops.scatter_rows_(frame2, rows, buf)
        np.testing.assert_array_equal(frame.numpy()[rows], data)
        np.testing.assert_array_equal(out_ref, data)
        others = np.setdiff1d(np.arange(2 * MPS), rows)
        assert (frame.numpy()[others] == 0xA5).all()
        assert torch.equal(frame, frame2)
        assert _state(port, 5) == _state(ref_s, 5) == _state(port2, 5)
    finally:
        for s in (ref_s, port, ref2, port2):
            s.close()


@needs_reference
def test_corrupt_extent_payload_raises_the_tag_error_in_both(tmp_path):
    """A decoded extent row whose tag and CRC both fail: the tag check
    comes first in both packages, with crc_checks not counted, nothing
    written and nothing consumed; then the same with the bad row one the
    batch does not load (only its tag fails)."""
    for sibling in (False, True):
        _corrupt_extent_payload(tmp_path, sibling)


def _corrupt_extent_payload(tmp_path, sibling):
    ref_s, port, data, mps, kinds, crcs = _stored(tmp_path, 4, 24)
    try:
        key = next(k for k in port._extents if k[0] == 5)
        ext_mps = port._extents[key].mps
        row = 1 if sibling else 0
        for store in (ref_s, port):
            ext = store._extents[key]
            raw = bytearray(store._ext_peek(5, key[1], count=False))
            raw[row * store.cfg.mp_bytes + 7] ^= 0x40
            ext.payload, ext.is_raw = bytes(raw), True
        take = np.array([i for i, m in enumerate(mps)
                         if not (sibling and m == ext_mps[row])])
        with pytest.raises(RefCorruption, match="extent tag mismatch") as want:
            ref_s.load_batch(5, mps[take], kinds[take], crcs[take],
                             np.zeros((len(take), data.shape[1]), np.uint8))
        frame = torch.zeros((MPS, data.shape[1]), dtype=torch.uint8)
        with pytest.raises(CorruptionError, match="extent tag mismatch") as got:
            port.load_batch(5, mps[take], kinds[take], crcs[take], frame,
                            rows=mps[take])
        assert str(got.value) == str(want.value)
        assert not frame.any()
        assert port.metrics.crc_failures == ref_s.metrics.crc_failures == 1
        assert _state(port, 5) == _state(ref_s, 5)
    finally:
        ref_s.close()
        port.close()


@needs_reference
def test_bad_record_crc_after_good_tags_raises_the_crc_error(tmp_path):
    ref_s, port, data, mps, kinds, crcs = _stored(tmp_path, 6, 16)
    try:
        bad = crcs.copy()
        i = int(np.flatnonzero(kinds == tb.K_COMPRESSED)[-1])
        bad[i] ^= 1
        with pytest.raises(RefCorruption, match="CRC mismatch") as want:
            ref_s.load_batch(5, mps, kinds, bad, np.zeros_like(data))
        frame = torch.zeros((MPS, data.shape[1]), dtype=torch.uint8)
        with pytest.raises(CorruptionError, match="CRC mismatch") as got:
            port.load_batch(5, mps, kinds, bad, frame, rows=mps)
        assert str(got.value) == str(want.value)
        assert not frame.any()
        assert _state(port, 5) == _state(ref_s, 5)
    finally:
        ref_s.close()
        port.close()


# ------------------------------------------------------- the whole swap-in
def _system_cfg(mod):
    """32 MPs an MS and chunks of 8: every swap-in chunk is partial. One
    compression worker: the stored bytes are the same for any count, and
    the suite's workers share the host's cores."""
    return mod.small_test_config(
        ms_bytes=32 * 1024, mps_per_ms=32, n_phys_ms=24,
        swap=mod.SwapConfig(batch_mps=8,
                            hot_path=mod.HotPathConfig(compress_workers=1)),
        backend=mod.BackendConfig(extent_max_rows=4))


def _partial_swap_in(system, seed):
    """Swap two MSs out, fault a seeded few MPs of each back, swap the
    rest in; returns what the guest reads."""
    cfg = system.cfg
    rng = np.random.default_rng(seed)
    mp = cfg.mp_bytes
    out = []
    for _ in range(2):
        g = system.guest.alloc_ms()
        img = _batch(int(rng.integers(1 << 30)), cfg.mps_per_ms, mp)
        system.guest.write(g, img.tobytes())
        assert system.engine.swap_out_ms(g) == cfg.mps_per_ms
        for m in rng.choice(cfg.mps_per_ms, size=5, replace=False).tolist():
            out.append(system.guest.read(g, mp, off=m * mp))
        system.engine.swap_in_ms(g)
        out.append(system.guest.read(g))
        assert out[-1] == img.tobytes()
    return out


@needs_reference
def test_partial_swap_in_matches_reference():
    for seed in (0, 1, 2):
        _partial_swap_in_matches_reference(seed)


def _partial_swap_in_matches_reference(seed):
    got = {}
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        s = pkg.TaijiSystem(_system_cfg(rc if pkg is R else tc), **kw)
        try:
            reads = _partial_swap_in(s, seed)
            got[pkg.__name__] = (reads, s.snapshot()["deterministic"],
                                 s.backend.stats())
        finally:
            s.close()
    ref_reads, ref_snap, ref_stats = got["repro.core"]
    port_reads, port_snap, port_stats = got["repro_torch.core"]
    assert port_reads == ref_reads
    assert snapshot_diff(ref_snap, port_snap) == []
    assert snapshot_diff(ref_stats, port_stats) == []
    assert port_snap["metrics"]["swap_in_batches"] > 0


def test_swap_in_writes_each_chunk_once_into_the_frame(monkeypatch):
    """Each partial chunk is one verified write into the MS frame: no
    buffer-then-scatter, no separate Fletcher pass, no index upload."""
    system = T.TaijiSystem(_system_cfg(tc), device="cpu")
    calls = []
    real = ops.scatter_verified_rows_

    def spy(pool, stage, dst, tags=None, zero=None, **kw):
        calls.append((tuple(pool.shape), int((np.asarray(dst) >= 0).sum()),
                      0 if zero is None else len(zero)))
        return real(pool, stage, dst, tags, zero, **kw)

    def banned(*a, **kw):
        raise AssertionError("the swap-in called a kernel it no longer needs")

    try:
        cfg = system.cfg
        g = system.guest.alloc_ms()
        img = _batch(7, cfg.mps_per_ms, cfg.mp_bytes)
        system.guest.write(g, img.tobytes())
        system.engine.swap_out_ms(g)
        with monkeypatch.context() as mp:
            mp.setattr(ops, "scatter_verified_rows_", spy)
            for name in ("scatter_rows_", "fletcher_rows", "_dev_index"):
                mp.setattr(ops, name, banned)
            assert system.engine.swap_in_ms(g) == cfg.mps_per_ms
        assert len(calls) == cfg.mps_per_ms // cfg.swap.batch_mps
        assert {c[0] for c in calls} == {(cfg.mps_per_ms, cfg.mp_bytes)}
        assert sum(c[1] + c[2] for c in calls) == cfg.mps_per_ms
        assert system.guest.read(g) == img.tobytes()
        assert system.metrics.crc_failures == 0
    finally:
        system.close()


# ---------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _card_case(n_pool, elems, k, z, seed):
    """A card-sized case with plain-version tags, as _case."""
    rng = np.random.default_rng([n_pool, elems, k, z, seed])
    pool = torch.from_numpy(rng.integers(0, 256, (n_pool, elems), dtype=np.uint8))
    stage = torch.from_numpy(rng.integers(0, 256, (k, elems), dtype=np.uint8))
    stage[::5] = 0
    rows = rng.permutation(n_pool)
    dst = rows[:k].astype(np.int64)
    dst[3::4] = -1
    zero = rows[k:k + z].astype(np.int64)
    tags = (ref.fletcher_checksum(stage).numpy().astype(np.int64) if k
            else np.zeros(0, np.int64))
    tags[2::3] = -1
    return pool, stage, dst, tags, zero


# (n_pool, elems, staged rows, zero rows): the main-path chunk, a whole MS
# of staged rows (more than one launch takes: verify launches, then gated
# writes), ragged 4100-byte rows, eight 1.125 MiB KV rows (shares read
# again from L2), zero rows only
CARD_CASES = {
    "chunk64": (512, 4096, 64, 16),
    "whole_ms": (1024, 4096, 512, 300),
    "ragged": (37, 4100, 11, 4),
    "kv_rows": (16, 1_179_648, 8, 2),
    "zero_only": (512, 4096, 0, 64),
}


@pytest.mark.cuda
def test_cuda_verified_scatter_equals_plain(cuda_device):
    """Each case with every tag right, then with the first and with the
    last tagged row spoiled (nothing written)."""
    for label in sorted(CARD_CASES):
        for bad in (None, "first", "last"):
            pool, stage, dst, tags, zero = _card_case(*CARD_CASES[label], seed=0)
            if bad is not None:
                if not len(stage):
                    continue              # no staged row to spoil
                j = int(np.flatnonzero(tags >= 0)[0 if bad == "first" else -1])
                tags[j] ^= 1
            _card_vs_plain(cuda_device, pool, stage, dst, tags, zero)


def _card_vs_plain(cuda_device, pool, stage, dst, tags, zero):
    want = pool.clone()
    verdict = ref.scatter_verified_blocks_(want, stage, torch.from_numpy(dst),
                                           torch.from_numpy(tags),
                                           torch.from_numpy(zero))
    got = pool.to(cuda_device)
    before = (ops.launches.get("scatter_verified", 0),
              ops.transfers["verdict_wait"])
    assert ops.scatter_verified_rows_(got, stage.to(cuda_device), dst, tags,
                                      zero) == verdict
    assert torch.equal(got.cpu(), want)
    assert ops.launches["scatter_verified"] > before[0]
    assert ops.transfers["verdict_wait"] == before[1] + 1
    # the plain mode: the rows with a destination, no tags, no zero rows
    w = dst >= 0
    plain = pool.to(cuda_device)
    ops.scatter_rows_(plain, dst[w], stage[torch.from_numpy(w)].to(cuda_device))
    want = pool.clone()
    ref.scatter_blocks_(want, torch.from_numpy(dst[w]), stage[torch.from_numpy(w)])
    assert torch.equal(plain.cpu(), want)


@pytest.mark.cuda
def test_cuda_verified_scatter_replays_in_a_graph(cuda_device):
    """Destinations, tags and zero rows ride in the launch's parameters: a
    captured launch replays with the values it captured."""
    pool, stage, dst, tags, zero = _card_case(512, 4096, 64, 16, seed=1)
    want = pool.clone()
    assert ref.scatter_verified_blocks_(want, stage, torch.from_numpy(dst),
                                        torch.from_numpy(tags),
                                        torch.from_numpy(zero)) == -1
    d_pool, d_stage = pool.to(cuda_device), stage.to(cuda_device)
    verdict = torch.empty(1, dtype=torch.int32, device=cuda_device)
    host = [dst.copy(), tags.copy(), zero.copy()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.launch_scatter_verified(d_pool, d_stage, *host, verdict)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ops.launch_scatter_verified(d_pool, d_stage, *host, verdict)
    for h in host:
        h[:] = 0
    d_pool.copy_(pool.to(cuda_device))
    verdict.fill_(7)
    graph.replay()
    torch.cuda.synchronize()
    assert int(verdict.cpu()) == -1
    assert torch.equal(d_pool.cpu(), want)


@pytest.mark.cuda
def test_cuda_swap_in_uploads_no_index(cuda_device, monkeypatch):
    """A swap-in chunk on the card: one verified scatter and one verdict
    wait, no index upload, no separate Fletcher pass."""
    system = T.TaijiSystem(_system_cfg(tc), device=cuda_device)
    try:
        cfg = system.cfg
        g = system.guest.alloc_ms()
        img = _batch(8, cfg.mps_per_ms, cfg.mp_bytes)
        system.guest.write(g, img.tobytes())
        system.engine.swap_out_ms(g)
        before = dict(ops.launches), dict(ops.transfers)
        with monkeypatch.context() as mp:
            mp.setattr(ops, "_dev_index", lambda *a, **kw: pytest.fail(
                "a swap-in chunk uploaded an index vector"))
            assert system.engine.swap_in_ms(g) == cfg.mps_per_ms
        chunks = cfg.mps_per_ms // cfg.swap.batch_mps
        assert ops.launches["scatter_verified"] == \
            before[0].get("scatter_verified", 0) + chunks
        assert ops.launches["fletcher"] == before[0]["fletcher"]
        assert ops.launches["scatter"] == before[0]["scatter"]
        assert ops.transfers["verdict_wait"] == before[1]["verdict_wait"] + chunks
        assert ops.transfers["index_upload"] == before[1]["index_upload"]
        assert system.guest.read(g) == img.tobytes()
        assert system.metrics.crc_failures == 0
    finally:
        system.close()
