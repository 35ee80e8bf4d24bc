"""The swap-out's compacting gather (``ops.gather_nonzero_rows``) and the
store path that reads through it, against the reference.

On the CPU the wrapper runs its plain version, held exactly against
``repro.kernels.ref.gather_blocks`` followed by ``zero_detect`` and
against the two Pallas kernels in interpret mode. ``store_batch`` reading
its rows out of a frame (``rows=``) must store what the reference stores
for the gathered rows, under every backend profile. The ``cuda`` tests
hold the kernel's three modes against the plain versions and check that
a swap-out chunk uploads no index vector; they skip without a card and
need neither JAX nor the reference, so ``python -m pytest -m cuda
tests/test_torch_swap_gather.py`` runs them on a machine that has only
the port's dependencies.
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
    from repro.core import backend as rb
    from repro.core import config as rc
    from repro.core.errors import CorruptionError as RefCorruption
    from repro.core.metrics import Metrics as RefMetrics
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:       # a card's machine without JAX: the cuda tests only
    jnp = jops = jref = rb = rc = RefCorruption = RefMetrics = None

# (n_pool, elems, indices, share of zero rows): every row zero, none, one
# index, 13 and 64 of a 512-MP frame, ragged 4100-byte rows (no 16-byte
# alignment), eight 1.125 MiB rows (qwen3-4b's KV MPs), a whole MS, and
# more indices than one launch takes
POOLS = {
    "all_zero": (512, 4096, 64, 1.0),
    "none_zero": (512, 4096, 64, 0.0),
    "one_row": (512, 4096, 1, 0.5),
    "13_of_512": (512, 4096, 13, 0.5),
    "64_of_512": (512, 4096, 64, 0.7679),
    "ragged": (37, 4100, 11, 0.5),
    "kv_rows": (8, 1_179_648, 8, 0.5),
    "whole_ms": (512, 4096, 512, 0.7679),
    "700_of_1024": (1024, 4096, 700, 0.5),
}


def _pool(label):
    """A seeded uint8 pool and a permuted index vector; one indexed row
    is zero but for its last byte."""
    n_pool, elems, k, zero_share = POOLS[label]
    rng = np.random.default_rng(sorted(POOLS).index(label))
    pool = rng.integers(0, 256, (n_pool, elems), dtype=np.uint8)
    pool[rng.random(n_pool) < zero_share] = 0
    idx = rng.permutation(n_pool)[:k]
    if 0 < zero_share < 1:
        pool[idx[0]] = 0
        pool[idx[0], -1] = 1
    return pool, idx


@pytest.fixture
def cpu_launches():
    ops.reset_launches()
    yield
    assert ops.launches == {"gather": 0, "scatter": 0, "zero": 0,
                            "fletcher": 0}


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("label", sorted(POOLS))
def test_compacting_gather_matches_reference(label, cpu_launches):
    pool, idx = _pool(label)
    zero, rows = ops.gather_nonzero_rows(torch.from_numpy(pool), idx)
    assert zero.device.type == rows.device.type == "cpu"
    gathered = np.asarray(jref.gather_blocks(pool, idx))
    want_zero = np.asarray(jref.zero_detect(jnp.asarray(gathered)))
    np.testing.assert_array_equal(zero.numpy(), want_zero)
    np.testing.assert_array_equal(rows.numpy(), gathered[~want_zero])
    if label == "all_zero":
        assert rows.shape == (0, pool.shape[1])
    if label == "none_zero":
        assert not want_zero.any()
    if pool.shape[1] % 128 == 0:          # the Pallas kernels' tiling
        g = jops.gather_blocks(jnp.asarray(pool), jnp.asarray(idx, jnp.int32))
        pz = np.asarray(jops.zero_detect(g, tile_elems=4096))
        np.testing.assert_array_equal(zero.numpy(), pz)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(g)[~pz])


def test_compacting_gather_checks_like_gather(cpu_launches):
    pool = torch.zeros(8, 16, dtype=torch.uint8)
    with pytest.raises(IndexError):
        ops.gather_nonzero_rows(pool, np.array([0, 8]))
    with pytest.raises(TypeError, match="uint8"):
        ops.gather_nonzero_rows(torch.empty(4, 64, device="meta"), np.arange(2))
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_nonzero_rows(torch.empty(4, 64, dtype=torch.uint8,
                                            device="meta"), np.arange(2))
    zero, rows = ops.gather_nonzero_rows(pool, np.arange(0))
    assert zero.shape == (0,) and rows.shape == (0, 16)


# ---------------------------------------------------- store_batch(rows=)
MS_BYTES, MPS = 32 * 1024, 32

PROFILES = {
    "default": {},
    "crc_off": {"crc_enabled": False},
    "zero_page_off": {"zero_page_enabled": False},
    "rows4": {"extent_max_rows": 4},
    "serial": {"workers": 0},
    "disk": {"disk": True},
    "free_page": {"free_page_enabled": True},
}


def _free_probe(gfn, mp):
    """Guest-reported free pages: every fifth MP."""
    return mp % 5 == 0


def _store(mod, profile, tmp_path, tag):
    opts = dict(PROFILES[profile])
    workers = opts.pop("workers", 4)
    be = {"extent_max_rows": 8, **opts}
    if be.pop("disk", False):
        be["disk_fallback_path"] = str(tmp_path / f"disk-{tag}.bin")
    cfg = mod.small_test_config(
        ms_bytes=MS_BYTES, mps_per_ms=MPS, backend=mod.BackendConfig(**be),
        swap=mod.SwapConfig(hot_path=mod.HotPathConfig(
            pallas_kernels=mod is rc, compress_workers=workers)))
    store = (rb.BackendStore(cfg, RefMetrics()) if mod is rc
             else tb.BackendStore(cfg, Metrics(), device="cpu"))
    if profile == "free_page":
        store.set_free_page_probe(_free_probe)
    return store


def _frame(seed, mp):
    """One MS frame of paper-like rows: zero, compressible, random; one
    row zero but for its last byte."""
    rng = np.random.default_rng(seed)
    frame = np.zeros((MPS, mp), dtype=np.uint8)
    for i in range(MPS):
        r = rng.random()
        if r < 0.5:
            continue
        if r < 0.85:
            frame[i] = np.tile(rng.integers(1, 256, 64, dtype=np.uint8), mp // 64)
        else:
            frame[i] = rng.integers(0, 256, mp, dtype=np.uint8)
    frame[3] = 0
    frame[3, -1] = 9
    return frame


def _state(store, gfn):
    exts = {eid: (e.payload, e.is_raw, e.stored_len, list(e.mps), e.crc,
                  None if e.tags is None else e.tags.tolist())
            for (g, eid), e in store._extents.items() if g == gfn}
    return (exts, {k: v for k, v in store._compressed.items() if k[0] == gfn},
            dict(store._disk_offsets), store.metrics.deterministic_snapshot(),
            store.stats(), store.stored_bytes())


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("seed,k", [(1, 32), (2, 7), (3, 13)])
def test_store_batch_from_frame_matches_gathered_rows(profile, seed, k,
                                                      tmp_path):
    """``store_batch(gfn, mps, frame, rows=idx)`` stores what
    ``store_batch(gfn, mps, frame[idx])`` stores, in the port and in the
    reference: kinds, CRCs, extent bytes and tags, the snapshot."""
    stores = [_store(rc, profile, tmp_path, "ref"),
              _store(tc, profile, tmp_path, "rows"),
              _store(tc, profile, tmp_path, "copy")]
    try:
        mp = stores[0].cfg.mp_bytes
        frame = _frame(seed, mp)
        idx = np.random.default_rng(seed).permutation(MPS)[:k]
        mps = idx.copy()
        gfn = 40 + seed
        got = [stores[0].store_batch(gfn, mps, frame[idx].copy()),
               stores[1].store_batch(gfn, mps, torch.from_numpy(frame.copy()),
                                     rows=idx),
               stores[2].store_batch(gfn, mps, torch.from_numpy(frame[idx].copy()))]
        for kinds, crcs in got[1:]:
            np.testing.assert_array_equal(kinds, got[0][0])
            np.testing.assert_array_equal(crcs, got[0][1])
        assert _state(stores[1], gfn) == _state(stores[0], gfn)
        assert _state(stores[2], gfn) == _state(stores[0], gfn)
        if profile == "free_page":
            assert (got[1][0] == tb.K_FREE).sum() == sum(
                _free_probe(gfn, int(m)) for m in mps)

        # the round trip, as the reference makes it: load_batch holds a
        # free row to the zero-page CRC, so a free row that held data
        # raises in both packages (ROADMAP Queue C)
        ref_out = np.zeros((k, mp), dtype=np.uint8)
        out = torch.full((k, mp), 0xA5, dtype=torch.uint8)
        try:
            stores[0].load_batch(gfn, mps, *got[0], ref_out)
        except RefCorruption:
            with pytest.raises(CorruptionError, match="zero-page CRC"):
                stores[1].load_batch(gfn, mps, *got[1], out)
            assert profile == "free_page"
        else:
            stores[1].load_batch(gfn, mps, *got[1], out)
            np.testing.assert_array_equal(out.numpy(), ref_out)
            np.testing.assert_array_equal(out.numpy(), frame[idx])
        assert _state(stores[1], gfn) == _state(stores[0], gfn)
    finally:
        for s in stores:
            s.close()


# ----------------------------------------------------- the swap-out path
def _small_system(device):
    cfg = tc.small_test_config(
        swap=tc.SwapConfig(batch_mps=3),
        backend=tc.BackendConfig(crc_enabled=True, extent_max_rows=2))
    return T.TaijiSystem(cfg, device=device)


def _swap_out_one(system, seed):
    """Write one paper-mix MS, swap it out in chunks of 3 MPs; returns
    (gfn, its bytes)."""
    cfg = system.cfg
    frame = _frame(seed, cfg.mp_bytes)[:cfg.mps_per_ms]
    g = system.guest.alloc_ms()
    system.guest.write(g, frame.tobytes())
    assert system.engine.swap_out_ms(g) == cfg.mps_per_ms
    return g, frame.tobytes()


def test_swap_out_reads_the_frame_once_per_chunk(monkeypatch):
    """Each swap-out chunk is one compacting gather over the MS frame and
    its MP indices; no separate gather or zero scan, no index upload."""
    system = _small_system("cpu")
    calls = []
    real = ops.gather_nonzero_rows

    def spy(pool, idx):
        calls.append((pool.data_ptr(), tuple(pool.shape), list(idx)))
        return real(pool, idx)

    def banned(*a, **kw):
        raise AssertionError("the swap-out called a kernel it no longer needs")

    try:
        cfg = system.cfg
        with monkeypatch.context() as mp:
            mp.setattr(ops, "gather_nonzero_rows", spy)
            for name in ("gather_rows", "zero_rows", "_dev_index"):
                mp.setattr(ops, name, banned)
            g, data = _swap_out_one(system, 7)
        assert [c[2] for c in calls] == [[0, 1, 2], [3, 4, 5], [6, 7]]
        assert {c[1] for c in calls} == {(cfg.mps_per_ms, cfg.mp_bytes)}
        assert system.guest.read(g) == data
        assert system.metrics.crc_failures == 0
    finally:
        system.close()


# ---------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(POOLS))
def test_cuda_pass_modes_equal_plain(cuda_device, label):
    """The indexed pass in its three modes -- compacting gather, gather,
    zero flags -- bit for bit against the plain versions."""
    pool, idx = _pool(label)
    x = torch.from_numpy(pool)
    xd = x.to(cuda_device)
    before = dict(ops.launches)
    zero, rows = ops.gather_nonzero_rows(xd, idx)
    want_zero, want_rows = ref.gather_nonzero_blocks(x, torch.from_numpy(idx))
    assert zero.device.type == "cpu" and rows.device == xd.device
    assert torch.equal(zero, want_zero)
    assert torch.equal(rows.cpu(), want_rows)
    gathered = ops.gather_rows(xd, idx)
    assert torch.equal(gathered.cpu(), ref.gather_blocks(x, torch.from_numpy(idx)))
    assert torch.equal(ops.zero_rows(gathered).cpu(), want_zero)
    assert ops.launches["gather"] == before["gather"] + 2
    assert ops.launches["zero"] == before["zero"] + 1


@pytest.mark.cuda
def test_cuda_compacting_gather_replays_in_a_graph(cuda_device):
    """The indices ride in the launch's parameters: a captured launch
    replays with the values it captured, whatever the host vector holds
    later."""
    pool, idx = _pool("64_of_512")
    xd = torch.from_numpy(pool).to(cuda_device)
    k = len(idx)
    meta = torch.empty(4 + k, dtype=torch.uint8, device=cuda_device)
    out = torch.empty((k, pool.shape[1]), dtype=torch.uint8, device=cuda_device)
    host_idx = idx.copy()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.launch_gather_nonzero(xd, host_idx, meta, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ops.launch_gather_nonzero(xd, host_idx, meta, out)
    host_idx[:] = 0
    meta.zero_()
    graph.replay()
    torch.cuda.synchronize()
    zero, rows = ref.gather_nonzero_blocks(torch.from_numpy(pool),
                                           torch.from_numpy(idx))
    count = int(meta[:4].cpu().view(torch.int32))
    assert count == len(rows)
    assert torch.equal(meta[4:].cpu().view(torch.bool), zero)
    assert torch.equal(out[:count].cpu(), rows)


@pytest.mark.cuda
def test_cuda_swap_out_uploads_no_index(cuda_device, monkeypatch):
    system = _small_system(cuda_device)
    try:
        before = dict(ops.launches)
        with monkeypatch.context() as mp:
            mp.setattr(ops, "_dev_index", lambda *a, **kw: pytest.fail(
                "a swap-out chunk uploaded an index vector"))
            g, data = _swap_out_one(system, 8)
        assert ops.launches["zero"] == before["zero"]
        assert ops.launches["gather"] == before["gather"] + 3
        assert system.guest.read(g) == data
        assert system.metrics.crc_failures == 0
    finally:
        system.close()

