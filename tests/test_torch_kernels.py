"""The port's swap kernels (repro_torch.kernels) against the reference.

On the CPU the wrappers run their plain PyTorch versions; each is held,
exactly, against ``repro.kernels.ref`` and against the Pallas kernel in
interpret mode on the shape/dtype sweeps of tests/test_kernels.py, plus
ragged uint8 rows the CUDA kernels must take. The ``cuda`` tests hold
the CUDA kernels against the plain versions and skip without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _rng(*key):
    return np.random.default_rng([42, *key])


@pytest.fixture
def cpu_launches():
    ops.reset_launches()
    yield
    # the CPU path runs the plain versions and counts no launch
    assert ops.launches == {"gather": 0, "scatter": 0, "zero": 0,
                            "fletcher": 0}


# ------------------------------------------------------------ zero detect
@pytest.mark.parametrize("n,elems,tile", [(4, 1024, 512), (8, 4096, 4096),
                                          (3, 512, 128), (16, 256, 256)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int8, np.uint8])
def test_zero_detect_matches_reference(n, elems, tile, dtype, cpu_launches):
    rng = _rng(n, elems, np.dtype(dtype).num)
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal((n, elems)).astype(dtype)
        x[1::3] = -0.0                    # zero by value, not by bytes
    else:
        x = rng.integers(0, 100, (n, elems)).astype(dtype)
    x[::3] = 0
    want = np.asarray(jref.zero_detect(jnp.asarray(x)))
    pallas = np.asarray(jops.zero_detect(jnp.asarray(x), tile_elems=tile))
    got = ops.zero_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(ref.zero_detect(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("n,elems", [(5, 4100), (3, 4097), (2, 70001)])
def test_zero_detect_ragged_rows(n, elems, cpu_launches):
    x = _rng(n, elems).integers(0, 256, (n, elems)).astype(np.uint8)
    x[0] = 0
    x[1] = 0
    x[1, -1] = 7                          # non-zero only in the tail byte
    got = ops.zero_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ~x.any(axis=1))
    np.testing.assert_array_equal(got, jops.batch_zero_detect(x))


# ---------------------------------------------------------------- Fletcher
@pytest.mark.parametrize("n,elems,tile", [(4, 4096, 1024), (2, 512, 512),
                                          (8, 2048, 256)])
def test_fletcher_matches_reference(n, elems, tile, cpu_launches):
    b = _rng(n, elems).integers(0, 256, (n, elems)).astype(np.uint8)
    want = np.asarray(jref.fletcher_checksum(jnp.asarray(b)))
    pallas = np.asarray(jops.fletcher_checksum(jnp.asarray(b), tile_elems=tile))
    got = ops.fletcher_rows(torch.from_numpy(b))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # single-byte corruption is always detected
    b2 = b.copy()
    b2[0, 7] ^= 1
    assert ops.fletcher_rows(torch.from_numpy(b2)).numpy()[0] != want[0]


@pytest.mark.parametrize("n,elems", [(5, 4100), (3, 4097), (2, 65521),
                                     (2, 70001), (1, 131_075)])
def test_fletcher_ragged_and_wrapping_rows(n, elems, cpu_launches):
    """Rows of any length, including past 65521 bytes where the weight
    (i+1) mod p wraps; the reference pads to its 4096 fold."""
    b = _rng(n, elems).integers(0, 256, (n, elems)).astype(np.uint8)
    want = np.asarray(jref.fletcher_checksum(jnp.asarray(b)))
    np.testing.assert_array_equal(ops.fletcher_rows(torch.from_numpy(b)).numpy(),
                                  want)
    np.testing.assert_array_equal(jops.batch_checksum(b), want)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_fletcher_plain_casts_like_reference(dtype):
    """Other integer dtypes go through uint32 as the reference casts them
    (negative values wrap)."""
    b = _rng(np.dtype(dtype).num).integers(-128, 128, (3, 1024)).astype(dtype)
    want = np.asarray(jref.fletcher_checksum(jnp.asarray(b)))
    np.testing.assert_array_equal(
        ref.fletcher_checksum(torch.from_numpy(b)).numpy(), want)


# ---------------------------------------------------------- gather/scatter
@pytest.mark.parametrize("n_pool,elems,n_out", [(16, 512, 4), (8, 256, 8),
                                                (32, 1024, 1), (37, 4100, 11)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.uint8])
def test_gather_scatter_match_reference(n_pool, elems, n_out, dtype,
                                        cpu_launches):
    rng = _rng(n_pool, elems, np.dtype(dtype).num)
    pool = rng.standard_normal((n_pool, elems)).astype(dtype)
    idx = rng.choice(n_pool, size=n_out, replace=False)
    blocks = rng.standard_normal((n_out, elems)).astype(dtype)

    want = np.asarray(jref.gather_blocks(pool, idx))
    got = ops.gather_rows(torch.from_numpy(pool), idx).numpy()
    np.testing.assert_array_equal(got, want)
    if elems % 128 == 0:                  # the Pallas kernel's tiling
        np.testing.assert_array_equal(got, np.asarray(jops.gather_blocks(
            jnp.asarray(pool), jnp.asarray(idx, jnp.int32))))

    want2 = np.asarray(jref.scatter_blocks(jnp.asarray(pool), jnp.asarray(idx),
                                           jnp.asarray(blocks)))
    tpool = torch.from_numpy(pool.copy())
    assert ops.scatter_rows_(tpool, idx, torch.from_numpy(blocks)) is None
    np.testing.assert_array_equal(tpool.numpy(), want2)   # in place
    if elems % 128 == 0:
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(
            jops.scatter_blocks(jnp.asarray(pool.copy()),
                                jnp.asarray(idx, jnp.int32),
                                jnp.asarray(blocks))))


def test_scatter_leaves_other_rows_alone():
    pool = torch.arange(8 * 16, dtype=torch.int64).to(torch.uint8).view(8, 16)
    before = pool.clone()
    ops.scatter_rows_(pool, np.array([5, 2]), torch.zeros(2, 16, dtype=torch.uint8))
    keep = [0, 1, 3, 4, 6, 7]
    assert torch.equal(pool[keep], before[keep])
    assert not pool[[2, 5]].any()


@pytest.mark.parametrize("idx", [[-1], [8], [0, 99]])
def test_index_checked_on_host(idx):
    pool = torch.zeros(8, 16, dtype=torch.uint8)
    with pytest.raises(IndexError):
        ops.gather_rows(pool, np.array(idx))
    with pytest.raises(IndexError):
        ops.scatter_rows_(pool, np.array(idx),
                          torch.zeros(len(idx), 16, dtype=torch.uint8))


# ------------------------------------------------------- wrapper dispatch
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int8])
@pytest.mark.parametrize("fn", ["zero_rows", "fletcher_rows", "gather_rows"])
def test_kernel_path_rejects_non_uint8(fn, dtype, cpu_launches):
    """Off the CPU the wrappers take uint8 rows only: a byte test would
    call -0.0 non-zero where the reference compares values. Checked on
    the meta device, which takes the kernel path's checks."""
    x = torch.empty(4, 64, dtype=dtype, device="meta")
    args = (x, np.arange(2)) if fn == "gather_rows" else (x,)
    with pytest.raises(TypeError, match="uint8"):
        getattr(ops, fn)(*args)


@pytest.mark.parametrize("fn", ["zero_rows", "fletcher_rows", "gather_rows"])
def test_kernel_path_needs_cuda(fn, cpu_launches):
    x = torch.empty(4, 64, dtype=torch.uint8, device="meta")
    args = (x, np.arange(2)) if fn == "gather_rows" else (x,)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, fn)(*args)


def test_wrappers_check_shape_and_layout():
    with pytest.raises(ValueError, match="rows, elems"):
        ops.zero_rows(torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        ops.fletcher_rows(torch.zeros(8, 16, dtype=torch.uint8).t())
    with pytest.raises(ValueError, match="do not fit"):
        ops.scatter_rows_(torch.zeros(8, 16, dtype=torch.uint8), np.arange(2),
                          torch.zeros(3, 16, dtype=torch.uint8))


def test_cpu_dispatch_counts_no_launch(cpu_launches):
    x = torch.zeros(4, 64, dtype=torch.uint8)
    ops.zero_rows(x)
    ops.fletcher_rows(x)
    out = ops.gather_rows(x, np.arange(2))
    ops.scatter_rows_(x, np.arange(2), out)


# -------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,elems", [(64, 4096), (16, 4096), (16, 4100),
                                     (3, 70001)])
def test_cuda_kernels_equal_plain(cuda_device, n, elems):
    x = torch.from_numpy(
        _rng(n, elems).integers(0, 256, (n, elems)).astype(np.uint8))
    x[::3] = 0
    xd = x.to(cuda_device)
    before = dict(ops.launches)
    assert torch.equal(ops.zero_rows(xd).cpu(), ref.zero_detect(x))
    assert torch.equal(ops.fletcher_rows(xd).cpu().view(torch.int32),
                       ref.fletcher_checksum(x).view(torch.int32))
    idx = np.arange(n)[::-1].copy()
    assert torch.equal(ops.gather_rows(xd, idx).cpu(), ref.gather_blocks(
        x, torch.from_numpy(idx)))
    pool = xd.clone()
    ops.scatter_rows_(pool, idx, xd)
    assert torch.equal(pool.cpu(), x.flip(0))
    assert all(ops.launches[k] == before[k] + 1 for k in before)
