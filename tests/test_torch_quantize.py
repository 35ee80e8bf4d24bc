"""The int8 block quantize/dequantize pair in the port (repro_torch.kernels)
against the reference.

On the CPU the wrappers run their plain PyTorch versions. They are held
against the reference's eager oracle (``repro.kernels.ref``) and its
Pallas kernels in interpret mode (as tests/test_kernels.py runs them) on
that file's sweep, in bfloat16 too, and on an all-zero MP, an MP of
``-0.0`` and an MP of ties (absmax exactly 127, so that ``x / scale``
lands on .5 and must round half to even):

* q and scales bit-equal to the oracle;
* against the Pallas kernel, scales within test_kernels.py's
  ``rtol=1e-6`` and at most one ulp away, and q bit-equal in every MP
  whose scale is: under ``jit`` XLA turns the kernel's ``absmax / 127.0``
  into a multiply by the f32 reciprocal, which the eager oracle does not,
  so the two JAX versions already differ there (about 1 MP in 20 has a
  scale one ulp apart, and rarely an element of it lands on the other
  side of a rounding tie). Given the kernel's scales, the plain quantize
  step gives the kernel's q bit for bit;
* dequantized values bit-equal to both JAX versions for the same q and
  scales, in float32, float16 and bfloat16, and within test_kernels.py's
  error bound in float32.

The ``cuda`` tests hold the CUDA kernels against the plain versions on
the card, bit for bit, and skip without one; they need neither JAX nor
the reference (``python -m pytest -m cuda tests/test_torch_quantize.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

from repro_torch.kernels import ops, ref  # noqa: E402

# (n, elems, mps): tests/test_kernels.py's quantize sweep
SWEEP = [(2, 512, 4), (4, 1024, 8), (1, 2048, 16), (6, 768, 3)]
DTYPES = ["float32", "float16", "bfloat16"]


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's Pallas kernels and oracle (imported here so that
    the ``cuda`` tests run where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


def _blocks(n, elems, mps, dtype, seed=0):
    """As tests/test_kernels.py: normal values times 4 with a zero first
    MP; float32 numpy values already rounded to ``dtype``."""
    rng = np.random.default_rng([11, n, elems, mps, DTYPES.index(dtype), seed])
    x = (rng.standard_normal((n, elems)) * 4).astype(np.float32)
    x[0, :elems // mps] = 0
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _special(dtype):
    """Three MPs of 256: all zero, all ``-0.0``, and ties whose absmax is
    exactly 127 (scale 1: x / scale is .5 away from two integers)."""
    mp = 256
    x = np.zeros((2, 3 * mp), np.float32)
    x[0, mp:2 * mp] = -0.0
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -126.5, 126.5,
                     127.0, -127.0, 0.0], np.float32)
    x[0, 2 * mp:] = np.resize(ties, mp)
    x[1] = np.resize(ties[::-1] * 0.25, 3 * mp)   # scale 127/4 / 127
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy(), 3


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _jax(jnp, x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.fixture
def no_launch():
    before = dict(ops.launches)
    yield
    # the CPU path runs the plain version and counts no launch
    assert ops.launches == before


def _check_quantize(jax_ref, x, mps, dtype):
    jnp, jops, jref = jax_ref
    q, s = ops.block_quantize(_torch(x, dtype), mps)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == x.shape and tuple(s.shape) == (x.shape[0], mps)
    q, s = q.numpy(), s.numpy()
    pq, ps = ref.block_quantize(_torch(x, dtype), mps)
    np.testing.assert_array_equal(pq.numpy(), q)
    np.testing.assert_array_equal(ps.numpy().view(np.int32), s.view(np.int32))
    oq, os_ = jref.block_quantize(_jax(jnp, x, dtype), mps)
    np.testing.assert_array_equal(np.asarray(oq), q)
    np.testing.assert_array_equal(np.asarray(os_).view(np.int32), s.view(np.int32))
    kq, ks = jops.block_quantize(_jax(jnp, x, dtype), mps)
    kq, ks = np.array(kq), np.array(ks)
    np.testing.assert_allclose(ks, s, rtol=1e-6)
    assert np.abs(ks.view(np.int32) - s.view(np.int32)).max() <= 1
    # q equals the Pallas kernel's in every MP whose scale does; and the
    # plain quantize step, given the kernel's scales, gives its q exactly
    same = np.repeat(ks == s, x.shape[1] // mps, axis=1)
    np.testing.assert_array_equal(kq[same], q[same])
    mp = x.shape[1] // mps
    xs = torch.from_numpy(x).reshape(x.shape[0], mps, mp)
    kq_plain = torch.clamp(torch.round(xs / torch.from_numpy(ks)[..., None]),
                           -127, 127).to(torch.int8).reshape(x.shape)
    np.testing.assert_array_equal(kq_plain.numpy(), kq)
    return q, s


@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_matches_reference(shape, dtype, jax_ref, no_launch):
    n, elems, mps = shape
    x = _blocks(n, elems, mps, dtype)
    _, s = _check_quantize(jax_ref, x, mps, dtype)
    assert (s[0, 0] == 1.0) and (s > 0).all()      # the zero MP's scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_negative_zero_and_tie_mps(dtype, jax_ref, no_launch):
    x, mps = _special(dtype)
    q, s = _check_quantize(jax_ref, x, mps, dtype)
    assert s[0].tolist() == [1.0, 1.0, 1.0]
    assert not q[0, :512].any() and not np.signbit(s).any()
    # half to even: 0.5 -> 0, -0.5 -> 0, 1.5 -> 2, -1.5 -> -2, 2.5 -> 2,
    # -2.5 -> -2, 3.5 -> 4, -126.5 -> -126, 126.5 -> 126, +-127 kept
    assert q[0, 512:524].tolist() == [0, 0, 2, -2, 2, -2, 4, -126, 126, 127,
                                      -127, 0]


@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("out_dtype", DTYPES)
def test_dequantize_matches_reference(shape, out_dtype, jax_ref, no_launch):
    jnp, jops, jref = jax_ref
    n, elems, mps = shape
    x = _blocks(n, elems, mps, "float32", seed=1)
    q, s = ops.block_quantize(torch.from_numpy(x), mps)
    d = ops.block_dequantize(q, s, getattr(torch, out_dtype))
    assert d.dtype == getattr(torch, out_dtype) and tuple(d.shape) == x.shape
    d32 = d.float().numpy()
    np.testing.assert_array_equal(
        ref.block_dequantize(q, s, getattr(torch, out_dtype)).float().numpy(), d32)
    kd = jops.block_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               getattr(jnp, out_dtype))
    np.testing.assert_array_equal(np.asarray(kd.astype(jnp.float32)), d32)
    if out_dtype == "float32":
        od = jref.block_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
        np.testing.assert_array_equal(np.asarray(od), d32)
        # bounded quantization error, as tests/test_kernels.py
        assert np.abs(d32 - x).max() <= np.abs(x).max() / 127.0 + 1e-6


def test_quantize_round_trips_exact_integers(no_launch):
    """An MP whose absmax is 127 holds integers: they come back unchanged."""
    x = torch.arange(-127, 129, dtype=torch.float32).clamp(max=127).reshape(1, 256)
    q, s = ops.block_quantize(x, 1)
    assert s.tolist() == [[1.0]]
    assert torch.equal(ops.block_dequantize(q, s), x)


@pytest.mark.parametrize("case", [
    "int_blocks", "uint8_blocks", "not_2d", "ragged_mps", "zero_mps",
    "non_contiguous", "meta_device", "q_not_int8", "scales_f64",
    "scales_rows", "out_int8", "mixed_devices"])
def test_wrappers_raise_value_error(case, no_launch):
    x = torch.zeros(4, 64)
    q, s = torch.zeros(4, 64, dtype=torch.int8), torch.ones(4, 2)
    calls = {
        "int_blocks": lambda: ops.block_quantize(x.to(torch.int32), 2),
        "uint8_blocks": lambda: ops.block_quantize(x.to(torch.uint8), 2),
        "not_2d": lambda: ops.block_quantize(x.reshape(-1), 2),
        "ragged_mps": lambda: ops.block_quantize(x, 3),
        "zero_mps": lambda: ops.block_quantize(x, 0),
        "non_contiguous": lambda: ops.block_quantize(x.t(), 2),
        "meta_device": lambda: ops.block_quantize(x.to("meta"), 2),
        "q_not_int8": lambda: ops.block_dequantize(q.to(torch.uint8), s),
        "scales_f64": lambda: ops.block_dequantize(q, s.double()),
        "scales_rows": lambda: ops.block_dequantize(q, s[:3]),
        "out_int8": lambda: ops.block_dequantize(q, s, torch.int8),
        "mixed_devices": lambda: ops.block_dequantize(q, s.to("meta")),
    }
    with pytest.raises(ValueError):
        calls[case]()


# -------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _card_vs_plain(x, mps, dtype, dev):
    xt = _torch(x, dtype)
    before = {k: ops.launches.get(k, 0) for k in ("quantize", "dequantize")}
    q, s = ops.block_quantize(xt.to(dev), mps)
    pq, ps = ref.block_quantize(xt, mps)
    assert torch.equal(q.cpu(), pq)
    assert torch.equal(s.cpu().view(torch.int32), ps.view(torch.int32))
    for out_dtype in DTYPES:
        odt = getattr(torch, out_dtype)
        d = ops.block_dequantize(q, s, odt)
        want = ref.block_dequantize(pq, ps, odt)
        assert torch.equal(d.cpu().view(torch.uint8), want.view(torch.uint8))
    assert ops.launches["quantize"] == before["quantize"] + 1
    assert ops.launches["dequantize"] == before["dequantize"] + len(DTYPES)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_equal_plain(cuda_device, shape, dtype):
    n, elems, mps = shape
    _card_vs_plain(_blocks(n, elems, mps, dtype), mps, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_on_special_and_unaligned_mps(cuda_device, dtype):
    x, mps = _special(dtype)
    _card_vs_plain(x, mps, dtype, cuda_device)
    # MPs of 37 elements: no MP but the first starts 16-byte aligned
    _card_vs_plain(_blocks(3, 5 * 37, 5, dtype), 5, dtype, cuda_device)


@pytest.mark.cuda
def test_cuda_kernels_at_the_kv_block_shape(cuda_device):
    """qwen3-4b's KV block: 64 tokens x 36 layers x K+V x 8 heads x 128 in
    bf16, 8 MPs of 589,824 elements; four blocks."""
    g = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.randn((4, 4_718_592), generator=g) * 4).bfloat16()
    _card_vs_plain(x.float().numpy(), 8, "bfloat16", cuda_device)


# MPs against the quantize kernel's clusters (up to 16 blocks of at most
# 72 KiB of an MP each where that covers it, held in shared memory up to
# 112 KiB a block): (n, elems, mps) -- an MP that one block takes, one
# that four take, one that sixteen take near the limit of shared memory
# in 16-bit types (past it in f32), one too large for it in every type
# (its blocks read it twice), odd lengths (blocks that start off a
# 16-byte boundary)
CLUSTER_CASES = {
    "one_block": (3, 3 * 4096, 3),
    "four_blocks": (2, 2 * 131072, 2),
    "sixteen_blocks": (2, 2 * 800_000, 2),
    "too_large": (1, 1 << 21, 1),
    "odd_lengths": (2, 3 * 100_003, 3),
    "odd_small": (5, 7 * 1001, 7),
}


@pytest.mark.cuda
def test_cuda_quantize_clusters_equal_plain(cuda_device):
    for case in sorted(CLUSTER_CASES):
        n, elems, mps = CLUSTER_CASES[case]
        for dtype in DTYPES:
            _card_vs_plain(_blocks(n, elems, mps, dtype, seed=1), mps, dtype,
                           cuda_device)


@pytest.mark.cuda
def test_cuda_quantize_all_zero_mps(cuda_device):
    """Every MP zero: scale 1 and q 0 in each, whatever its cluster."""
    x = np.zeros((2, 2 * 200_000), dtype=np.float32)
    for dtype in DTYPES:
        _card_vs_plain(x, 2, dtype, cuda_device)
        q, s = ops.block_quantize(_torch(x, dtype).to(cuda_device), 2)
        assert not q.any() and bool((s == 1).all())
