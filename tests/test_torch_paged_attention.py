"""Paged decode attention in the port (repro_torch.kernels) against the
reference.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the Pallas kernel in interpret mode (as tests/test_kernels.py runs it) on
that file's shape sweep, at the qwen3-4b geometry and with ragged and
zero lengths, within the sweep's tolerances (2e-5 for f32: sums taken in
another order; 2e-2 for f16/bf16: the output is rounded to the input
dtype). ``kv_len == 0`` gives zeros, as the Pallas kernel does.

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card and skip without one; they need neither JAX nor the reference, so
``python -m pytest -m cuda tests/test_torch_paged_attention.py`` runs them
on a machine that has only the port's dependencies.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# (B, H, KV, hd, bt, mbs): tests/test_kernels.py's sweep, then qwen3-4b's
# attention geometry (32 query / 8 KV heads of 128, 64-token blocks) at
# two blocks per sequence
SWEEP = [(2, 8, 2, 32, 8, 4), (1, 4, 4, 64, 16, 2), (3, 16, 1, 32, 8, 3)]
QWEN3_4B = (2, 32, 8, 128, 64, 2)
TOL = {np.float32: 2e-5, np.float16: 2e-2, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's Pallas kernel and oracle (imported here so that the
    ``cuda`` tests run where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


def _inputs(B, H, KV, hd, bt, mbs, dtype, seed, kv_len=None):
    """q, pool, a permuted block table (pool rows 2.. in random order) and
    lengths in [1, mbs*bt], as numpy; ``dtype`` "bfloat16" gives float32
    values already rounded to bf16."""
    rng = np.random.default_rng([7, B, H, KV, hd, bt, mbs, seed])
    npdt = np.float32 if dtype == "bfloat16" else dtype
    q = rng.standard_normal((B, H, hd)).astype(npdt)
    pool = rng.standard_normal((B * mbs + 2, bt, 2, KV, hd)).astype(npdt)
    if dtype == "bfloat16":
        q = torch.from_numpy(q).bfloat16().float().numpy()
        pool = torch.from_numpy(pool).bfloat16().float().numpy()
    table = (rng.permutation(B * mbs).astype(np.int32) + 2).reshape(B, mbs)
    if kv_len is None:
        kv_len = rng.integers(1, mbs * bt + 1, (B,))
    return q, pool, table, np.asarray(kv_len, np.int32)


def _torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.bfloat16() if dtype == "bfloat16" and t.is_floating_point() else t


def _pallas(jax_ref, q, pool, table, kv_len, dtype):
    jnp, jops, _ = jax_ref
    cast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" \
        else jnp.asarray
    out = jops.paged_decode_attention(cast(q), cast(pool), jnp.asarray(table),
                                      jnp.asarray(kv_len))
    return np.asarray(out.astype(jnp.float32))


@pytest.fixture
def no_launch():
    before = dict(ops.launches)
    yield
    # the CPU path runs the plain version and counts no launch
    assert ops.launches == before


# ------------------------------------------------------ plain vs Pallas
@pytest.mark.parametrize("shape", SWEEP + [QWEN3_4B],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16"],
                         ids=["f32", "f16", "bf16"])
def test_plain_matches_pallas(shape, dtype, jax_ref, no_launch):
    q, pool, table, kv_len = _inputs(*shape, dtype, seed=0)
    got = ops.paged_decode_attention(_torch(q, dtype), _torch(pool, dtype),
                                     _torch(table, dtype), _torch(kv_len, dtype))
    assert got.dtype == _torch(q, dtype).dtype and got.shape == q.shape
    want = _pallas(jax_ref, q, pool, table, kv_len, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SWEEP + [QWEN3_4B],
                         ids=lambda s: "x".join(map(str, s)))
def test_zero_and_ragged_lengths(shape, jax_ref, no_launch):
    """Row 0 has kv_len 0 (zeros, exactly as the Pallas kernel), row 1
    ends inside its last block, row 2 (where there is one) inside its
    first; the reference's oracle agrees wherever kv_len > 0."""
    B, H, KV, hd, bt, mbs = shape
    lens = [0, (mbs - 1) * bt + bt // 2 + 1, bt // 2][:B]
    if B == 1:
        lens = [0]
    q, pool, table, kv_len = _inputs(*shape, np.float32, seed=1, kv_len=lens)
    got = ops.paged_decode_attention(*map(torch.from_numpy, (q, pool, table,
                                                             kv_len))).numpy()
    want = _pallas(jax_ref, q, pool, table, kv_len, np.float32)
    assert np.array_equal(got[0], np.zeros_like(got[0]))
    assert np.array_equal(want[0], got[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    jnp, _, jref = jax_ref
    oracle = np.asarray(jref.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(table),
        jnp.asarray(kv_len)))
    live = kv_len > 0
    np.testing.assert_allclose(got[live], oracle[live], rtol=2e-5, atol=2e-5)


def test_plain_equals_decode_attention_on_the_gathered_view(no_launch):
    """Gathering the pool through the table and running the dense decode
    attention gives the plain paged version (f32: the scaling of q and the
    probabilities round nowhere)."""
    B, H, KV, hd, bt, mbs = QWEN3_4B
    q, pool, table, kv_len = _inputs(*QWEN3_4B, np.float32, seed=2)
    q, pool, table, kv_len = map(torch.from_numpy, (q, pool, table, kv_len))
    seq = pool[table.long()].reshape(B, mbs * bt, 2, KV, hd)
    want = TL.decode_attention(q[:, None], seq[:, :, 0], seq[:, :, 1],
                               kv_len=kv_len)[:, 0]
    got = ref.paged_decode_attention(q, pool, table, kv_len)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
def test_decode_attention_matches_reference(dtype, jax_ref):
    """``layers.decode_attention`` against the JAX function it copies, with
    the same rounding of q*scale and p to the input dtype (f32: 2e-5;
    bf16: 2e-2, the output's rounding)."""
    jnp = jax_ref[0]
    from repro.models import layers as JL
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, hd = 2, 24, 8, 2, 32
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    kv_len = np.array([S, 5], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(JL.decode_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), kv_len=jnp.asarray(kv_len)
    ).astype(jnp.float32))
    got = TL.decode_attention(*(_torch(x, dtype) for x in (q, k, v)),
                              kv_len=torch.from_numpy(kv_len)).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _split_merge_model(q, pool, table, kv_len, chunk=64, stage=16):
    """A plain-torch model of csrc/paged_attention.cu's work split: each
    (sequence, KV head) cut into splits of ``chunk`` positions; per split
    an online softmax over stages of ``stage`` tokens (m, l and acc = e.V
    rescaled by e^(m_old - m_new) at each stage); a sequence of one split
    writes acc / l, otherwise the splits merge as
    sum(acc_s e^(m_s - M)) / max(sum(l_s e^(m_s - M)), 1e-30); kv_len 0
    gives zeros. f32 throughout, q scaled in f32."""
    B, H, hd = q.shape
    _, bt, _, KV, _ = pool.shape
    g = H // KV
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n_pos = max(0, min(int(kv_len[b]), table.shape[1] * bt))
        pos = torch.arange(n_pos)
        rows = table[b, pos // bt].long() * bt + pos % bt
        kv = pool.reshape(-1, 2, KV, hd)[rows].float()      # (n_pos, 2, KV, hd)
        for kh in range(KV):
            qh = q[b, kh * g:(kh + 1) * g].float() * hd ** -0.5
            parts = []
            for p0 in range(0, n_pos, chunk):
                m = torch.full((g,), -1e30)
                l, acc = torch.zeros(g), torch.zeros(g, hd)
                for t0 in range(p0, min(p0 + chunk, n_pos), stage):
                    k = kv[t0:min(t0 + stage, p0 + chunk, n_pos), 0, kh]
                    v = kv[t0:min(t0 + stage, p0 + chunk, n_pos), 1, kh]
                    s = qh @ k.T                              # (g, tokens)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    e = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + e.sum(dim=1)
                    acc = acc * alpha[:, None] + e @ v
                    m = m_new
                parts.append((m, l, acc))
            if len(parts) == 1:
                m, l, acc = parts[0]
                o = acc / l[:, None]
            elif parts:
                M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                w = [torch.exp(m - M) for m, _, _ in parts]
                l = sum(li * wi for (_, li, _), wi in zip(parts, w))
                acc = sum(a * wi[:, None] for (_, _, a), wi in zip(parts, w))
                o = acc / torch.clamp(l, min=1e-30)[:, None]
            else:
                continue
            out[b, kh * g:(kh + 1) * g] = o
    return out.to(q.dtype)


@pytest.mark.parametrize("bt,mbs", [(64, 8), (8, 70)], ids=["bt64", "bt8"])
def test_split_merge_model_equals_plain(bt, mbs, no_launch):
    """The kernel's chunking and merge, modelled in plain torch, equal the
    plain version at lengths 0, 1, 63, 65 and 512 (one split, a split's
    edge, two splits, eight splits) within the f32 tolerance."""
    lens = [0, 1, 63, 65, 512]
    shape = (len(lens), 8, 2, 32, bt, mbs)
    q, pool, table, kv_len = map(torch.from_numpy, _inputs(
        *shape, np.float32, seed=11, kv_len=lens))
    want = ref.paged_decode_attention(q, pool, table, kv_len)
    got = _split_merge_model(q, pool, table, kv_len)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the wrapper
def test_table_entries_past_kv_len_are_never_read(no_launch):
    """Entries of blocks at or past ceil(kv_len / bt) may hold anything."""
    q, pool, table, kv_len = _inputs(2, 8, 2, 32, 8, 4, np.float32, seed=4,
                                     kv_len=[9, 0])
    args = list(map(torch.from_numpy, (q, pool, table, kv_len)))
    want = ops.paged_decode_attention(*args)
    args[2] = args[2].clone()
    args[2][0, 2:] = -5
    args[2][1, :] = 10**6
    torch.testing.assert_close(ops.paged_decode_attention(*args), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", [-1, 10])
def test_table_entry_out_of_range_raises(bad, no_launch):
    q, pool, table, kv_len = _inputs(2, 8, 2, 32, 8, 4, np.float32, seed=5,
                                     kv_len=[32, 17])
    table[1, 2] = bad                       # read: 17 tokens span 3 blocks
    with pytest.raises(IndexError, match=r"block_table\[1, 2\]"):
        ops.paged_decode_attention(*map(torch.from_numpy,
                                        (q, pool, table, kv_len)))


def test_wrapper_checks_shapes_dtypes_and_layout(no_launch):
    q, pool, table, kv_len = map(torch.from_numpy, _inputs(
        2, 8, 2, 32, 8, 4, np.float32, seed=6))
    f = ops.paged_decode_attention
    with pytest.raises(ValueError):
        f(q[0], pool, table, kv_len)                        # q not 3-D
    with pytest.raises(ValueError):
        f(q[:, :7].contiguous(), pool, table, kv_len)       # 7 heads, 2 KV
    with pytest.raises(ValueError):
        f(q, pool[..., :16].contiguous(), table, kv_len)    # hd mismatch
    with pytest.raises(ValueError):
        f(q, pool, table[:1], kv_len)                       # batch mismatch
    with pytest.raises(TypeError):
        f(q, pool, table.long(), kv_len)                    # int64 table
    with pytest.raises(TypeError):
        f(q, pool, table, kv_len.long())
    with pytest.raises(ValueError):
        f(q.transpose(0, 1).contiguous().transpose(0, 1), pool, table, kv_len)


def test_kernel_path_takes_only_cuda_or_cpu(no_launch):
    """Off the card and the CPU nothing runs: meta tensors (the dry run)
    get the output's shape and dtype from the plain version, no launch;
    tensors on two devices are refused. (The swap wrappers refuse meta
    tensors: tests/test_torch_kernels.py.)"""
    args = [torch.empty((2, 8, 32), device="meta"),
            torch.empty((10, 8, 2, 2, 32), device="meta"),
            torch.zeros((2, 4), dtype=torch.int32, device="meta"),
            torch.zeros((2,), dtype=torch.int32, device="meta")]
    out = ops.paged_decode_attention(*args)
    assert out.device.type == "meta" and out.shape == (2, 8, 32)
    assert out.dtype == torch.float32
    args[3] = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="tensors on meta and cpu"):
        ops.paged_decode_attention(*args)


def test_splits_cover_the_table():
    """One split (thread block) per 64 positions of the table: the serve
    shape's 32 blocks of 64 tokens take 32, a reduced table of 2 blocks
    of 8 tokens one."""
    assert ops.attn_splits(32, 64) == 32
    assert ops.attn_splits(2, 8) == 1
    assert ops.attn_splits(3, 8) == 1 and ops.attn_splits(9, 8) == 2
    assert all(ops.attn_splits(m, bt) * 64 >= m * bt
               for m in range(1, 40) for bt in (8, 16, 64))


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel runs only there)")
    return torch.device("cuda")


CARD_CASES = [(s, dt) for s in SWEEP for dt in (np.float32, np.float16)] + [
    (QWEN3_4B, "bfloat16"), ((8, 32, 8, 128, 64, 32), "bfloat16"),
    ((3, 4, 2, 32, 8, 20), np.float32),
    ((2, 8, 2, 32, 8, 4), "f32_over_bf16"), ((2, 48, 1, 128, 64, 2), "bfloat16"),
    ((6, 32, 8, 128, 64, 8), "bfloat16"), ((5, 8, 2, 64, 8, 40), np.float32),
    ((4, 14, 2, 64, 16, 12), np.float16)]
# lengths of the cases above that pin them (the others draw theirs): each
# ends partway through a 16-token stage of the kernel's ring and partway
# through a 64-position split, and neighbours differ by more than a split
CARD_LENGTHS = {(6, 32, 8, 128, 64, 8): [0, 17, 100, 200, 501, 1],
                (5, 8, 2, 64, 8, 40): [0, 40, 130, 1, 319],
                (4, 14, 2, 64, 16, 12): [0, 191, 7, 72]}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", CARD_CASES,
                         ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else str(getattr(c, "__name__", c)))
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype):
    """The kernel against the plain version on the same card inputs, with
    a zero, a one-token and a ragged length among them; one launch."""
    B, H, KV, hd, bt, mbs = shape
    pool_dt = "bfloat16" if dtype == "f32_over_bf16" else dtype
    q, pool, table, kv_len = _inputs(*shape, pool_dt, seed=8)
    kv_len[0] = 0
    if shape in CARD_LENGTHS:
        kv_len[:] = CARD_LENGTHS[shape]
    elif B > 2:
        kv_len[1], kv_len[2] = 1, bt + 1
    qt = torch.from_numpy(q).to(cuda_device)
    if dtype != "f32_over_bf16":
        qt = _torch(q, dtype).to(cuda_device)
    args = [qt, _torch(pool, pool_dt).to(cuda_device),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(kv_len).to(cuda_device)]
    ops.reset_launches()
    got = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.launches.get("paged_attn") == 1
    want = ref.paged_decode_attention(*args)
    tol = 2e-5 if qt.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", [
    ((8, 32, 8, 128, 64, 32), [512, 17, 0, 2048, 65, 1000, 64, 1]),
    ((3, 16, 1, 32, 8, 20), [160, 0, 77])], ids=["serve", "mqa16"])
def test_cuda_kernel_repeats_and_graph_replays(cuda_device, shape, lens):
    """The merge's per-(sequence, KV head) counters go back to 0: the same
    launch twice in a row, then a CUDA graph of it replayed five times,
    each equal to the plain version."""
    dtype = "bfloat16" if shape[3] == 128 else np.float32
    q, pool, table, kv_len = _inputs(*shape, dtype, seed=12, kv_len=lens)
    args = [_torch(q, dtype).to(cuda_device), _torch(pool, dtype).to(cuda_device),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(kv_len).to(cuda_device)]
    want = ref.paged_decode_attention(*args).float()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for _ in range(2):
        got = ops.paged_decode_attention(*args)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    out = torch.empty_like(args[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.launch_paged_attn(*args, out)        # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ops.launch_paged_attn(*args, out)
    for _ in range(5):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b", "qwen2.5-32b",
                                  "granite-20b"])
def test_cuda_kernel_takes_every_dense_geometry(cuda_device, arch):
    """Each dense config's full-width heads (granite's 48:1 MQA needs the
    most shared memory) over 64-token blocks, bf16, against the plain
    version."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    shape = (2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, 64, 3)
    q, pool, table, kv_len = _inputs(*shape, "bfloat16", seed=10)
    args = [_torch(q, "bfloat16").to(cuda_device),
            _torch(pool, "bfloat16").to(cuda_device),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(kv_len).to(cuda_device)]
    got = ops.paged_decode_attention(*args)
    want = ref.paged_decode_attention(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen2-vl-2b"])
def test_cuda_kernel_takes_the_families_head_groups(cuda_device, arch):
    """jamba's attention layer (64/8 heads of 128, group 8) and qwen2-vl
    (12/2, group 6) at the serve phase's batch, 64-token blocks and 2048
    positions, bf16, lengths from 0 to the table's end; one launch each,
    against the plain version."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    shape = (8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, 64, 32)
    q, pool, table, kv_len = _inputs(*shape, "bfloat16", seed=14,
                                     kv_len=[0, 1, 63, 64, 65, 512, 2048, 1000])
    args = [_torch(q, "bfloat16").to(cuda_device),
            _torch(pool, "bfloat16").to(cuda_device),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(kv_len).to(cuda_device)]
    ops.reset_launches()
    got = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.launches.get("paged_attn") == 1
    want = ref.paged_decode_attention(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_head_size_it_does_not_take(cuda_device):
    """The source decides which head sizes it compiles: hd 48 fails the
    launch with the library's return code, not a wild launch."""
    q, pool, table, kv_len = _inputs(2, 8, 2, 48, 8, 4, np.float32, seed=9)
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, pool, table, kv_len)]
    with pytest.raises(RuntimeError, match="hd 48"):
        ops.paged_decode_attention(*args)


@pytest.mark.cuda
def test_cuda_kernel_refuses_pairs_it_does_not_take(cuda_device):
    q, pool, table, kv_len = _inputs(2, 8, 2, 32, 8, 4, np.float32, seed=9)
    dev = cuda_device
    with pytest.raises(TypeError):
        ops.paged_decode_attention(
            torch.from_numpy(q).half().to(dev),
            torch.from_numpy(pool).bfloat16().to(dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(kv_len).to(dev))


@pytest.mark.cuda
def test_cuda_kernel_traps_on_a_table_entry_out_of_range(cuda_device):
    """A table entry the kernel reads outside the pool fails the launch
    loudly (a device trap, surfacing at the next synchronise); run in a
    child process, since a trap leaves the context unusable."""
    code = (
        "import torch; from repro_torch.kernels import ops; "
        "d = 'cuda'; q = torch.randn(1, 4, 32, device=d); "
        "pool = torch.randn(4, 8, 2, 1, 32, device=d); "
        "table = torch.tensor([[0, 9]], dtype=torch.int32, device=d); "
        "n = torch.tensor([12], dtype=torch.int32, device=d); "
        "ops.paged_decode_attention(q, pool, table, n); "
        "torch.cuda.synchronize(); print('no trap')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no trap" not in proc.stdout
