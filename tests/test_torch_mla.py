"""DeepSeek-V2 on the port's serving path: latent attention (MLA) over a
paged latent pool, its paged kernel, YaRN rope, raw top-k gates.

On the CPU, a tiny MLA + MoE config (D 64, 4 heads, latent 32, rope 16,
nope 16, v 16, 8 experts top-2, 1 shared, 3 layers, the first dense) in
float32 with seeded random weights is held against the plain reference
``tests/ref_deepseek_v2.py`` (hf ``DeepseekV2ForCausalLM``'s equations,
published form, no cache): token by token through ``serve_step`` (the
absorbed form over the latent pool) and through ``forward``, at every
position, within relative 1e-4 of the logits' scale. Both sides compute
in float32 and the two forms differ only in the order of the products,
which moves a logit by about 1e-6 of that scale here; a wrong rope
convention, scale or gate moves it by more than 1e-2.

The ``cuda`` tests need the card and neither JAX nor the JAX package:
``python -m pytest -q -m cuda tests/test_torch_mla.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import ref_deepseek_v2 as R  # noqa: E402

from repro_torch.configs import ARCH_IDS, PORT_MODULES, get_config  # noqa: E402
from repro_torch.core.elastic_kv import KVGeometry, make_kv_taiji_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import op_count  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.config import (MLAConfig, PortArchConfig,  # noqa: E402
                                       PortMoEConfig, YaRNConfig, yarn_mscale)
from repro_torch.obs import render_prom  # noqa: E402
from repro_torch.core.metrics import Metrics  # noqa: E402
from repro_torch.obs.tracer import (DECODE_CAPTURE, DECODE_EAGER,  # noqa: E402
                                    DECODE_REPLAY, ST_DECODE_STEP,
                                    SpanTracer)
from repro_torch.train import steps  # noqa: E402

RTOL = 1e-4
# mscale != mscale_all_dim, so the cos/sin scale is not 1 here
TINY_YARN = dict(factor=40.0, original_max_position_embeddings=64, beta_fast=32,
                 beta_slow=1, mscale=0.9, mscale_all_dim=0.707)


def tiny_config(**over) -> PortArchConfig:
    cfg = PortArchConfig(
        name="tiny-mla", family="moe", vocab=128, d_model=64, n_layers=3,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96,
        moe=PortMoEConfig(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1,
                          first=1, norm_topk_prob=False),
        rope_theta=1e4, norm_eps=1e-6,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                      v_head_dim=16),
        rope_scaling=YaRNConfig(**TINY_YARN), param_dtype="float32",
        compute_dtype="float32", kv_block_tokens=4)
    return dataclasses.replace(cfg, **over)


def hf_keys(cfg: PortArchConfig) -> dict:
    """The config's hf ``config.json`` keys, which the reference reads."""
    a, m, y = cfg.mla, cfg.moe, cfg.rope_scaling
    return dict(num_attention_heads=cfg.n_heads, kv_lora_rank=a.kv_lora_rank,
                qk_nope_head_dim=a.qk_nope_head_dim,
                qk_rope_head_dim=a.qk_rope_head_dim, v_head_dim=a.v_head_dim,
                rope_theta=cfg.rope_theta,
                rope_scaling=None if y is None else dataclasses.asdict(y),
                rms_norm_eps=cfg.norm_eps, num_hidden_layers=cfg.n_layers,
                first_k_dense_replace=m.first, num_experts_per_tok=m.top_k,
                norm_topk_prob=m.norm_topk_prob, routed_scaling_factor=1.0,
                n_routed_experts=m.n_routed, n_shared_experts=m.n_shared)


def tiny_model(seed=0, cfg=None):
    """Seeded weights, the matrices scaled up from the initializer's 0.02
    so that attention and routing are far from uniform."""
    cfg = cfg or tiny_config()
    model = M.init_params(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.mul_(8.0)
    return cfg, model


def _close(got, want):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max())
    assert err <= RTOL * float(want.abs().max()), err


# -------------------------------------------------------- against the reference
@pytest.mark.parametrize("seed", [0, 1])
def test_token_by_token_decode_matches_the_reference(seed):
    """serve_step through the latent pool (blocks of 4 tokens, 14 steps:
    across three block boundaries) against the full forward of each
    sequence, at every position."""
    cfg, model = tiny_model(seed)
    B, T = 3, 14
    toks = torch.randint(0, cfg.vocab, (B, T), generator=torch.Generator().manual_seed(seed))
    cache = M.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    assert "latent_pool" in cache and "kv_pool" not in cache
    got = []
    for t in range(T):
        logits, cache = steps.serve_step(model, toks[:, t], cache, cfg)
        got.append(logits)
    got = torch.stack(got, 1)
    w = dict(model.named_parameters())
    for b in range(B):
        _close(got[b], R.forward(w, hf_keys(cfg), toks[b]))
    assert cache["kv_len"].tolist() == [T] * B


def test_forward_prefill_and_loss_match_the_reference():
    cfg, model = tiny_model(2)
    toks = torch.randint(0, cfg.vocab, (2, 11), generator=torch.Generator().manual_seed(5))
    hidden, _ = M.forward(model, cfg, {"tokens": toks}, remat=True)
    logits = M.logits_from_hidden(model, cfg, hidden)
    w = dict(model.named_parameters())
    for b in range(2):
        _close(logits[b], R.forward(w, hf_keys(cfg), toks[b]))
    last, _ = steps.prefill_step(model, {"tokens": toks}, cfg)
    _close(last, logits[:, -1])
    loss, parts = M.loss_fn(model, cfg, {"tokens": toks, "labels": toks.roll(-1, 1)})
    loss.backward()
    assert torch.isfinite(loss) and model.layers[0].attn.wkv_b.grad.abs().sum() > 0


# ----------------------------------------------------------------- the kernel
def _dense_latent_attention(q, rows, n, R, scale):
    """One sequence's latent attention over its first n rows, dense."""
    s = torch.einsum("hw,sw->hs", q.double(), rows[:n].double()) * scale
    return torch.softmax(s, -1) @ rows[:n, :R].double()


@pytest.mark.parametrize("kv_lens", [[0, 1, 7, 8], [13, 4, 16, 9]])
def test_plain_paged_mla_is_a_dense_softmax(kv_lens):
    """The plain version through a shuffled block table against a dense
    softmax of each sequence's rows in order; kv_len 0 gives zeros."""
    g = torch.Generator().manual_seed(3)
    B, H, W, R, bt, mbs = len(kv_lens), 4, 48, 32, 4, 4
    pool = torch.randn(B * mbs + 3, bt, W, generator=g)
    table = torch.randperm(B * mbs + 3, generator=g)[:B * mbs].view(B, mbs).int()
    q = torch.randn(B, H, W, generator=g)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32)
    out = ops.paged_mla_decode(q, pool, table, kv_len, R, 0.3)
    assert out.shape == (B, H, R) and out.dtype == q.dtype
    for b, n in enumerate(kv_lens):
        rows = pool[table[b].long()].reshape(mbs * bt, W)
        want = (torch.zeros(H, R, dtype=torch.float64) if n == 0
                else _dense_latent_attention(q[b], rows, n, R, 0.3))
        torch.testing.assert_close(out[b].double(), want, atol=1e-5, rtol=1e-5)


def test_paged_mla_wrapper_checks_its_operands():
    q, pool = torch.zeros(2, 4, 48), torch.zeros(8, 4, 48)
    table, kv_len = torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.paged_mla_decode(q, torch.zeros(8, 4, 40), table, kv_len, 32, 1.0)
    with pytest.raises(TypeError):
        ops.paged_mla_decode(q, pool, table.long(), kv_len, 32, 1.0)
    with pytest.raises(IndexError):
        ops.paged_mla_decode(q, pool, table + 8, kv_len, 32, 1.0)


def test_latent_rows_written_across_a_block_boundary():
    cfg = tiny_config()
    cache = M.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    pool_l, table, W = cache["latent_pool"][1], cache["block_table"], cfg.mla.latent_dim
    assert cache["latent_pool"].shape == (cfg.n_layers, 2 * 4, 4, W)
    g = torch.Generator().manual_seed(0)
    rows = {}
    for p in (2, 3, 4, 5):              # positions 3 and 4 straddle a block
        r = torch.randn(2, W, generator=g)
        M._paged_kv_write(pool_l, table, torch.tensor([p, p + 4]), r, None,
                          cfg.kv_block_tokens)
        rows[p] = r
    for p, r in rows.items():
        for b, pos in ((0, p), (1, p + 4)):
            blk = int(table[b, pos // 4])
            assert torch.equal(pool_l[blk, pos % 4], r[b])
    assert int((pool_l.abs().sum(-1) != 0).sum()) == 8
    assert float(cache["latent_pool"][0].abs().sum()) == 0.0


# --------------------------------------------------------------- rope, gates
def test_yarn_frequencies_and_scale_at_the_published_values():
    """The closed form at DeepSeek-V2-Lite's values: rope dim 64, theta
    1e4, factor 40 over 4096 positions, beta 32 / 1, mscale 0.707: the
    ramp runs over pairs 10 .. 23."""
    import math
    cfg = get_config("deepseek-v2-lite")
    inv = TL.yarn_inv_freq(64, 1e4, cfg.rope_scaling)
    i = torch.arange(32, dtype=torch.float64)
    base = 1.0 / 1e4 ** (2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    torch.testing.assert_close(inv.double(), want, rtol=1e-6, atol=0)
    assert bool((inv[:10] == (1.0 / 1e4 ** (torch.arange(10) * 2 / 64.0))).all())
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale() == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert cfg.rope_scaling.cos_sin_scale == 1.0
    assert yarn_mscale(1.0, 0.707) == 1.0
    cos, sin = TL.rope_cos_sin(tiny_config(), torch.arange(5))
    k = yarn_mscale(40, 0.9) / yarn_mscale(40, 0.707)
    torch.testing.assert_close(cos[0], torch.full((8,), k))


def test_deinterleave_sends_pairs_to_halves():
    x = torch.arange(8.0)
    assert TL.deinterleave(x).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("norm", [True, False])
def test_topk_gates_raw_or_renormalised(norm):
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(10, 16, generator=g), torch.randn(16, 8, generator=g)
    gates, idx, _ = TMoE.router_topk(x, w, 3, norm)
    probs = torch.softmax(x @ w, -1)
    want = torch.topk(probs, 3, -1)
    assert torch.equal(idx, want.indices)
    raw = want.values
    torch.testing.assert_close(gates, raw / raw.sum(-1, keepdim=True) if norm else raw)


def test_decode_is_dropless_at_64_tokens():
    """64 experts top-6 at the cell's batch: 64 slots per expert, so every
    token keeps each of its experts even when all 64 pick the same ones."""
    m = get_config("deepseek-v2-lite").moe
    assert TMoE.capacity(64, m) == 64 and TMoE.capacity(65, m) == 64
    cfg = tiny_config(d_model=16, moe=PortMoEConfig(
        n_routed=64, top_k=6, d_ff_expert=8, n_shared=0, first=1, norm_topk_prob=False))
    g = torch.Generator().manual_seed(6)
    p = {"router": torch.zeros(16, 64), "w_gate": torch.randn(64, 16, 8, generator=g),
         "w_up": torch.randn(64, 16, 8, generator=g),
         "w_down": torch.randn(64, 8, 16, generator=g)}
    p["router"][:, :6] = 1.0            # every token's top 6 are experts 0-5
    x = torch.rand(64, 16, generator=g) + 0.5
    out, _ = TMoE._dispatch_tokens(x, p, cfg)
    gates, idx, _ = TMoE.router_topk(x, p["router"], 6, False)
    want = torch.zeros_like(x)
    for t in range(64):
        for gate, e in zip(gates[t], idx[t]):
            h = torch.nn.functional.silu(x[t] @ p["w_gate"][e]) * (x[t] @ p["w_up"][e])
            want[t] += gate * (h @ p["w_down"][e])
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ configuration
def test_the_published_config_resolves_outside_arch_ids():
    cfg = get_config("deepseek-v2-lite")
    assert ARCH_IDS == ["qwen3-4b", "qwen2.5-32b", "qwen2-0.5b", "granite-20b",
                        "deepseek-moe-16b", "qwen3-moe-235b-a22b",
                        "jamba-1.5-large-398b", "hubert-xlarge", "qwen2-vl-2b",
                        "falcon-mamba-7b"]
    assert "deepseek-v2-lite" in PORT_MODULES and "deepseek-v2-lite" not in ARCH_IDS
    a, m = cfg.mla, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.d_ff) == \
        (27, 2048, 16, 102400, 10944)
    assert (a.kv_lora_rank, a.q_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
            a.v_head_dim) == (512, None, 128, 64, 128)
    assert (m.n_routed, m.top_k, m.d_ff_expert, m.n_shared, m.first,
            m.norm_topk_prob) == (64, 6, 1408, 2, 1, False)
    assert not cfg.tie_embeddings and cfg.norm_eps == 1e-6 and cfg.rope_theta == 1e4
    assert cfg.param_count() == 15_706_484_224
    model = M.Model(cfg, torch.bfloat16, "meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    # the reference's schema is untouched: a base config has no MLA field
    base = get_config("deepseek-moe-16b")
    assert base.mla is None and base.moe.norm_topk_prob
    assert "mla" not in dataclasses.asdict(base)
    assert "norm_topk_prob" not in dataclasses.asdict(base)["moe"]


def test_kv_geometry_sizes_a_latent_block_as_one_ms():
    cfg = get_config("deepseek-v2-lite")
    geom = KVGeometry.for_config(cfg)
    assert (geom.block_tokens, geom.token_shape) == (64, (27, 576))
    assert geom.block_bytes == 1_990_656
    tcfg = make_kv_taiji_config(geom, 64)
    tcfg.validate()
    assert tcfg.ms_bytes == geom.block_bytes
    assert KVGeometry(n_layers=36, kv_heads=8, head_dim=128,
                      block_tokens=64).block_bytes == 9 * 2 ** 20
    assert KVGeometry.for_config(get_config("qwen3-4b")) == KVGeometry(
        n_layers=36, kv_heads=8, head_dim=128, block_tokens=64)


def test_run_serving_reads_latent_blocks_back():
    """The elastic KV cache holds an MLA config's latent rows: run_serving
    sizes its MSs from the config and reads every block back as it was
    appended."""
    cfg = tiny_config()
    stats = run_serving(cfg, n_seqs=4, phys_blocks=64, turns=3, batch=2,
                        prompt_len=6, gen_len=3, device="cpu", verify=True,
                        verbose=False)
    assert stats["verified_blocks"] == stats["residency"]["total_blocks"] > 4
    assert KVGeometry.for_config(cfg).block_bytes == cfg.kv_block_tokens * 3 * 48 * 2


# ------------------------------------------------------- the step, its spans
def test_the_step_is_eager_with_its_spans():
    """Off the card the step runs eagerly and gives each layer's spans; on
    the card the rule admits the latent pool's step to the graph, MoE
    layers and all, but not with ``input_embeds`` or ``mrope_pos``."""
    cfg, model = tiny_model(3)
    meta = M.init_cache(cfg, 2, 8, device="meta")
    assert M.graph_eligible(cfg, torch.device("cuda"), meta)
    assert not M.graph_eligible(cfg, torch.device("cpu"), meta)
    assert not M.graph_eligible(cfg, torch.device("cuda"), meta,
                                input_embeds=torch.zeros(2, cfg.d_model))
    assert not M.graph_eligible(cfg, torch.device("cuda"), meta,
                                mrope_pos=torch.zeros(3, 2, 1, dtype=torch.long))
    cache = M.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    tr = SpanTracer()
    for t in range(3):
        _, cache = steps.serve_step(model, torch.tensor([t, t + 1]), cache, cfg,
                                    tracer=tr)
    tot = tr.totals()
    assert DECODE_EAGER == 0
    assert tot["decode_step"]["count"] == 3 and list(tot["decode_step"]["by_tag"]) == [0]
    assert tot["mla_attn"]["count"] == 3 * cfg.n_layers
    assert tot["moe_ffn"]["count"] == 3 * (cfg.n_layers - 1)
    assert tot["mla_attn"]["total_ns"] + tot["moe_ffn"]["total_ns"] \
        <= tot["decode_step"]["total_ns"]
    for span in tr.spans():
        if span[0] != ST_DECODE_STEP:
            assert span[3] == 0
    m = Metrics()
    text = render_prom(m, tracer=tr)
    assert 'stage="mla_attn"' in text and 'stage="moe_ffn"' in text


def test_a_meta_dry_run_counts_the_paged_mla_kernel():
    """Published widths, two layers, batch 2 over a 128-position pool: the
    wrapper reports the kernel's own FLOPs and bytes, one call a layer."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), n_layers=2)
    model = M.init_params(cfg, seed=0, device="meta")
    cache = M.init_cache(cfg, 2, 128, device="meta")
    tokens = torch.zeros(2, dtype=torch.long, device="meta")
    ops.reset_launches()
    _, cost = op_count.count(steps.serve_step, model, tokens, cache, cfg)
    calls, flops, nbytes = cost.by_op["paged_mla_kernel"]
    rows = 2 * 128
    assert calls == 2
    assert flops == 2 * 2 * rows * 16 * (576 + 512)
    io = 2 * (2 * 16 * 576 + 2 * 16 * 512) + 2 * 2 * 4 + 2 * 4
    assert nbytes == 2 * (rows * 576 * 2 + io)
    assert "paged_mla" not in ops.launches and "paged_attn_kernel" not in cost.by_op


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the paged MLA kernel runs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_matches_its_plain_version(cuda_device, dtype):
    """16 heads x 576 / 512 through a shuffled table of 64-token blocks:
    kv_len 0, 1, a partial block, whole blocks, one and several 256-position
    splits. bf16 operands: the kernel rounds the probabilities to bf16 for
    the tensor cores and its output to bf16, within 2e-2 of the f32 plain
    version; f32 within 2e-5 (sums in another order)."""
    g = torch.Generator(device="cpu").manual_seed(9)
    kv_lens = [0, 1, 37, 64, 255, 256, 257, 600, 1024]
    B, bt, mbs = len(kv_lens), 64, 16
    n_blocks = B * mbs + 5
    pool = torch.randn(n_blocks, bt, 576, generator=g).to(cuda_device, dtype)
    table = torch.randperm(n_blocks, generator=g)[:B * mbs].view(B, mbs).int().to(cuda_device)
    q = torch.randn(B, 16, 576, generator=g).to(cuda_device, dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=cuda_device)
    scale = get_config("deepseek-v2-lite").softmax_scale()
    before = ops.launches.get("paged_mla", 0)
    out = ops.paged_mla_decode(q, pool, table, kv_len, 512, scale)
    torch.cuda.synchronize()
    assert ops.launches["paged_mla"] == before + 1
    want = ref.paged_mla_decode(q.float(), pool.float(), table, kv_len, 512, scale)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=tol)
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_published_width_layers_decode_against_the_reference(cuda_device, dtype):
    """DeepSeek-V2-Lite at its published widths, layer 0 dense and one MoE
    layer, 4 sequences decoded token by token over 80 steps (across the
    64-token block boundary) against the plain reference's full forward on
    the card (TF32 off). float32: within 1e-3 of the logits' scale (the
    two forms in float32 on the card); bfloat16 weights, compute and pool
    (the reference in float32 from the same bf16 weights): within 5e-2 of
    that scale, bf16 keeping about 3 significant digits of each product's
    inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), n_layers=2,
                              param_dtype=dtype, compute_dtype=dtype)
    model = M.init_params(cfg, seed=4, device=cuda_device)
    B, T = 4, 80
    toks = torch.randint(0, cfg.vocab, (B, T), generator=torch.Generator().manual_seed(2))
    toks = toks.to(cuda_device)
    cache = M.init_cache(cfg, B, 128, dtype=M.DTYPES[dtype], device=cuda_device)
    before = ops.launches.get("paged_mla", 0)
    got = []
    for t in range(T):
        logits, cache = steps.serve_step(model, toks[:, t], cache, cfg)
        got.append(logits.float())
    got = torch.stack(got, 1)
    assert ops.launches["paged_mla"] == before + 2 * T
    w = {n: p.float() for n, p in model.named_parameters()}
    tol = 1e-3 if dtype == "float32" else 5e-2
    for b in range(B):
        want = R.forward(w, hf_keys(cfg), toks[b])
        err = float((got[b] - want).abs().max())
        assert err <= tol * float(want.abs().max()), (b, err)


@pytest.mark.cuda
def test_the_captured_step_equals_the_eager_body(cuda_device):
    """DeepSeek-V2-Lite at its published widths, layer 0 dense and one MoE
    layer, float32, at the cell's batch of 64 (each expert's 64 slots
    dropless) over 70 steps across the 64-token block boundary: the step
    that ``serve_step`` captures and replays against ``decode_body`` run
    eagerly on a second cache. The MoE combine adds each token's six
    expert outputs with atomics, in no fixed order, so the two agree
    within 1e-5 of the logits' scale and not bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = M.init_params(cfg, seed=5, device=cuda_device)
    B, T = 64, 70
    cg = M.init_cache(cfg, B, 128, dtype=torch.float32, device=cuda_device)
    ce = M.init_cache(cfg, B, 128, dtype=torch.float32, device=cuda_device)
    gen = torch.Generator().manual_seed(21)
    tr = SpanTracer()
    before = ops.launches.get("paged_mla", 0)
    for t in range(T):
        toks = torch.randint(0, cfg.vocab, (B,), generator=gen).to(cuda_device)
        lg, cg = steps.serve_step(model, toks, cg, cfg, tracer=tr)
        with torch.no_grad():
            le, kv_len = M.decode_body(model, cfg, toks, ce)
        ce = dict(ce, kv_len=kv_len)
        err = float((lg - le).abs().max())
        assert err <= 1e-5 * float(le.abs().max()), (t, err)
        assert torch.equal(cg["kv_len"], ce["kv_len"]), f"kv_len at step {t}"
    torch.testing.assert_close(cg["latent_pool"], ce["latent_pool"],
                               atol=1e-5, rtol=1e-5)
    assert ops.launches["paged_mla"] == before + 2 * 2 * T
    tags = [tag for stage, _, _, tag, _ in tr.spans() if stage == ST_DECODE_STEP]
    assert tags == [DECODE_EAGER, DECODE_CAPTURE] + [DECODE_REPLAY] * (T - 2)
    assert "moe_ffn" not in tr.totals()          # no host dispatch to span
