"""The MLA decode cell (``dsv2-lite.decode-b64-native``) on the CPU at a
tiny size: the driver's weights are the program's parameters, a run
through the harness is correct and reports its metrics (untraced the
end-to-end ones, traced the per-layer ones that do not read the device
trace), the readers find nothing where nothing was recorded, the bounds
count what a hand count gives, and the plain reference and its float8
control run without the program."""
import ast
import copy
import math

import pytest
import torch

from taiji_bench import bench, bounds_mla
from taiji_bench.drivers import mla_decode
from taiji_bench.reference import deepseek_v2
from taiji_bench.tests.tiny import ROOT, execute

CELL = "dsv2-lite.decode-b64-native"
NEW = ["paged_mla_roofline.dsv2", "decode_mfu.dsv2", "decode_step_p95_ms.dsv2",
       "moe_host_share.dsv2"]


def tiny_dsv2(dtype: str = "bfloat16") -> dict:
    """DeepSeek-V2-Lite's keys at a tiny size, the initializer scaled up
    so that the program's widest gap reads about as qwen3's tiny one does
    (0.08-0.16 on three seeds; at ``tiny_qwen``'s 0.35, each product's
    gain of 8 x 0.35 over three layers takes it to 0.6-1.9)."""
    c = copy.deepcopy(bench.config_file("deepseek-v2-lite"))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
             intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1, num_hidden_layers=3,
             vocab_size=512, initializer_range=0.2)
    c["rope_scaling"].update(original_max_position_embeddings=64)
    c["serving"].update(dtype=dtype, kv_block_tokens=16)
    return c


def tiny_run(seconds=1.0, trace=False, seed=2**31 + 11, dtype="bfloat16"):
    cell, _, traffic, e2e, per_layer = bench.resolve(CELL)
    traffic = dict(traffic, prompt_tokens=8, max_seq=48, batch=4)
    run = bench.Run(cell=cell, config=tiny_dsv2(dtype), traffic=traffic, seed=seed,
                    seconds=seconds, trace=trace, device="cpu")
    return run, e2e, per_layer


def test_the_drivers_weights_are_the_programs_parameters():
    from repro_torch.models import model as M
    config = bench.config_file("deepseek-v2-lite")
    cfg = mla_decode.arch_config(config)
    params = dict(M.Model(cfg, torch.bfloat16, "meta").named_parameters())
    shapes = mla_decode.weight_shapes(config)
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: s for n, (s, _) in shapes.items()}
    assert sum(math.prod(s) for s, _ in shapes.values()) == cfg.param_count() == 15_706_484_224


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct_and_reports_its_metrics(trace):
    run, e2e, per_layer = tiny_run(trace=trace)
    r = execute(run, e2e, per_layer)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in (per_layer if trace else e2e)}
    device = {m["name"] for m in per_layer if m["source"] == "device_trace"}
    assert set(r["metrics"]) == want - (device if trace else set())
    if trace:
        assert set(NEW) - device <= set(r["metrics"])
        assert 0 < r["metrics"]["moe_host_share.dsv2"]["value"] < 100
    else:
        assert set(r["metrics"]) == {"decode_tokens_per_s", "setup_s"}


def test_the_readers_find_nothing_where_nothing_was_recorded():
    run, _, _ = tiny_run(seconds=0.3)
    driver = bench.driver_class(run.traffic["driver"])(run)
    try:
        driver.setup()
        w = driver.window(0.3)
    finally:
        driver.close()
    assert w["spans"] == {}
    obs = {"window": w, "config": run.config, "traffic": run.traffic}
    assert bench.reader("moe_host_share.dsv2")(obs) is None
    assert bench.reader("paged_mla_roofline.dsv2")(obs) is None
    assert bench.reader("decode_step_p95_ms.dsv2")(obs) > 0
    assert bench.reader("decode_mfu.dsv2")(obs) > 0
    # a program that records no moe_ffn span (the parent's) reads nothing
    obs["window"] = dict(w, spans={"decode_step": {0: 5_000}})
    assert bench.reader("moe_host_share.dsv2")(obs) is None


def test_replayed_steps_dispatch_no_moe_from_the_host():
    """Steps replayed from a CUDA graph (tag 1) give no ``moe_ffn`` span:
    the share reads 0 there, and a mix with eager steps reads their share."""
    read = bench.reader("moe_host_share.dsv2")
    assert read({"window": {"spans": {"decode_step": {0: 0, 1: 9_000, 2: 0}}}}) == 0.0
    assert read({"window": {"spans": {"decode_step": {0: 1_000, 1: 3_000},
                                      "moe_ffn": {0: 400}}}}) == 10.0
    assert read({"window": {"spans": {"decode_step": {0: 1_000, 1: 3_000}}}}) is None


def test_the_bounds_count_what_a_hand_count_gives():
    c = bench.config_file("deepseek-v2-lite")
    # per layer q 2048 x 3072, kv_a 2048 x 576, kv_b 512 x 4096, o 2048 x 2048;
    # layer 0's SwiGLU 3 x 2048 x 10944; 26 x (router 2048 x 64, 6 + 2 experts
    # of 3 x 2048 x 1408); the head 2048 x 102400
    attn = 6291456 + 1179648 + 2097152 + 4194304
    moe = 131072 + 8 * 3 * 2048 * 1408
    want = 27 * attn + 67239936 + 26 * moe + 209715200
    assert bounds_mla.active_matmul_params(c) == want == 2_451_308_544
    flops = bounds_mla.decode_step_flops(c, 2, [100, 300])
    assert flops == 2.0 * want * 2 + 27 * 2 * 16 * 320 * 400
    # batch 2 over 100 + 300 positions of a 16-block table: 400 rows of
    # 1152 B, q 2 x 16 x 576 and out 2 x 16 x 512 bf16, the table and lengths
    nbytes = 400 * 1152 + 2 * 16 * 1088 * 2 + 2 * 16 * 4 + 2 * 4
    assert nbytes == 530568
    assert bounds_mla.paged_mla_s(c, 2, [100, 300], 16) == nbytes / 3.35e12
    assert 2 * 400 * 16 * 1088 / 989e12 < nbytes / 3.35e12


def test_the_reference_copy_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "taiji_bench" / "reference" / "deepseek_v2.py").read_text())
    mods = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    mods += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert not [m for m in mods if m and m.split(".")[0] in ("repro_torch", "repro", "jax")]


def test_the_reference_agrees_with_the_programs_decode_and_the_control_runs():
    """float32 weights: the program's token-by-token decode through its
    latent pool and the plain forward give the same logits; the float8
    control's forward runs and picks tokens whose float32 logits lie
    below the best."""
    from repro_torch.models import model as M
    from repro_torch.train.steps import serve_step
    config = tiny_dsv2("float32")
    cfg = mla_decode.arch_config(config)
    w = mla_decode.make_weights(config, 7, "cpu")
    model = mla_decode.program_model(cfg, w)
    cache = M.init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, config["vocab_size"], (2, 20),
                         generator=torch.Generator().manual_seed(3))
    got = []
    for t in range(20):
        logits, cache = serve_step(model, toks[:, t], cache, cfg)
        got.append(logits)
    got = torch.stack(got, 1)
    ref = deepseek_v2.Forward(config, w.__getitem__)
    hs = ref.hidden([toks[0], toks[1]])
    for b in range(2):
        want = ref.logits(hs[b])
        assert torch.allclose(got[b], want, atol=1e-4, rtol=1e-4), (got[b] - want).abs().max()
    seqs = [toks[0], toks[1]]
    own = deepseek_v2.served_gaps(config, w.__getitem__, seqs, [1, 1])
    low = deepseek_v2.served_gaps(config, w.__getitem__, seqs, [1, 1], control=True)
    assert all(len(g) == 19 for g in own + low)
    assert max(float(g.max()) for g in low) > 0
