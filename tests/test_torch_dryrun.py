"""The port's dry run on the meta device (repro_torch.launch.{specs,
op_count,dryrun}, repro_torch.benchmarks.roofline) and the three repairs
that make the model stack traceable there.

* ``init_params`` / ``init_train_state`` on meta give shapes and dtypes;
* the MoE load-balance loss counts routes with ``index_add_``: bit-equal
  to the ``bincount`` form, and within the MoE parity tests' relative
  1e-5 of the reference's;
* every arch's train, prefill and decode step traces on meta at full
  width (each at its first traced depth, batch 2 x 256); on meta the
  paged-attention wrapper counts the kernel's own bytes and FLOPs, those
  of its bound in ``chip_smoke.py``;
* two traced depths extrapolate to a third depth's direct trace exactly
  (FLOPs, bytes and every operator's calls);
* ``roofline_terms`` has the reference's keys; the roofline table reads
  the dry run's artifacts; a failed cell makes the CLI exit 1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as RHA  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeSpec, cell_skip_reason, get_config  # noqa: E402
from repro_torch.launch import dryrun, op_count  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

B, S = 2, 256
KINDS = ("train", "prefill", "decode")


def _at_depth(arch, depth):
    return dataclasses.replace(get_config(arch), n_layers=depth)


def test_init_train_state_on_meta():
    cfg = _at_depth("deepseek-moe-16b", 2)
    st = steps.init_train_state(cfg, adamw.AdamWConfig(), seed=0, device="meta")
    params = list(st.model.parameters())
    assert st.step == 0 and st.model.layer0 is not None
    for p, mu, nu in zip(params, st.opt.mu, st.opt.nu):
        assert p.device.type == mu.device.type == nu.device.type == "meta"
        assert p.shape == mu.shape == nu.shape and mu.dtype == torch.float32
    # param_count leaves out final_norm, as the reference's
    assert sum(p.numel() for p in params) == cfg.param_count() + cfg.d_model


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_aux_counts_routes_as_bincount_and_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    T, D, E, k = 96, 32, 8, 2
    x = rng.standard_normal((T, D), dtype=np.float32)
    w = rng.standard_normal((D, E), dtype=np.float32)
    x[1], x[2] = x[0], x[0]              # equal rows: equal routes
    _, idx, aux = TMoE.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), dim=-1)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
    assert torch.equal(aux, E * torch.sum(probs.mean(dim=0) * ce))
    _, _, jaux = JMoE.router_topk(jnp.asarray(x), jnp.asarray(w), k)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def _cells():
    for arch in ARCH_IDS:
        for kind in KINDS:
            if kind == "decode" and cell_skip_reason(arch, "decode_32k"):
                continue
            yield arch, kind


@pytest.mark.parametrize("arch,kind", list(_cells()))
def test_every_step_traces_on_meta(arch, kind):
    cfg = _at_depth(arch, dryrun.depths(get_config(arch))[0])
    shape = ShapeSpec(f"small_{kind}", S, B, kind)
    ops.reset_launches()
    cost, saved = dryrun._trace(cfg, shape)
    assert cost.flops > 0 and cost.hbm_bytes > 0
    assert (saved > 0) == (kind == "train")
    # the paged kernel's wrapper reports its cost on meta, and launches nothing
    assert "paged_attn" not in ops.launches
    assert ("paged_attn_kernel" in cost.by_op) == (kind == "decode"
                                                   and cfg.family != "ssm")


@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "train"),
                                       ("deepseek-moe-16b", "train"),
                                       ("jamba-1.5-large-398b", "decode")])
def test_two_depths_extrapolate_to_a_third(arch, kind):
    shape = ShapeSpec(f"small_{kind}", S, B, kind)
    d1, d2 = dryrun.depths(get_config(arch))
    d3 = 2 * d2 - d1
    c1, c2, c3 = (dryrun._trace(_at_depth(arch, d), shape)[0] for d in (d1, d2, d3))
    got = op_count.extrapolate(c1, d1, c2, d2, d3)
    assert got.flops == c3.flops and got.hbm_bytes == c3.hbm_bytes
    assert {k: v[0] for k, v in got.by_op.items() if v[0]} == \
        {k: v[0] for k, v in c3.by_op.items()}


def test_op_counter_counts_a_matmul_and_skips_views():
    a = torch.empty(64, 128, dtype=torch.bfloat16, device="meta")
    b = torch.empty(128, 32, dtype=torch.bfloat16, device="meta")
    _, cost = op_count.count(lambda: (a.t().contiguous().t() @ b).view(-1))
    assert cost.by_op["mm"] == [1, 2 * 64 * 128 * 32, 2 * (64 * 128 + 128 * 32 + 64 * 32)]
    assert set(cost.by_op) == {"mm", "clone"}


def test_paged_attention_on_meta_counts_the_kernels_bound_bytes():
    # qwen3-4b's heads; a table of 32 blocks of 16 per sequence
    Bq, H, KV, hd, bt, mbs = 4, 32, 8, 128, 16, 32
    bf16, i32 = torch.bfloat16, torch.int32
    q = torch.empty(Bq, H, hd, dtype=bf16, device="meta")
    pool = torch.empty(Bq * mbs, bt, 2, KV, hd, dtype=bf16, device="meta")
    table = torch.empty(Bq, mbs, dtype=i32, device="meta")
    kv_len = torch.empty(Bq, dtype=i32, device="meta")
    out, cost = op_count.count(ops.paged_decode_attention, q, pool, table, kv_len)
    assert out.shape == q.shape and out.dtype == q.dtype
    # chip_smoke.py's bound for the kernel's row, at every table entry used
    kv = mbs * bt
    kv_bytes = Bq * kv * 2 * KV * hd * 2
    io_bytes = 2 * q.numel() * 2 + table.numel() * 4 + Bq * 4
    assert cost.by_op == {"paged_attn_kernel": [1, 4 * Bq * H * kv * hd,
                                                kv_bytes + io_bytes]}
    assert not ops.meta_cost_sinks          # the counter took its sink out


def test_roofline_terms_have_the_references_keys():
    terms = op_count.roofline_terms(op_count.Cost(flops=989e12, hbm_bytes=6.7e12))
    assert set(terms) == set(RHA.roofline_terms(RHA.Cost()))
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(2.0)
    assert terms["collective_s"] == 0.0 and terms["dominant"] == "memory_s"


def test_roofline_reads_the_dry_runs_artifacts(tmp_path):
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", False,
                          print_analysis=False, art_dir=tmp_path)
    assert (tmp_path / "qwen2-0.5b__decode_32k__pod16x16.json").exists()
    cfg = get_config("qwen2-0.5b")     # 24 layers of 2 KV heads of 64, bf16
    pool = cfg.n_layers * 128 * 32768 * 2 * cfg.n_kv_heads * cfg.head_dim_ * 2
    table = 128 * (32768 // cfg.kv_block_tokens) * 4
    assert rec["memory_h100"]["cache"] == pool + table + 128 * 4
    table = roofline.run(verbose=True, art=tmp_path)
    assert [(r["arch"], r["shape"]) for r in table] == [("qwen2-0.5b", "decode_32k")]
    assert table[0]["useful_ratio"] > 0
    assert roofline.rows(tmp_path)[0][0] == "roofline_qwen2-0.5b_decode_32k"


def test_dryrun_cli_exits_1_on_a_failed_cell(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--multi-pod",
                     "--variant", "mesh32x8"])
    assert e.value.code == 1
    assert "FAIL qwen3-4b x train_4k" in capsys.readouterr().out
