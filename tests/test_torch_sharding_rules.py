"""The port's sharding rules (repro_torch.launch.{mesh,sharding,specs},
repro_torch.shard_ctx) against the reference's, on device-free meshes.

The reference's eight tests (tests/test_sharding_rules.py) on the port,
then parity: for every parameter of all ten archs on 16 x 16 and on 2 x
16 x 16 with ``pod_axis="pod"``, the port's spec equals the reference's
``PartitionSpec`` with its stacked leading entries (layers, hybrid
groups; always unsharded) dropped; the batch and cache specs of every
runnable cell and the ``make_axis_ctx`` flags equal the reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import sharding as RS  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import shard_ctx  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, runnable_cells  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.sharding import (ShardingRules, abstract_mesh,  # noqa: E402
                                         local_shape, placements)
from repro_torch.models import model as M  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model"), None),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), "pod")}


def mesh16x16():
    return abstract_mesh((16, 16), ("data", "model"))


def mesh_pod():
    return abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def params_of(cfg):
    return M.Model(cfg, M.DTYPES[cfg.param_dtype], SP.META).named_parameters()


def spec_at(specs, path):
    """The spec of the parameter whose name's non-digit parts are ``path``
    (every layer's the same; the first)."""
    for name, spec in specs.items():
        if [k for k in name.split(".") if not k.isdigit()] == path.split("."):
            return spec
    raise KeyError(path)


# --------------------------------------------- the reference's eight tests
def test_gqa_heads_sharded_when_divisible():
    cfg = get_config("qwen3-4b")                 # 32 heads, kv 8
    specs = ShardingRules(cfg, mesh16x16()).param_pspecs(params_of(cfg))
    assert spec_at(specs, "layers.attn.wq") == ("data", "model")
    # kv heads 8 < 16: kv projections stay unsharded on model
    assert spec_at(specs, "layers.attn.wk") == ("data", None)


def test_nondivisible_heads_left_unsharded():
    cfg = get_config("qwen2-0.5b")               # 14 heads
    specs = ShardingRules(cfg, mesh16x16()).param_pspecs(params_of(cfg))
    assert spec_at(specs, "layers.attn.wq") == ("data", None)
    # but the MLP hidden (4864 = 16*304) is TP-sharded
    assert spec_at(specs, "layers.mlp.w_gate") == ("data", "model")


def test_moe_experts_sharded_over_model():
    cfg = get_config("qwen3-moe-235b-a22b")      # 128 experts
    specs = ShardingRules(cfg, mesh16x16()).param_pspecs(params_of(cfg))
    assert spec_at(specs, "layers.moe.w_gate")[0] == "model"
    assert spec_at(specs, "layers.moe.w_down")[0] == "model"


def test_mamba_d_inner_sharded():
    cfg = get_config("falcon-mamba-7b")
    specs = ShardingRules(cfg, mesh16x16()).param_pspecs(params_of(cfg))
    assert spec_at(specs, "layers.mamba.in_proj") == ("data", "model")
    assert spec_at(specs, "layers.mamba.out_proj") == ("model", "data")


def test_batch_specs_fit_small_batches():
    cfg = get_config("jamba-1.5-large-398b")
    rules = ShardingRules(cfg, mesh_pod(), pod_axis="pod")
    # long_500k decode: B=1 cannot shard over (pod, data)
    specs = rules.batch_pspecs(SP.input_specs(cfg, SHAPES["long_500k"]))
    assert specs["tokens"] == (None,)
    # train batch 256 shards over (pod, data)
    specs = rules.batch_pspecs(SP.input_specs(cfg, SHAPES["train_4k"]))
    assert specs["tokens"][0] == ("pod", "data")


def test_cache_specs_shard_pool_blocks():
    cfg = get_config("qwen3-4b")
    rules = ShardingRules(cfg, mesh16x16())
    specs = rules.cache_pspecs(SP.cache_specs(cfg, 128, 32768), 128)
    assert specs["kv_pool"][1] == "data"
    assert specs["block_table"] == ("data", None)


def test_state_specs_cover_opt_state():
    cfg = get_config("qwen2-0.5b")
    rules = ShardingRules(cfg, mesh16x16())
    st = SP.state_specs(cfg)
    assert all(p.device.type == "meta" for p in st.model.parameters())
    sp = rules.state_pspecs(st)
    assert sp["step"] == ()
    assert sp["opt"]["mu"] == sp["params"] == sp["opt"]["nu"]
    assert len(sp["params"]) == len(st.opt.mu) == len(st.opt.nu)


def test_axis_ctx_flags():
    cfg = get_config("qwen2-0.5b")
    rules = ShardingRules(cfg, mesh16x16())
    ctx = rules.make_axis_ctx(batch=256)
    assert not ctx.heads_ok          # 14 heads
    assert ctx.vocab_ok              # 151936 % 16 == 0
    assert ctx.ffn_ok                # 4864 % 16 == 0
    ctx1 = rules.make_axis_ctx(batch=1)
    assert ctx1.batch is None        # B=1 unshardable


# ------------------------------------------------- parity with the reference
def _ref_rules(arch, mesh_key):
    sizes, names, pod = MESHES[mesh_key]
    return RS.ShardingRules(ref_config(arch), RS.abstract_mesh(sizes, names),
                            pod_axis=pod)


def _port_rules(arch, mesh_key):
    sizes, names, pod = MESHES[mesh_key]
    return ShardingRules(get_config(arch), abstract_mesh(sizes, names),
                         pod_axis=pod)


@pytest.mark.parametrize("mesh_key", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh_key):
    ref_specs = _ref_rules(arch, mesh_key).param_pspecs(
        RM.param_shapes(ref_config(arch)))
    flat = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}
    cfg = get_config(arch)
    got = _port_rules(arch, mesh_key).param_pspecs(params_of(cfg))
    seen = set()
    for name, p in params_of(cfg):
        path = ".".join(k for k in name.split(".") if not k.isdigit())
        ref = want[path]
        stacked = len(ref) - p.dim()
        assert stacked >= 0 and all(e is None for e in ref[:stacked]), (name, ref)
        assert got[name] == ref[stacked:], (name, got[name], ref)
        seen.add(path)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_key", MESHES)
def test_batch_cache_specs_and_axis_ctx_equal_the_references(mesh_key):
    for arch, shape_name in runnable_cells():
        shape = SHAPES[shape_name]
        ref, port = _ref_rules(arch, mesh_key), _port_rules(arch, mesh_key)
        rcfg, cfg = ref_config(arch), get_config(arch)
        rb = ref.batch_pspecs(RSP.input_specs(rcfg, shape))
        pb = port.batch_pspecs(SP.input_specs(cfg, shape))
        assert pb == {k: tuple(v) for k, v in rb.items()}, (arch, shape_name)
        if shape.kind == "decode":
            B, S = shape.global_batch, shape.seq_len
            rc = ref.cache_pspecs(RSP.cache_specs(rcfg, B, S), B)
            pc = port.cache_pspecs(SP.cache_specs(cfg, B, S), B)
            assert pc == {k: tuple(v) for k, v in rc.items()}, (arch, shape_name)
        got = dataclasses.asdict(port.make_axis_ctx(batch=shape.global_batch))
        want = dataclasses.asdict(ref.make_axis_ctx(batch=shape.global_batch))
        assert got == want, (arch, shape_name)


def test_meshes_placements_and_local_shards():
    single, pods = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert pods.shape == {"pod": 2, "data": 16, "model": 16} and pods.size == 512
    assert make_host_mesh().size == 1
    from torch.distributed.tensor import Replicate, Shard
    spec = (("pod", "data"), None, "model")
    assert placements(spec, pods) == [Shard(0), Shard(0), Shard(2)]
    assert placements((None, "data"), single) == [Shard(1), Replicate()]
    assert local_shape((256, 7, 64), spec, pods) == (8, 7, 4)


def test_shard_ctx_is_the_identity_on_one_device():
    x = torch.zeros(2, 3, 4)
    rules = ShardingRules(get_config("qwen3-4b"), mesh16x16())
    assert shard_ctx.current() is None
    with shard_ctx.use(rules.make_axis_ctx(batch=256)):
        assert shard_ctx.current().heads_ok
        for f in (shard_ctx.act, shard_ctx.heads, shard_ctx.logits,
                  shard_ctx.moe_dispatch, shard_ctx.mamba_inner,
                  shard_ctx.ffn_hidden):
            assert f(x) is x
    assert shard_ctx.current() is None
