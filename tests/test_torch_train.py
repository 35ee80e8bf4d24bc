"""The port's training and prefill stack (repro_torch.models.{layers,moe,
model,convert}, optim.adamw, train.steps, data.pipeline,
checkpoint.manager, launch.train and the two training examples) against
the reference's JAX functions, on the CPU.

Parameters are the reference's ``init_params`` (and its whole
``TrainState``), carried across with ``params_from_numpy`` /
``train_state_from_numpy``; inputs are made with numpy from seeds;
batches come from the reference's pipeline. Everything runs in f32 at the
reduced configs. Tolerances:

* chunked attention: outputs within 1e-5 absolute and the gradients of
  q, k and v within 1e-5 of the largest (measured up to 7e-7); in bf16,
  every case's output within 2e-2 of the largest -- one bf16 rounding of
  the scores, probabilities and output where a last f32 bit differs --
  and its gradients within 1e-2 of each one's largest against the
  reference's bf16 gradients (``BF16_GRAD_TOL``);
* ``moe_ffn``: routing indices and capacity drops equal, outputs within
  1e-5, the auxiliary loss within relative 1e-5, gradients within 1e-5
  of each leaf's largest;
* ``loss_fn``: loss, ce and aux within relative 1e-5; every parameter's
  gradient within 1e-5 of its leaf's largest (measured up to 9e-7); with
  bf16 compute, the loss within relative 1e-4 and every gradient within
  1e-1 of its leaf's largest (``BF16_LEAF_GRAD_TOL``);
* three ``train_step``s: loss, grad_norm and lr within relative 1e-5 at
  every step; every parameter and both moments within 1e-5 of their
  leaf's largest (Adam's update divides by sqrt(nu): a last-bit
  difference of a gradient near eps moves its update by up to lr, so
  absolute 2e-5 below that);
* ``prefill_step`` and the MoE ``decode_step``: logits within relative
  1e-4 (``tests/test_torch_models.py``'s f32 decode tolerance);
* the pipeline: batches byte-equal for every family;
* checkpoint round trip: every tensor bit-equal; a resumed run's losses
  equal to the uninterrupted run's (the CPU is deterministic).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RCfg  # noqa: E402
from repro.configs.reduce import reduced_config as ref_reduced  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.reduce import reduced_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

TRAIN_ARCHS = ["qwen3-4b", "deepseek-moe-16b"]
# bf16 chunked attention's gradients against the reference's bf16
# gradients: within 1e-2 of each one's largest -- a bf16 rounding of the
# largest is 2**-8 = 3.9e-3, and a last f32 bit apart before a cast moves
# a value by one; measured up to 6.3e-3 (the bf16 gradients stand 5e-3 to
# 1.2e-2 from the f32 ones, in both packages alike)
BF16_GRAD_TOL = 1e-2
# ``loss_fn`` with bf16 compute against the reference's: the loss within
# relative 1e-4 (measured up to 2.7e-5), every parameter's gradient
# within 1e-1 of its leaf's largest (measured up to 1.3e-2 for reduced
# qwen3-4b and 7.1e-2 for the routed experts of reduced deepseek-moe-16b:
# an expert's gradient is a sum over its slots that cancels, and the two
# packages round the bf16 terms at different points)
BF16_LOSS_TOL, BF16_LEAF_GRAD_TOL = 1e-4, 1e-1
# batch 2 x 70 tokens: several (32, 64) attention tiles, padded in both
# directions, causal
B, S = 2, 70


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


def _rel(got, want, tol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), f"{what}: {got} vs {want}"


def _grads_close(model, grad_tree, cfg, tol):
    want = params_from_numpy(jax.tree.map(np.asarray, grad_tree), cfg, "cpu")
    for (name, p), (_, g) in zip(model.named_parameters(), want.named_parameters()):
        assert p.grad is not None, name
        _close(p.grad, g.detach().numpy(), tol, f"grad {name}")


# ------------------------------------------------------------ attention
def test_chunked_attention_and_grads_match_reference():
    rng = np.random.default_rng(0)
    cases = [  # B, Sq, Skv, Hq, Hkv, hd, causal, cq, ckv, q_offset
        (2, 45, 45, 4, 2, 16, True, 16, 32, 0),     # GQA, ragged, causal
        (2, 40, 70, 4, 4, 16, False, 16, 32, 0),    # MHA, Sq != Skv
        (1, 20, 50, 4, 1, 16, True, 8, 16, 30),     # MQA, q_offset
    ]
    for Bc, Sq, Skv, Hq, Hkv, hd, causal, cq, ckv, off in cases:
        q = rng.standard_normal((Bc, Sq, Hq, hd)).astype(np.float32)
        k, v = (rng.standard_normal((Bc, Skv, Hkv, hd)).astype(np.float32)
                for _ in range(2))
        w = rng.standard_normal((Bc, Sq, Hq, hd)).astype(np.float32)
        kw = dict(causal=causal, chunk_q=cq, chunk_kv=ckv, q_offset=off)

        f = jax.jit(functools.partial(JL.chunked_attention, **kw))
        jo = f(*map(jnp.asarray, (q, k, v)))
        jg = jax.jit(jax.grad(lambda q, k, v, w=w, f=f: jnp.sum(f(q, k, v) * w),
                              argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        to = TL.chunked_attention(tq, tk, tv, **kw)
        assert to.shape == (Bc, Sq, Hq, hd)
        np.testing.assert_allclose(to.detach().numpy(), _np(jo), atol=1e-5)
        (to * _t(w)).sum().backward()
        for name, t, g in zip("qkv", (tq, tk, tv), jg):
            _close(t.grad, g, 1e-5, f"d{name} {Sq}x{Skv} causal={causal}")
        # bf16: the reference's dtype points (q*scale, p rounded to v's
        # dtype), forward and backward
        jb = f(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        jgb = jax.jit(jax.grad(
            lambda q, k, v, f=f: jnp.sum(f(q, k, v).astype(jnp.float32) * w),
            argnums=(0, 1, 2)))(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        tqb, tkb, tvb = (_t(a).bfloat16().requires_grad_() for a in (q, k, v))
        tb = TL.chunked_attention(tqb, tkb, tvb, **kw)
        assert tb.dtype == torch.bfloat16
        _close(tb, jb, 2e-2, f"bf16 {Sq}x{Skv}")
        (tb.float() * _t(w)).sum().backward()
        for name, t, g in zip("qkv", (tqb, tkb, tvb), jgb):
            assert t.grad.dtype == torch.bfloat16
            _close(t.grad, g, BF16_GRAD_TOL, f"bf16 d{name} {Sq}x{Skv}")


# ------------------------------------------------------------------- moe
def test_moe_ffn_matches_reference_in_both_dispatch_modes():
    """Global and grouped dispatch; a router with two equal columns (ties
    in every token's top-k) and one biased to overflow an expert (drops)."""
    base = ref_reduced("deepseek-moe-16b")
    rng = np.random.default_rng(1)
    D, m = base.d_model, base.moe
    p = {"router": rng.standard_normal((D, m.n_routed)) * 0.02,
         "w_gate": rng.standard_normal((m.n_routed, D, m.d_ff_expert)) * 0.02,
         "w_up": rng.standard_normal((m.n_routed, D, m.d_ff_expert)) * 0.02,
         "w_down": rng.standard_normal((m.n_routed, m.d_ff_expert, D)) * 0.02}
    Fs = m.n_shared * m.d_ff_expert
    p.update(shared_gate=rng.standard_normal((D, Fs)) * 0.02,
             shared_up=rng.standard_normal((D, Fs)) * 0.02,
             shared_down=rng.standard_normal((Fs, D)) * 0.02)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    tied = dict(p, router=p["router"].copy())
    tied["router"][:, 5] = tied["router"][:, 2]
    skew = dict(p, router=p["router"].copy())
    skew["router"][:, 3] += 0.02                # expert 3 gets every token
    cases = [("global", p, False, 2, 40), ("grouped", p, True, 3, 32),
             ("ties", tied, False, 2, 40), ("drops", skew, False, 4, 64)]
    for name, params, grouped, Bc, Sc in cases:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            m, grouped_dispatch=grouped, min_group_tokens=16))
        tcfg = dataclasses.replace(reduced_config("deepseek-moe-16b"),
                                   moe=cfg.moe)
        x = (rng.standard_normal((Bc, Sc, D)) + 1.0).astype(np.float32)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: _t(v).requires_grad_() for k, v in params.items()}
        xt = x.reshape(-1, D)
        _, jidx, _ = JMoE.router_topk(jnp.asarray(xt), jp["router"], m.top_k)
        _, tidx, _ = TMoE.router_topk(_t(xt), tp["router"], m.top_k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx), name)
        if name == "drops":
            counts = np.bincount(np.asarray(jidx).reshape(-1), minlength=m.n_routed)
            assert counts.max() > TMoE.capacity(Bc * Sc, m)
        w = rng.standard_normal(x.shape).astype(np.float32)

        def ref(q, x=x, w=w, cfg=cfg):
            out, aux = JMoE.moe_ffn(jnp.asarray(x), q, cfg)
            return jnp.sum(out * w) + aux, (out, aux)

        jg, (jo, ja) = jax.jit(jax.grad(ref, has_aux=True))(jp)
        to, ta = TMoE.moe_ffn(_t(x), tp, tcfg)
        np.testing.assert_allclose(to.detach().numpy(), _np(jo), atol=1e-5,
                                   err_msg=name)
        _rel(ta.detach(), ja, 1e-5, f"{name} aux")
        (torch.sum(to * _t(w)) + ta).backward()
        for k in params:
            _close(tp[k].grad, jg[k], 1e-5, f"{name} grad {k}")


# ------------------------------------------------------- loss and training
@functools.lru_cache(maxsize=None)
def _ref_train_step(arch):
    cfg = ref_reduced(arch)
    opt = JA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    return cfg, opt, jax.jit(functools.partial(JS.train_step, cfg=cfg, opt_cfg=opt))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_grads_train_steps_and_prefill_match_reference(arch):
    jcfg, jopt, jstep = _ref_train_step(arch)
    tcfg = reduced_config(arch)
    topt = TA.AdamWConfig(**dataclasses.asdict(jopt))
    state = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port = train_state_from_numpy(tree(state.params), tree(state.opt.mu),
                                  tree(state.opt.nu), int(state.step),
                                  tcfg, topt, "cpu")
    assert all(p.requires_grad for p in port.model.parameters())
    if arch == "deepseek-moe-16b":
        assert port.model.layer0 is not None and hasattr(port.model.layer0, "mlp")
        assert all(hasattr(layer, "moe") for layer in port.model.layers)
    pipe = RefPipeline(jcfg, B, S, seed=3)
    batches = [pipe.next_batch() for _ in range(3)]

    # the loss and every parameter's gradient at the carried parameters
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb), has_aux=True))(state.params)
    tl, tm = TM.loss_fn(port.model, tcfg, TS.to_device(batches[0], "cpu"))
    tl.backward()
    _rel(tl.detach(), jl, 1e-5, "loss")
    _rel(tm["ce"], jm["ce"], 1e-5, "ce")
    _rel(tm["aux"], jm["aux"], 1e-5, "aux")
    if arch == "deepseek-moe-16b":
        assert float(jm["aux"]) > 0
    _grads_close(port.model, jg, tcfg, 1e-5)

    # the routing of the first MoE layer's dispatch: the same experts
    if arch == "deepseek-moe-16b":
        x = batches[0]["tokens"].reshape(-1)
        router = np.asarray(state.params["layers"]["moe"]["router"][0])
        emb = np.asarray(state.params["embed"])[x]
        _, ji, _ = JMoE.router_topk(jnp.asarray(emb), jnp.asarray(router),
                                    jcfg.moe.top_k)
        _, ti, _ = TMoE.router_topk(_t(emb), _t(router), tcfg.moe.top_k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    # the same loss and gradients with bf16 compute (phase 13 (b)'s and
    # (d)'s dtype points; f32 parameters)
    jcfg16 = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg16 = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg16, jb), has_aux=True))(state.params)
    model16 = params_from_numpy(tree(state.params), tcfg16, "cpu")
    for p in model16.parameters():
        p.requires_grad_()
    tl, _ = TM.loss_fn(model16, tcfg16, TS.to_device(batches[0], "cpu"))
    tl.backward()
    _rel(tl.detach(), jl, BF16_LOSS_TOL, "bf16 loss")
    _grads_close(model16, jg, tcfg16, BF16_LEAF_GRAD_TOL)

    # three train steps from the same state on the same batches
    for i, b in enumerate(batches):
        state, jmet = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        port, tmet = TS.train_step(port, TS.to_device(b, "cpu"), tcfg, topt)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            _rel(tmet[k], jmet[k], 1e-5, f"step {i + 1} {k}")
    assert port.step == int(state.step) == 3
    for name, got, want in (("params", port.model, state.params),
                            ("mu", port.opt.mu, state.opt.mu),
                            ("nu", port.opt.nu, state.opt.nu)):
        want = params_from_numpy(tree(want), tcfg, "cpu")
        got = (list(got.parameters()) if name == "params" else got)
        for (n, w), g in zip(want.named_parameters(), got):
            w = w.detach()
            err = float((g.detach() - w).abs().max())
            assert err <= max(1e-5 * float(w.abs().max()), 2e-5), f"{name} {n}: {err}"

    # prefill on the trained parameters
    jlog, jaux = jax.jit(functools.partial(JS.prefill_step, cfg=jcfg))(
        state.params, {k: jnp.asarray(v) for k, v in batches[0].items()})
    tlog, taux = TS.prefill_step(port.model, TS.to_device(batches[0], "cpu"), tcfg)
    assert tlog.shape == (B, tcfg.vocab) and not tlog.requires_grad
    _close(tlog, jlog, 1e-4, "prefill logits")
    _rel(taux, jaux, 1e-4, "prefill aux")


# ---------------------------------------------------------------- decode
def test_moe_decode_matches_reference_and_prefill():
    """deepseek-moe (dense layer0 on the pool's first layer, MoE after):
    12 decode steps against the reference's decode_step, and the last
    step's logits against the port's prefill of the same tokens."""
    jcfg, tcfg = ref_reduced("deepseek-moe-16b"), reduced_config("deepseek-moe-16b")
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    steps = 12
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    jc = JM.init_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    jdec = jax.jit(JM.decode_step, static_argnums=(1,))
    ops.reset_launches()
    for t in range(steps):
        jl, jc = jdec(params, jcfg, jnp.asarray(toks[:, t]), jc)
        tl, tc = TS.serve_step(model, _t(toks[:, t]), tc, tcfg)
        assert not tl.requires_grad
        _close(tl, jl, 1e-4, f"decode step {t}")
    np.testing.assert_allclose(tc["kv_pool"].numpy(), _np(jc["kv_pool"]),
                               rtol=1e-5, atol=1e-6)
    assert "paged_attn" not in ops.launches        # the CPU runs the plain version
    pl, _ = TS.prefill_step(model, {"tokens": _t(toks)}, tcfg)
    _close(tl, pl.numpy(), 1e-4, "decode vs prefill")


# -------------------------------------------------------------- pipeline
def test_pipeline_batches_are_the_references():
    for arch in RCfg.ARCH_IDS:
        jcfg, tcfg = ref_reduced(arch), reduced_config(arch)
        ref = RefPipeline(jcfg, 3, 24, seed=7)
        port = SyntheticPipeline(tcfg, 3, 24, seed=7)
        for _ in range(3):
            a, b = ref.next_batch(), port.next_batch()
            assert sorted(a) == sorted(b), arch
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (arch, k)
        assert port.snapshot() == ref.snapshot() == {"seed": 7, "step": 3}
        port.restore({"seed": 7, "step": 1})
        ref.restore({"seed": 7, "step": 1})
        assert port.next_batch()["labels"].tobytes() == \
            ref.next_batch()["labels"].tobytes()


# ------------------------------------------------------------ checkpoint
def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save at step 2 of 4, restore into a fresh state and pipeline: every
    tensor and the cursor equal, the resumed losses the uninterrupted
    run's. bf16 moments go through their bits; a foreign ABI or layout
    raises; three checkpoints are kept."""
    cfg = dataclasses.replace(reduced_config("qwen3-4b"), opt_dtype="bfloat16")
    opt = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                         state_dtype=cfg.opt_dtype)

    def fresh():
        return (TS.init_train_state(cfg, opt, seed=5, device="cpu"),
                SyntheticPipeline(cfg, 2, 40, seed=5))

    state, pipe = fresh()
    assert state.opt.mu[0].dtype == torch.bfloat16
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=3)
    losses = []
    for i in range(4):
        state, met = TS.train_step(state, TS.to_device(pipe.next_batch(), "cpu"),
                                   cfg, opt)
        losses.append(float(met["loss"]))
        if i == 1:
            ckpt.save(2, state, pipe.snapshot())
            saved = [t.detach().clone() for t in
                     [*state.model.parameters(), *state.opt.mu, *state.opt.nu]]
            cursor = pipe.snapshot()
    assert ckpt.latest_step() == 2

    state2, pipe2 = fresh()
    state2, manifest = ckpt.restore(state2)
    pipe2.restore(manifest["pipeline"])
    assert state2.step == 2 and pipe2.snapshot() == cursor
    assert manifest["dtypes"]["opt/mu/embed"] == "bfloat16"
    restored = [*state2.model.parameters(), *state2.opt.mu, *state2.opt.nu]
    assert len(restored) == len(saved)
    assert all(a.dtype == b.dtype and torch.equal(a.detach(), b)
               for a, b in zip(restored, saved))
    resumed = []
    for _ in range(2):
        state2, met = TS.train_step(state2, TS.to_device(pipe2.next_batch(), "cpu"),
                                    cfg, opt)
        resumed.append(float(met["loss"]))
    assert resumed == losses[2:]
    assert state2.step == 4

    for step in (3, 4, 5):
        ckpt.save(step, state2, pipe2.snapshot())
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_0000000003", "step_0000000004", "step_0000000005"]
    man = tmp_path / "ck" / "step_0000000005" / "manifest.json"
    man.write_text(man.read_text().replace('"abi_version": 1', '"abi_version": 99'))
    with pytest.raises(ValueError, match="ABI"):
        ckpt.restore(fresh()[0])
    other = dataclasses.replace(cfg, n_layers=2)
    with pytest.raises(ValueError, match="layout"):
        ckpt.restore(TS.init_train_state(other, opt, seed=0, device="cpu"), step=4)


# --------------------------------------------------------------- drivers
def test_training_drivers_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``run_training`` with a checkpoint and a resume, the quickstart and
    the elastic MoE example at small sizes; without a card every entry
    point refuses unless asked for the CPU."""
    from repro_torch.examples import elastic_moe_training, quickstart
    from repro_torch.launch.train import run_training

    cfg = reduced_config("deepseek-moe-16b")
    kw = dict(batch=2, seq=32, lr=1e-3, ckpt_dir=str(tmp_path / "run"),
              ckpt_every=2, seed=0, log_every=1, device="cpu")
    first = run_training(cfg, steps=3, **kw)
    assert first["start_step"] == 0 and len(first["loss"]) == 3
    assert all(np.isfinite(first["loss"] + first["grad_norm"]))
    more = run_training(cfg, steps=5, **kw)
    assert more["start_step"] == 3 and len(more["loss"]) == 2
    assert more["state"].step == 5 and more["pipeline"].snapshot()["step"] == 5
    # the reference's fault, kept (ROADMAP.md, Queue C): when the last step
    # is a multiple of --ckpt-every, the final save finds that step's
    # checkpoint in place and the atomic rename fails
    with pytest.raises(OSError):
        run_training(cfg, steps=6, **kw)
    from repro.checkpoint.manager import CheckpointManager as RefManager
    ref = RefManager(str(tmp_path / "ref"))
    ref.save(2, {"w": np.zeros(3, np.float32)})
    with pytest.raises(OSError):
        ref.save(2, {"w": np.zeros(3, np.float32)})

    quickstart.main(["--tiny", "--steps", "3", "--batch", "2", "--seq", "32",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path / "qs")])
    quickstart.main(["--tiny", "--steps", "4", "--batch", "2", "--seq", "32",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path / "qs")])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done; loss" in out

    res = elastic_moe_training.run(cfg, steps=2, device="cpu", log_every=2)
    assert res["verified"] == cfg.moe.n_routed and res["ms_swapped_out"] > 0
    assert res["crc_failures"] == 0 and all(np.isfinite(res["loss"]))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg, steps=1, **dict(kw, device=None, ckpt_dir=None))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.init_train_state(cfg, TA.AdamWConfig(), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic_moe_training.run(cfg, steps=1)
