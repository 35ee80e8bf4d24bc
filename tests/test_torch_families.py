"""The port's SSM, hybrid, VLM and audio families (repro_torch.models.
{ssm,model,convert}, train.steps, launch.train) against the reference's
JAX functions, on the CPU at the reduced configs in f32.

Parameters are the reference's ``init_params`` (and its whole
``TrainState``), carried across with ``params_from_numpy`` /
``train_state_from_numpy``; inputs are made with numpy from seeds;
batches come from the reference's pipeline. Tolerances, each against the
largest magnitude of the reference's value unless it says relative:

* the scans (``selective_scan_chunked``, ``mamba_scan_fused``) and every
  gradient of the fused scan: 1e-5 (measured up to 4.5e-7, the gradient
  of A). The port's doubling scan combines the same pairs as
  ``lax.associative_scan`` in another order, so they agree to rounding,
  not bit for bit;
* ``mamba_block`` and ``mamba_decode_step`` (output and both states):
  1e-5 (measured up to 5e-7);
* ``loss_fn``: loss, ce and aux within relative 1e-5 (measured up to
  9e-8); every parameter's gradient within 1e-5 of its leaf's largest
  (measured up to 1.4e-6);
* three ``train_step``s: loss, ce, aux, grad_norm and lr within relative
  1e-5 (measured up to 2.3e-7); every parameter and both moments within
  1e-5 of their leaf's largest, or absolute 2e-5 below that
  (``tests/test_torch_train.py``'s limits: Adam divides by sqrt(nu), so
  a last-bit difference of a gradient near eps moves its update by up to
  lr; measured: moments 2.7e-6 of their largest, parameters 2.9e-6
  absolute, at qwen2-vl's K bias, whose gradient is zero but for
  rounding);
* ``prefill_step``: logits within 1e-4 (measured 6.1e-7);
* token-by-token ``decode_step`` against the reference's and against the
  port's own ``forward``: logits within 1e-4 at every step
  (``tests/test_torch_models.py``'s f32 decode tolerance; measured up to
  6.0e-7 and 3.8e-7), the conv and SSM states and the pool within 1e-5
  (measured up to 5.2e-7).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduce import reduced_config as ref_reduced  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSsm  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.configs.reduce import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSsm  # noqa: E402
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

FAMILIES = ["falcon-mamba-7b", "jamba-1.5-large-398b", "qwen2-vl-2b",
            "hubert-xlarge"]
DECODERS = FAMILIES[:3]
# 2 x 40 tokens: the reduced mamba chunk is 16, so the last chunk is
# padded; the VLM batch carries its 8-token vision prefix
B, S = 2, 40


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


def _rel(got, want, tol, what):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), f"{what}: {got} vs {want}"


def _tree(t):
    return jax.tree.map(np.asarray, t)


# ------------------------------------------------------------------- scan
@pytest.mark.parametrize("S_, chunk", [(37, 16), (16, 16), (5, 16)])
def test_scans_and_their_gradients_match_reference(S_, chunk):
    """A length that is not a multiple of the chunk (a padded last
    chunk), exactly one chunk, and one shorter than the chunk."""
    rng = np.random.default_rng(S_)
    Bc, DI, DS = 2, 6, 4
    a = rng.uniform(0.5, 1.0, (Bc, S_, DI, DS)).astype(np.float32)
    b = rng.standard_normal((Bc, S_, DI, DS)).astype(np.float32)
    h0 = rng.standard_normal((Bc, DI, DS)).astype(np.float32)
    jh, jf = JSsm.selective_scan_chunked(*map(jnp.asarray, (a, b, h0)), chunk)
    th, tf = TSsm.selective_scan_chunked(*map(_t, (a, b, h0)), chunk)
    _close(th, jh, 1e-5, "selective_scan_chunked states")
    _close(tf, jf, 1e-5, "selective_scan_chunked final state")

    args = (rng.standard_normal((Bc, S_, DI)),              # xc
            rng.uniform(0.01, 0.5, (Bc, S_, DI)),           # dt
            rng.standard_normal((Bc, S_, DS)),              # B
            rng.standard_normal((Bc, S_, DS)),              # C
            -np.tile(np.arange(1, DS + 1)[None], (DI, 1)),  # A
            rng.standard_normal(DI))                        # D
    args = [x.astype(np.float32) for x in args]
    w = rng.standard_normal((Bc, S_, DI)).astype(np.float32)
    f = jax.jit(lambda *x: JSsm.mamba_scan_fused(*x, chunk))
    jy = f(*map(jnp.asarray, args))
    jg = jax.grad(lambda *x: jnp.sum(f(*x) * w),
                  argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [_t(x).requires_grad_() for x in args]
    ty = TSsm.mamba_scan_fused(*targs, chunk)
    _close(ty, jy, 1e-5, "mamba_scan_fused")
    (ty * _t(w)).sum().backward()
    for name, t, g in zip(("xc", "dt", "B", "C", "A", "D"), targs, jg):
        _close(t.grad, g, 1e-5, f"mamba_scan_fused grad {name}")
    with torch.no_grad():                     # the unrematerialised path
        _close(TSsm.mamba_scan_fused(*map(_t, args), chunk), jy, 1e-5,
               "mamba_scan_fused without autograd")


def test_mamba_block_and_decode_step_match_reference():
    """``mamba_block`` over 37 positions, then 5 ``mamba_decode_step``s
    from a non-zero state, on the reduced falcon-mamba's first layer."""
    jcfg, tcfg = ref_reduced("falcon-mamba-7b"), reduced_config("falcon-mamba-7b")
    params = JM.init_params(jax.random.PRNGKey(2), jcfg)
    lp = jax.tree.map(lambda w: w[0], params["layers"]["mamba"])
    model = params_from_numpy(_tree(params), tcfg, "cpu")
    tp = {n: p.detach() for n, p in model.layers[0].mamba.named_parameters()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 37, tcfg.d_model)).astype(np.float32)
    _close(TSsm.mamba_block(_t(x), tp, tcfg),
           JSsm.mamba_block(jnp.asarray(x), lp, jcfg), 1e-5, "mamba_block")
    mc = tcfg.mamba
    conv = rng.standard_normal((B, mc.d_conv - 1, tcfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((B, tcfg.d_inner, mc.d_state)).astype(np.float32)
    jconv, jssm, tconv, tssm = conv, ssm, _t(conv), _t(ssm)
    step = jax.jit(JSsm.mamba_decode_step, static_argnums=(2,))
    for t in range(5):
        jo, jconv, jssm = step(jnp.asarray(x[:, t]), lp, jcfg, jconv, jssm)
        to, tconv, tssm = TSsm.mamba_decode_step(_t(x[:, t]), tp, tcfg, tconv, tssm)
        _close(to, jo, 1e-5, f"decode step {t} output")
        _close(tconv, jconv, 1e-5, f"decode step {t} conv state")
        _close(tssm, jssm, 1e-5, f"decode step {t} ssm state")


# ------------------------------------------------------- loss and training
@functools.lru_cache(maxsize=None)
def _ref_train_step(arch):
    cfg = ref_reduced(arch)
    opt = JA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    return cfg, opt, jax.jit(functools.partial(JS.train_step, cfg=cfg, opt_cfg=opt))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_grads_train_steps_and_prefill_match_reference(arch):
    jcfg, jopt, jstep = _ref_train_step(arch)
    tcfg = reduced_config(arch)
    topt = TA.AdamWConfig(**dataclasses.asdict(jopt))
    state = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    port = train_state_from_numpy(_tree(state.params), _tree(state.opt.mu),
                                  _tree(state.opt.nu), int(state.step),
                                  tcfg, topt, "cpu")
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
    if arch == "jamba-1.5-large-398b":
        assert float(jm["aux"]) > 0
    want = params_from_numpy(_tree(jg), tcfg, "cpu")
    for (name, p), (_, g) in zip(port.model.named_parameters(),
                                 want.named_parameters()):
        if p.grad is None:      # the audio family's embed: the loss misses it
            assert name == "embed" and arch == "hubert-xlarge", name
            assert not g.detach().any()
            continue
        _close(p.grad, g.detach().numpy(), 1e-5, f"grad {name}")

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
        want = params_from_numpy(_tree(want), tcfg, "cpu")
        got = list(got.parameters()) if name == "params" else got
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
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_reference_and_forward(arch):
    """Token by token through ``serve_step`` against the reference's
    ``decode_step`` and against the port's own ``forward`` over the same
    tokens (for qwen2-vl with its vision prefix fed as ``input_embeds``
    and ``mrope_pos`` at every step); the conv and SSM states carried in
    place equal the reference's returned ones."""
    jcfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_numpy(_tree(params), tcfg, "cpu")
    steps = 20                                # past one 16-position chunk
    batch = RefPipeline(jcfg, B, steps, seed=5).next_batch()
    tb = TS.to_device(batch, "cpu")
    hidden, _ = TM.forward(model, tcfg, tb, remat=False)
    fwd = TM.logits_from_hidden(model, tcfg, hidden)
    jc = JM.init_cache(jcfg, B, 32, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, 32, dtype=torch.float32, device="cpu")
    assert sorted(tc) == sorted(jc)
    jdec = jax.jit(JM.decode_step, static_argnums=(1,))
    nv = jcfg.max_vision_tokens
    ops.reset_launches()
    for t in range(steps):
        mp = ie = None
        if arch == "qwen2-vl-2b":
            mp = batch["mrope_pos"][:, :, t:t + 1]
            ie = batch["vision_embeds"][:, t] if t < nv else None
        jl, jc = jdec(params, jcfg, jnp.asarray(batch["tokens"][:, t]), jc,
                      None if mp is None else jnp.asarray(mp),
                      None if ie is None else jnp.asarray(ie))
        tl, tc = TS.serve_step(model, tb["tokens"][:, t], tc, tcfg,
                               None if mp is None else _t(mp),
                               None if ie is None else _t(ie))
        assert not tl.requires_grad
        _close(tl, jl, 1e-4, f"decode step {t}")
        _close(tl, fwd[:, t].detach().numpy(), 1e-4, f"decode vs forward {t}")
    for k in ("conv_state", "ssm_state", "kv_pool"):
        if k in jc:
            _close(tc[k], jc[k], 1e-5, k)
    assert tc["kv_len"].tolist() == [steps] * B
    assert "paged_attn" not in ops.launches     # the CPU runs the plain version


def test_run_training_takes_every_family(capsys):
    """``run_training`` (what ``--arch ... --reduced --device cpu`` runs)
    for each of the four families: finite losses, two steps taken."""
    from repro_torch.launch.train import run_training

    for arch in FAMILIES:
        cfg = reduced_config(arch)
        out = run_training(cfg, steps=2, batch=2, seq=24, lr=1e-3,
                           ckpt_dir=None, ckpt_every=50, seed=0, log_every=1,
                           device="cpu")
        assert len(out["loss"]) == 2 and np.isfinite(out["loss"]).all(), arch
        assert out["state"].step == 2
    assert capsys.readouterr().out.count("training done") == len(FAMILIES)


def test_serving_an_attention_free_config_fails_in_both_packages():
    """The reference's fault, kept (ROADMAP.md, Queue C): ``run_serving``
    sizes its elastic KV cache from ``attn_layer_count``, which is
    0 for falcon-mamba, and the zero-byte KV block divides by zero while
    the Taiji config is built, in both packages."""
    from repro.launch.serve import run_serving as ref_serving
    from repro_torch.launch.serve import run_serving

    kw = dict(n_seqs=2, phys_blocks=4, turns=1, batch=1, prompt_len=4,
              gen_len=2, verbose=False)
    with pytest.raises(ZeroDivisionError):
        ref_serving(ref_reduced("falcon-mamba-7b"), **kw)
    with pytest.raises(ZeroDivisionError):
        run_serving(reduced_config("falcon-mamba-7b"), device="cpu", **kw)
