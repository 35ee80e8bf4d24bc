"""The decode step as one CUDA graph (``repro_torch.models.model``).

On the CPU, on ``meta``, for a MoE, SSM or hybrid config and with
``input_embeds`` or ``mrope_pos`` the step runs its body eagerly and its
``decode_step`` span carries ``DECODE_EAGER``; which calls the graph
takes is :func:`graph_eligible`, checked here for every configuration.

The ``cuda`` tests hold the graph against the eager body on the card, bit
for bit (same kernels, same operands), also captured beside a live
manager's hv_sched threads, and check the key, the outputs' lifetime and
the launch counts. They need neither JAX nor the reference:
``python -m pytest -q -m cuda tests/test_torch_decode_graph.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduce import reduced_config  # noqa: E402
from repro_torch.core.metrics import Metrics  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.obs import render_prom  # noqa: E402
from repro_torch.obs.tracer import (DECODE_CAPTURE, DECODE_EAGER,  # noqa: E402
                                    DECODE_REPLAY, ST_DECODE_STEP, SpanTracer)
from repro_torch.train.steps import serve_step  # noqa: E402

B, S = 2, 16
CUDA = torch.device("cuda")      # a device name: nothing is allocated on it here


def _tags(tracer):
    """The ``decode_step`` spans' tags, in the order they were recorded."""
    return [tag for stage, _, _, tag, _ in tracer.spans()
            if stage == ST_DECODE_STEP]


# ------------------------------------------------------- which calls qualify
DENSE = ("qwen3-4b", "qwen2-0.5b", "qwen2.5-32b", "granite-20b", "qwen2-vl-2b")
EAGER_FAMILIES = ("deepseek-moe-16b", "qwen3-moe-235b-a22b",
                  "falcon-mamba-7b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch", DENSE + EAGER_FAMILIES)
def test_graph_eligible_on_the_card_for_dense_layers_only(arch):
    cfg = get_config(arch)
    cache = M.init_cache(reduced_config(arch), B, S, device="meta")
    assert M.graph_eligible(cfg, CUDA, cache) == (arch in DENSE)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_graph_eligible_never_off_the_card(arch, device):
    cache = M.init_cache(reduced_config(arch), B, S, device="meta")
    assert not M.graph_eligible(get_config(arch), torch.device(device), cache)


@pytest.mark.parametrize("extra", ["input_embeds", "mrope_pos"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-vl-2b"])
def test_graph_eligible_not_with_embeds_or_positions(arch, extra):
    cfg = reduced_config(arch)
    cache = M.init_cache(cfg, B, S, device="meta")
    arg = (torch.zeros(B, cfg.d_model) if extra == "input_embeds"
           else torch.zeros(3, B, 1, dtype=torch.long))
    assert not M.graph_eligible(cfg, CUDA, cache, **{extra: arg})


# ------------------------------------------------- eager off the card: tag 0
def _model(arch, device="cpu"):
    cfg = reduced_config(arch)
    return cfg, M.init_params(cfg, seed=0, device=device)


@pytest.mark.parametrize("arch", DENSE + EAGER_FAMILIES)
def test_cpu_step_is_eager_and_tagged_so(arch):
    cfg, model = _model(arch)
    cache = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    tr = SpanTracer()
    for t in range(3):
        _, cache = serve_step(model, torch.tensor([3, 5 + t]), cache, cfg,
                              tracer=tr)
    assert _tags(tr) == [DECODE_EAGER] * 3
    assert model.decode_graph is None
    assert cache["kv_len"].tolist() == [3, 3]


def test_meta_step_is_eager_and_tagged_so():
    cfg = get_config("qwen3-4b")
    model = M.init_params(cfg, seed=0, device="meta")
    cache = M.init_cache(cfg, 4, 128, device="meta")
    tr = SpanTracer()
    logits, cache = serve_step(model, torch.zeros(4, dtype=torch.long,
                                                  device="meta"),
                               cache, cfg, tracer=tr)
    assert logits.shape == (4, cfg.vocab) and logits.device.type == "meta"
    assert _tags(tr) == [DECODE_EAGER]
    assert model.decode_graph is None


@pytest.mark.parametrize("extra", ["input_embeds", "mrope_pos"])
def test_cpu_vision_prefix_step_is_eager_and_tagged_so(extra):
    cfg, model = _model("qwen2-vl-2b")
    cache = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    kw = ({"input_embeds": torch.randn(B, cfg.d_model)} if extra == "input_embeds"
          else {"mrope_pos": torch.zeros(3, B, 1, dtype=torch.long)})
    tr = SpanTracer()
    serve_step(model, torch.tensor([1, 2]), cache, cfg, tracer=tr, **kw)
    assert _tags(tr) == [DECODE_EAGER]


def test_decode_body_is_the_eager_step():
    cfg, model = _model("qwen3-4b")
    c1 = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    c2 = M.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    toks = torch.tensor([4, 9])
    for _ in range(2):
        l1, c1 = M.decode_step(model, cfg, toks, c1)
        with torch.no_grad():
            l2, kv_len = M.decode_body(model, cfg, toks, c2)
        c2 = dict(c2, kv_len=kv_len)
        assert torch.equal(l1, l2)
    assert torch.equal(c1["kv_pool"], c2["kv_pool"])
    assert torch.equal(c1["kv_len"], c2["kv_len"])


def test_prom_carries_the_decode_step_tags():
    tr = SpanTracer()
    for tag in (DECODE_EAGER, DECODE_CAPTURE, DECODE_REPLAY, DECODE_REPLAY):
        tr.end(ST_DECODE_STEP, tr.begin(ST_DECODE_STEP), tag)
    text = render_prom(Metrics(), tracer=tr)
    for tag, n in ((DECODE_EAGER, 1), (DECODE_REPLAY, 2), (DECODE_CAPTURE, 1)):
        assert (f'taiji_stage_tag_spans_total{{stage="decode_step",tag="{tag}"}} '
                f'{n}') in text
    assert 'taiji_stage_tag_seconds_total{stage="decode_step",tag="1"}' in text
    assert 'taiji_stage_spans_total{stage="decode_step"} 4' in text


def test_launches_under_capture_go_to_the_capture_tally(monkeypatch):
    """A counted launch made while the thread's stream captures runs at
    each replay, not now: it goes to ``ops.captured``, and a replay adds
    what its capture recorded; a reset leaves the tally."""
    monkeypatch.setattr(ops, "launches", {"gather": 0})
    monkeypatch.setattr(ops, "captured", {})
    monkeypatch.setattr(ops, "transfers", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    ops._count("paged_attn", 3)
    assert ops.launches == {"gather": 0} and ops.captured == {"paged_attn": 3}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    ops._count("gather")
    ops.count_graph({"paged_attn": 3, "gather": 1})
    assert ops.launches == {"gather": 2, "paged_attn": 3}
    ops.reset_launches()
    assert ops.launches == {"gather": 0, "paged_attn": 0}
    assert ops.captured == {"paged_attn": 3}


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph and the paged kernel run only there)")
    return torch.device("cuda")


def _qwen3_4b(device, n_layers=2, arch="qwen3-4b"):
    """qwen3-4b (or ``arch``) at its published widths and a reduced depth,
    in bf16."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              param_dtype="bfloat16")
    return cfg, M.init_params(cfg, seed=7, device=device)


def _tokens(gen, cfg, batch, device):
    return torch.randint(0, cfg.vocab, (batch,), generator=gen).to(device)


@pytest.mark.cuda
def test_graph_equals_eager_bit_for_bit(cuda_device):
    """Batch 32 over 130 steps: across the 64-token block boundary, to the
    end of a 128-position pool and through a ``kv_len.zero_()`` restart."""
    batch, max_seq, steps = 32, 128, 130
    cfg, model = _qwen3_4b(cuda_device)
    cg = M.init_cache(cfg, batch, max_seq, device=cuda_device)
    ce = M.init_cache(cfg, batch, max_seq, device=cuda_device)
    gen = torch.Generator().manual_seed(11)
    tr = SpanTracer()
    for t in range(steps):
        if t == max_seq:
            cg["kv_len"].zero_()
            ce["kv_len"].zero_()
        toks = _tokens(gen, cfg, batch, cuda_device)
        lg, cg = serve_step(model, toks, cg, cfg, tracer=tr)
        with torch.no_grad():
            le, kv_len = M.decode_body(model, cfg, toks, ce)
        ce = dict(ce, kv_len=kv_len)
        assert torch.equal(lg, le), f"logits differ at step {t}"
        assert torch.equal(cg["kv_len"], ce["kv_len"]), f"kv_len at step {t}"
    assert torch.equal(cg["kv_pool"], ce["kv_pool"])
    assert cg["kv_len"].tolist() == [steps - max_seq] * batch
    assert _tags(tr) == [DECODE_EAGER, DECODE_CAPTURE] + [DECODE_REPLAY] * (steps - 2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE)
def test_graph_equals_eager_for_each_dense_config(arch, cuda_device):
    """Every configuration the rule sends to the graph, at its published
    widths and two layers: 70 steps, across the 64-token block boundary,
    equal the eager body's bit for bit."""
    batch, steps = 4, 70
    cfg, model = _qwen3_4b(cuda_device, arch=arch)
    cg = M.init_cache(cfg, batch, 128, device=cuda_device)
    ce = M.init_cache(cfg, batch, 128, device=cuda_device)
    gen = torch.Generator().manual_seed(17)
    tr = SpanTracer()
    for t in range(steps):
        toks = _tokens(gen, cfg, batch, cuda_device)
        lg, cg = serve_step(model, toks, cg, cfg, tracer=tr)
        with torch.no_grad():
            le, kv_len = M.decode_body(model, cfg, toks, ce)
        ce = dict(ce, kv_len=kv_len)
        assert torch.equal(lg, le), f"logits differ at step {t}"
    assert torch.equal(cg["kv_pool"], ce["kv_pool"])
    assert torch.equal(cg["kv_len"], ce["kv_len"])
    assert _tags(tr) == [DECODE_EAGER, DECODE_CAPTURE] + [DECODE_REPLAY] * (steps - 2)


@pytest.mark.cuda
def test_new_cache_or_replaced_parameter_captures_again(cuda_device):
    batch, max_seq = 8, 128
    cfg, model = _qwen3_4b(cuda_device)
    gen = torch.Generator().manual_seed(3)
    tr = SpanTracer()
    first = M.init_cache(cfg, batch, max_seq, device=cuda_device)
    for _ in range(3):
        _, first = serve_step(model, _tokens(gen, cfg, batch, cuda_device),
                              first, cfg, tracer=tr)
    second = M.init_cache(cfg, batch, max_seq, device=cuda_device)  # first lives on
    for _ in range(3):
        _, second = serve_step(model, _tokens(gen, cfg, batch, cuda_device),
                               second, cfg, tracer=tr)
    mlp = model.layers[1].mlp
    mlp._parameters["w_up"] = torch.nn.Parameter(mlp.w_up.flip(0),
                                                 requires_grad=False)
    ref = {k: v.clone() for k, v in second.items()}
    for _ in range(3):
        toks = _tokens(gen, cfg, batch, cuda_device)
        lg, second = serve_step(model, toks, second, cfg, tracer=tr)
        with torch.no_grad():
            le, kv_len = M.decode_body(model, cfg, toks, ref)
        ref = dict(ref, kv_len=kv_len)
        assert torch.equal(lg, le)           # the replay reads the new weight
    assert _tags(tr) == [DECODE_EAGER, DECODE_CAPTURE, DECODE_REPLAY] * 3


@pytest.mark.cuda
def test_returned_logits_and_kv_len_are_not_overwritten(cuda_device):
    batch = 8
    cfg, model = _qwen3_4b(cuda_device)
    cache = M.init_cache(cfg, batch, 128, device=cuda_device)
    gen = torch.Generator().manual_seed(5)
    kept = []
    for _ in range(5):
        logits, cache = serve_step(model, _tokens(gen, cfg, batch, cuda_device),
                                   cache, cfg)
        kept.append((logits, logits.clone(), cache["kv_len"],
                     cache["kv_len"].clone()))
    for logits, want, kv_len, want_len in kept:
        assert torch.equal(logits, want) and torch.equal(kv_len, want_len)
    assert len({lg.data_ptr() for lg, *_ in kept}) == len(kept)


@pytest.mark.cuda
def test_replay_counts_a_paged_attention_launch_a_layer(cuda_device):
    """The launches a replay adds are those its capture recorded, one
    paged attention a layer; the capture itself launches nothing."""
    batch, n_layers = 8, 3
    cfg, model = _qwen3_4b(cuda_device, n_layers=n_layers)
    cache = M.init_cache(cfg, batch, 128, device=cuda_device)
    gen = torch.Generator().manual_seed(9)
    tr = SpanTracer()
    for _ in range(4):                  # eager, capture + replay, replay, replay
        before = dict(ops.launches)
        _, cache = serve_step(model, _tokens(gen, cfg, batch, cuda_device),
                              cache, cfg, tracer=tr)
        torch.cuda.synchronize()
        assert {k: n - before.get(k, 0) for k, n in ops.launches.items()
                if n != before.get(k, 0)} == {"paged_attn": n_layers}
    assert model.decode_graph.launched == {"paged_attn": n_layers}
    assert _tags(tr) == [DECODE_EAGER, DECODE_CAPTURE, DECODE_REPLAY, DECODE_REPLAY]


@pytest.mark.cuda
def test_capture_beside_a_live_manager(cuda_device):
    """Steps captured and replayed while a TaijiSystem's hv_sched threads
    reclaim, launching the swap kernels on their own streams, and a guest
    thread faults its MSs back in: each capture errors only on its own
    thread's unsafe calls (``thread_local``), records none of the
    manager's launches, and the graph equals the eager body bit for bit.
    A new cache each round captures again, so several captures meet the
    manager's kernels."""
    import threading

    from repro_torch.core.config import small_test_config
    from repro_torch.core.system import TaijiSystem

    batch, rounds, steps = 8, 6, 5
    cfg, model = _qwen3_4b(cuda_device)
    system = TaijiSystem(small_test_config(), device=cuda_device)
    guest, ms = system.guest, system.cfg.ms_bytes
    gfns = [guest.alloc_ms() for _ in range(system.cfg.n_phys_ms)]
    for i, g in enumerate(gfns):
        guest.write(g, bytes([i + 1]) * ms)
    stop, errors, reads = threading.Event(), [], [0]

    def fault_in():             # keeps the free count below the watermarks
        try:
            while not stop.is_set():
                for g in gfns:
                    guest.read(g)
                    reads[0] += 1
        except BaseException as e:   # noqa: BLE001 -- reported below
            errors.append(e)

    swap = ("gather", "fletcher", "scatter_verified")
    gen = torch.Generator().manual_seed(13)
    tr = SpanTracer()
    met = 0                     # captures during which the manager launched
    reader = threading.Thread(target=fault_in)
    system.start_background()
    reader.start()
    try:
        for _ in range(rounds):
            cg = M.init_cache(cfg, batch, 128, device=cuda_device)
            ce = M.init_cache(cfg, batch, 128, device=cuda_device)
            for t in range(steps):
                toks = _tokens(gen, cfg, batch, cuda_device)
                before = sum(ops.launches.get(k, 0) for k in swap)
                lg, cg = serve_step(model, toks, cg, cfg, tracer=tr)
                met += (t == 1 and sum(ops.launches.get(k, 0)
                                       for k in swap) > before)
                with torch.no_grad():
                    le, kv_len = M.decode_body(model, cfg, toks, ce)
                ce = dict(ce, kv_len=kv_len)
                assert torch.equal(lg, le), f"logits differ at step {t}"
                assert torch.equal(cg["kv_len"], ce["kv_len"])
            torch.cuda.synchronize()
            assert torch.equal(cg["kv_pool"], ce["kv_pool"])
            assert model.decode_graph.launched == {"paged_attn": cfg.n_layers}
    finally:
        stop.set()
        reader.join()
        system.stop_background()
        system.close()
    assert not errors, errors
    assert reads[0] > 0 and system.metrics.mp_swapped_out > 0
    assert met > 0, "no capture overlapped a swap kernel of the manager"
    assert _tags(tr) == ([DECODE_EAGER, DECODE_CAPTURE]
                         + [DECODE_REPLAY] * (steps - 2)) * rounds
