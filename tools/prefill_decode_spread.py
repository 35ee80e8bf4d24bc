#!/usr/bin/env python3
"""How far prefill and paged decode disagree in bf16 at full width, as
they are and with a fault planted in the decode, on models trained at the
reference's lr and at chip_smoke.py phase 13 (b)'s; with ``--families``,
how far decode and the forward disagree for phase 14's (b)-(d).

    python3 tools/prefill_decode_spread.py [--families]

For the shapes of ``chip_smoke.py`` phase 13 (b) (qwen3-4b cut to 16
layers, training batch 4 x 512, 64-token prompts) and (d)
(deepseek-moe-16b cut to 4 layers, 4 x 64, 8-token prompts), f32 master
weights and bf16 compute, from 2 seeds: the model as initialised, and
after ``run_training``'s 6 steps at the reference's lr 3e-4 and at the
phase's ``TRAIN_LR`` (one JSON line with each run's losses and grad
norms). On each model, 2 prompts at batch 4 go through
``chip_smoke.prefill_decode_err`` (``prefill_step`` against
``serve_step`` token by token) once as they are and once under each
planted fault: ``kv_len_short`` (from the second step on, each paged
attention reads one token fewer), ``lost_kv_write`` (the K/V of the
prompt's second-to-last token is never written, in any layer) and, for
the MoE model, ``no_layer0`` (decode skips the dense first layer). One
JSON line a reading, with the phase's tolerance. Needs the card.

With ``--families``: ``chip_smoke.family_model``'s falcon-mamba-7b (b),
one jamba group (c) and qwen2-vl-2b (d), each from 3 seeds, through
``chip_smoke.decode_against_forward`` (decode logits against the
forward's at every position) in bf16 and, for the two mamba models, the
same tokens again with the weights cast to f32 and f32 compute (for
jamba in bf16 also the positions where a token's experts differ between
decode and the forward, and the error where they agree); each as it is
and, from 2 of the seeds (1 for the mamba models in bf16), under each
planted fault: for the mamba layers ``conv_not_shifted`` (the
carried conv window never takes in the new input), ``ssm_not_carried``
(each decode step starts from a zero SSM state) and
``chunk_state_dropped`` (the forward's second scan chunk starts from a
zero state instead of the first chunk's); for jamba's attention layer
and qwen2-vl also ``kv_len_short``, for qwen2-vl ``lost_kv_write`` and
``no_mrope_pos`` (decode rotates by the 1-D position, not the vision
prefix's M-RoPE ids).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

SEEDS, PROMPTS, REFERENCE_LR = (0, 1), 2, 3e-4
# (arch, layers, training batch x seq, prompt batch x tokens)
CASES = ((cs.TRAIN_ARCH, cs.TRAIN_LAYERS, (cs.TRAIN_BATCH, cs.TRAIN_SEQ),
          (cs.PREFILL_BATCH, cs.PREFILL_PROMPT)),
         (cs.EXPERT_ARCH, cs.MOE_TRAIN_LAYERS, (cs.MOE_BATCH, cs.MOE_SEQ),
          (cs.MOE_BATCH, cs.MOE_DECODE)))


@contextlib.contextmanager
def kv_len_short(torch, ops, M, model, T):
    real = ops.paged_decode_attention
    ops.paged_decode_attention = (lambda q, rows, table, kv_len:
                                  real(q, rows, table, torch.clamp(kv_len - 1, min=1)))
    try:
        yield
    finally:
        ops.paged_decode_attention = real


@contextlib.contextmanager
def lost_kv_write(torch, ops, M, model, T):
    real = M._paged_kv_write

    def write(pool_l, table, pos, k, v, bt):
        if int(pos[0]) != T - 2:
            real(pool_l, table, pos, k, v, bt)
    M._paged_kv_write = write
    try:
        yield
    finally:
        M._paged_kv_write = real


@contextlib.contextmanager
def no_layer0(torch, ops, M, model, T):
    model.decoder_layers = lambda: list(model.layers)
    try:
        yield
    finally:
        del model.decoder_layers


@contextlib.contextmanager
def conv_not_shifted(torch, ops, M, model, T):
    real = M.mamba_decode_step

    def step(x, p, cfg, conv, ssm):
        out, _, h = real(x, p, cfg, conv, ssm)
        return out, conv, h
    M.mamba_decode_step = step
    try:
        yield
    finally:
        M.mamba_decode_step = real


@contextlib.contextmanager
def ssm_not_carried(torch, ops, M, model, T):
    real = M.mamba_decode_step
    M.mamba_decode_step = (lambda x, p, cfg, conv, ssm:
                           real(x, p, cfg, conv, torch.zeros_like(ssm)))
    try:
        yield
    finally:
        M.mamba_decode_step = real


@contextlib.contextmanager
def chunk_state_dropped(torch, ops, M, model, T):
    from repro_torch.models import ssm as SSM
    real, seen = SSM._fused_step, [0]

    def step(h, *rest):
        # a scan's first chunk starts from zeros: count chunks from there
        seen[0] = 0 if not bool(h.any()) else seen[0] + 1
        return real(torch.zeros_like(h) if seen[0] == 1 else h, *rest)
    SSM._fused_step = step
    try:
        yield
    finally:
        SSM._fused_step = real


@contextlib.contextmanager
def no_mrope_pos(torch, ops, M, model, T):
    real = M.decode_step
    M.decode_step = (lambda model, cfg, tokens, cache, mrope_pos=None,
                     input_embeds=None:
                     real(model, cfg, tokens, cache, None, input_embeds))
    try:
        yield
    finally:
        M.decode_step = real


@contextlib.contextmanager
def routes(moe, out: list):
    """Record every ``router_topk`` call's experts (sorted per token)."""
    real = moe.router_topk

    def rec(x, w, k):
        g, i, a = real(x, w, k)
        out.append(i.sort(-1).values)
        return g, i, a
    moe.router_topk = rec
    try:
        yield
    finally:
        moe.router_topk = real


def flipped_positions(calls: list, n_moe: int, B: int, T: int):
    """(B, T) mask of the positions whose experts differ between decode
    (T steps of ``n_moe`` calls on B tokens, first) and the forward
    (``n_moe`` calls on B * T tokens, after) in any MoE layer."""
    import torch
    dec = torch.stack([torch.stack([calls[t * n_moe + l] for t in range(T)], 1)
                       for l in range(n_moe)])
    fwd = torch.stack([calls[T * n_moe + l].view(B, T, -1) for l in range(n_moe)])
    return (dec != fwd).any(-1).any(0)


FAMILY_SEEDS = (0, 1, 2)
# the faults' seeds: in bf16 (the mamba faults are below its rounding:
# one seed) and in f32 and for qwen2-vl (two)
BF16_FAULT_SEEDS, FAMILY_FAULT_SEEDS = (0,), (0, 1)
MAMBA_FAULTS = (("conv_not_shifted", conv_not_shifted),
                ("ssm_not_carried", ssm_not_carried),
                ("chunk_state_dropped", chunk_state_dropped))
FAMILY_FAULTS = {"ssm": MAMBA_FAULTS,
                 "hybrid": MAMBA_FAULTS + (("kv_len_short", kv_len_short),),
                 "vlm": (("kv_len_short", kv_len_short),
                         ("lost_kv_write", lost_kv_write),
                         ("no_mrope_pos", no_mrope_pos))}


def families(torch, ops, M) -> None:
    from repro_torch.models import moe as MOE

    for part, faults in FAMILY_FAULTS.items():
        for seed in FAMILY_SEEDS:
            cfg, model, batch, gen = cs.family_model(torch, part, seed)
            fault_seeds = BF16_FAULT_SEEDS if cfg.mamba else FAMILY_FAULT_SEEDS
            for dtype in ("bfloat16", "float32") if cfg.mamba else ("bfloat16",):
                if dtype == "float32":
                    # the sound bf16 run's tokens, the weights cast to f32
                    cfg = dataclasses.replace(cfg, compute_dtype="float32")
                    batch, gen = {"tokens": fed}, 0
                    model.float()
                    fault_seeds = FAMILY_FAULT_SEEDS
                    tol = cs.FAMILY_F32_DECODE_TOL
                else:
                    tol = cs.FAMILY_DECODE_TOL[cfg.name]
                T = batch["tokens"].shape[1] + gen
                plants = [(None, None)] + list(faults if seed in fault_seeds else ())
                for name, plant in plants:
                    calls: list = []
                    with (plant(torch, ops, M, model, T) if plant
                          else contextlib.nullcontext()), \
                            (routes(MOE, calls) if cfg.moe else
                             contextlib.nullcontext()):
                        r, ex = cs.decode_against_forward(torch, ops, model,
                                                          cfg, batch, gen)
                    err = r["decode_vs_forward_rel_err"]
                    line = {"arch": cfg.name, "layers": cfg.n_layers,
                            "seed": seed, "compute": dtype, "positions": T,
                            "fault": name, "rel_err": err,
                            "argmax_equal": r["argmax_equal"], "tolerance": tol,
                            "above_tolerance": None if tol is None else not err < tol}
                    if cfg.moe:
                        flip = flipped_positions(calls, cfg.hybrid_group // 2,
                                                 r["batch"], T)
                        agree = ex["pos_err"][~flip]
                        line.update(flipped_positions=int(flip.sum()),
                                    rel_err_where_routes_agree=(
                                        float(agree.max()) if agree.numel() else None))
                    print(json.dumps(line), flush=True)
                    if name is None and dtype == "bfloat16":
                        fed = ex["tokens"]
                    del ex
                    gc.collect()
                    torch.cuda.empty_cache()
            del model, batch, fed
            gc.collect()
            torch.cuda.empty_cache()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("prefill_decode_spread: needs the card")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.train import run_training
    from repro_torch.models import model as M
    _build.build(verbose=False)
    if "--families" in sys.argv[1:]:
        families(torch, ops, M)
        return

    tol = cs.PREFILL_DECODE_TOL
    for arch, layers, (tb, ts), (pb, T) in CASES:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        faults = [("kv_len_short", kv_len_short), ("lost_kv_write", lost_kv_write)]
        if M.first_dense(cfg):
            faults.append(("no_layer0", no_layer0))
        for seed in SEEDS:
            for state, lr, steps in (("init", REFERENCE_LR, 0),
                                     ("lr 3e-4", REFERENCE_LR, cs.TRAIN_STEPS),
                                     (f"lr {cs.TRAIN_LR:g}", cs.TRAIN_LR, cs.TRAIN_STEPS)):
                r = run_training(cfg, steps=steps, batch=tb, seq=ts, lr=lr,
                                 ckpt_dir=None, ckpt_every=max(steps, 1),
                                 seed=seed, log_every=max(steps, 1), device="cuda")
                if steps:
                    print(json.dumps({"arch": arch, "layers": layers, "seed": seed,
                                      "lr": lr, "batch": [tb, ts], "loss": r["loss"],
                                      "grad_norm": r["grad_norm"]}), flush=True)
                model = r["state"].model
                for p in range(PROMPTS):
                    g = torch.Generator(device="cpu").manual_seed(100 * seed + p)
                    prompt = torch.randint(0, cfg.vocab, (pb, T), generator=g).cuda()
                    for name, plant in [(None, None)] + faults:
                        with (plant(torch, ops, M, model, T) if plant
                              else contextlib.nullcontext()):
                            e = cs.prefill_decode_err(torch, ops, model, cfg, prompt)
                        err = e["prefill_vs_decode_rel_err"]
                        print(json.dumps({
                            "arch": arch, "layers": layers, "seed": seed,
                            "state": state, "prompt": p, "tokens": T, "fault": name,
                            "rel_err": err, "argmax_equal": e["argmax_equal"],
                            "tolerance": tol, "above_tolerance": not err < tol}),
                            flush=True)
                del r, model
                gc.collect()
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
