#!/usr/bin/env python3
"""How far prefill and paged decode disagree in bf16 at full width, as
they are and with a fault planted in the decode, on models trained at the
reference's lr and at chip_smoke.py phase 13 (b)'s.

    python3 tools/prefill_decode_spread.py

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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("prefill_decode_spread: needs the card")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.train import run_training
    from repro_torch.models import model as M
    _build.build(verbose=False)

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
