"""Quickstart: train a ~100M-parameter decoder end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --steps 300

builds a ~100M qwen3-style model (exact configs for the ten assigned
architectures live in src/repro_torch/configs/), streams synthetic data,
checkpoints every 50 steps, and survives restarts (rerun the command --
it resumes from the latest checkpoint). ``--tiny`` shrinks the model for
a short smoke run on the CPU (``--device cpu``; the card by default).

Port of ``examples/quickstart.py``: the same configs, steps and printed
lines; the default checkpoint directory is under the temporary
directory (``TMPDIR``).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..core.virt import resolve_device
from ..data.pipeline import SyntheticPipeline
from ..models.config import ArchConfig
from ..optim import adamw
from ..train import steps


def config_100m() -> ArchConfig:
    return ArchConfig(
        name="quickstart-100m", family="dense", vocab=32768,
        d_model=640, n_layers=10, n_heads=10, n_kv_heads=2, head_dim=64,
        d_ff=1792, qk_norm=True, attn_chunk_q=128, attn_chunk_kv=256,
    )


def config_tiny() -> ArchConfig:
    return dataclasses.replace(config_100m(), vocab=2048, d_model=128,
                               n_layers=4, n_heads=4, n_kv_heads=2,
                               head_dim=32, d_ff=384)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_quickstart_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_tiny() if args.tiny else config_100m()
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.n_layers}L d{cfg.d_model})")

    opt_cfg = adamw.AdamWConfig(lr=6e-4, total_steps=args.steps,
                                warmup_steps=max(1, args.steps // 20))
    state = steps.init_train_state(cfg, opt_cfg, seed=0, device=device)
    pipe = SyntheticPipeline(cfg, args.batch, args.seq, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir)

    start = 0
    if ckpt.latest_step() is not None:
        state, manifest = ckpt.restore(state)
        pipe.restore(manifest["pipeline"])
        start = manifest["step"]
        print(f"resumed from step {start}")

    t0 = time.time()
    first_loss = None
    metrics = None
    for i in range(start, args.steps):
        batch = steps.to_device(pipe.next_batch(), device)
        state, metrics = steps.train_step(state, batch, cfg, opt_cfg)
        if (i + 1) % 10 == 0 or i == start:
            loss = float(metrics["loss"])
            first_loss = first_loss if first_loss is not None else loss
            rate = (i + 1 - start) / (time.time() - t0)
            print(f"step {i+1:4d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {rate:.2f} it/s")
            if not np.isfinite(loss):
                raise FloatingPointError(f"step {i + 1}: loss {loss}")
        if (i + 1) % 50 == 0:
            ckpt.save(i + 1, state, pipe.snapshot())
    ckpt.save(args.steps, state, pipe.snapshot())
    if metrics is not None:
        print(f"done; loss {first_loss:.3f} -> {float(metrics['loss']):.3f}")


if __name__ == "__main__":
    main()
