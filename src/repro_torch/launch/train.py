"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

As ``repro/launch/train.py``: runs real steps, resumes from the latest
checkpoint (params + optimizer + data cursor), saves atomically every
``--ckpt-every`` steps. The flags and defaults are the reference's, plus
``--device`` (the card unless it says ``cpu``). ``run_training`` is the
loop as a function, for callers that want its per-step numbers.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, Optional


from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..configs.reduce import reduced_config
from ..core.virt import resolve_device
from ..data.pipeline import SyntheticPipeline
from ..optim import adamw
from ..train import steps as S


def run_training(cfg, *, steps: int, batch: int, seq: int, lr: float,
                 ckpt_dir: Optional[str], ckpt_every: int, seed: int,
                 log_every: int, device=None) -> Dict[str, Any]:
    """Train ``cfg`` from ``seed`` (or the latest checkpoint in
    ``ckpt_dir``) up to ``steps``; ``device`` ``None`` means the card.

    Returns the final ``state``, ``pipeline`` and ``opt_cfg``, the step
    it started from, and per step run here its ``loss``, ``grad_norm``, ``lr`` and
    wall time in ms (each step ends in a read of its loss, which waits
    for the device). Raises ``FloatingPointError`` if a loss is not
    finite."""
    device = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(1, steps // 20),
                                state_dtype=cfg.opt_dtype)
    state = S.init_train_state(cfg, opt_cfg, seed=seed, device=device)
    pipe = SyntheticPipeline(cfg, batch, seq, seed=seed)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, manifest = ckpt.restore(state)
        pipe.restore(manifest["pipeline"])
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    out: Dict[str, Any] = {"start_step": start_step, "loss": [],
                           "grad_norm": [], "lr": [], "step_ms": []}
    t0 = time.time()
    for i in range(start_step, steps):
        t_step = time.perf_counter()
        state, metrics = S.train_step(
            state, S.to_device(pipe.next_batch(), device), cfg, opt_cfg)
        loss = float(metrics["loss"])
        out["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        out["loss"].append(loss)
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["lr"].append(float(metrics["lr"]))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i + 1}: loss diverged ({loss})")
        if (i + 1) % log_every == 0 or i + 1 == steps:
            dt = (time.time() - t0) / max(1, i + 1 - start_step)
            print(f"step {i+1:5d} loss={loss:.4f} "
                  f"grad_norm={out['grad_norm'][-1]:.3f} "
                  f"({dt*1e3:.0f} ms/step)")
        if ckpt is not None and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, state, pipe.snapshot())
    if ckpt is not None:
        ckpt.save(steps, state, pipe.snapshot())
    print("training done")
    out.update(state=state, pipeline=pipe, opt_cfg=opt_cfg)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args()

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    run_training(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, seed=args.seed,
                 log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
