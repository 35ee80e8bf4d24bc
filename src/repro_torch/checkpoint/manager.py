"""Versioned checkpointing with atomic commits (fault-tolerance substrate).

As ``repro/checkpoint/manager.py``:
  * atomic: a checkpoint directory is staged under ``.tmp-<step>`` and
    renamed into place -- a crash mid-save never corrupts the latest
    checkpoint; the newest ``keep`` are kept;
  * complete: params + optimizer state + step + data-pipeline cursor
    travel together, so a restart resumes the exact stream position;
  * ABI-tagged: the manifest carries ``abi_version`` and restore refuses
    an incompatible one, or a state whose layout differs.

Port: the state is the port's :class:`~repro_torch.train.steps.
TrainState`, flattened to ``step``, ``params/<name>``, ``opt/mu/<name>``
and ``opt/nu/<name>`` in the model's parameter order. numpy has no
bfloat16: such a leaf is stored as its bits (``uint16``), and the
manifest records every leaf's dtype. ``restore`` copies into the
template's tensors in place.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import ABI_VERSION
from ..train.steps import TrainState

_MANIFEST = "manifest.json"


def _flatten(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    named = list(state.model.named_parameters())
    out = [("step", torch.tensor(state.step, dtype=torch.int32))]
    out += [(f"params/{n}", p) for n, p in named]
    out += [(f"opt/mu/{n}", t) for (n, _), t in zip(named, state.opt.mu)]
    out += [(f"opt/nu/{n}", t) for (n, _), t in zip(named, state.opt.nu)]
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: TrainState,
             pipeline_snapshot: Optional[Dict] = None,
             extra: Optional[Dict] = None) -> Path:
        stage = self.dir / f".tmp-{step}"
        final = self.dir / f"step_{step:010d}"
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir(parents=True)

        leaves = _flatten(state)
        np.savez(stage / "state.npz", **{k: _to_numpy(t) for k, t in leaves})
        manifest = {
            "step": step,
            "abi_version": ABI_VERSION,
            "time": time.time(),
            "n_arrays": len(leaves),
            "dtypes": {k: _dtype_name(t) for k, t in leaves},
            "pipeline": pipeline_snapshot or {},
            "extra": extra or {},
        }
        (stage / _MANIFEST).write_text(json.dumps(manifest, indent=2))
        os.replace(stage, final)               # atomic commit
        self._gc()
        return final

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                       if p.name.startswith("step_"))
        return steps[-1] if steps else None

    def restore(self, state_template: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Dict]:
        """Restore into ``state_template``'s tensors (cast to their
        dtypes, in place); returns the state at the saved step and the
        manifest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / _MANIFEST).read_text())
        if manifest["abi_version"] != ABI_VERSION:
            raise ValueError(
                f"checkpoint ABI {manifest['abi_version']} != {ABI_VERSION}")
        leaves = _flatten(state_template)
        with np.load(path / "state.npz") as data:
            keys = [k for k, _ in leaves]
            if set(keys) != set(data.files):
                missing = set(keys) - set(data.files)
                extra = set(data.files) - set(keys)
                raise ValueError(f"state layout mismatch: missing={missing} "
                                 f"unexpected={extra}")
            dtypes = manifest["dtypes"]
            with torch.no_grad():
                for k, t in leaves[1:]:
                    t.copy_(_from_numpy(data[k], dtypes[k]))
            saved_step = int(data["step"])
        return TrainState(saved_step, state_template.model,
                          state_template.opt), manifest

    # --------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = sorted(p for p in self.dir.iterdir()
                       if p.name.startswith("step_"))
        for p in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(p)
