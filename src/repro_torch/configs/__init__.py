"""Architecture registry: ``--arch <id>`` resolution + shape sets.

Each assigned architecture has its own module with the exact published
config; ``get_config(arch_id)`` resolves it. ``SHAPES`` defines the
assigned input-shape set (shared by all LM-family archs) and
``runnable_cells()`` enumerates the (arch x shape) dry-run matrix with the
assignment's documented skips.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from ..models.config import ArchConfig

_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-20b": "granite_20b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS = list(_MODULES)

# configurations of the port alone: get_config resolves them, but they
# are outside ARCH_IDS (the reference's list, whose dry-run matrix and
# parity tests cover every entry)
PORT_MODULES = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def get_config(arch_id: str) -> ArchConfig:
    module = _MODULES.get(arch_id) or PORT_MODULES.get(arch_id)
    if module is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{ARCH_IDS + list(PORT_MODULES)}")
    mod = importlib.import_module(f"{__name__}.{module}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic sequence mixing (may run long_500k)
SUBQUADRATIC = {"jamba-1.5-large-398b", "falcon-mamba-7b"}
ENCODER_ONLY = {"hubert-xlarge"}


def cell_skip_reason(arch_id: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch_id not in SUBQUADRATIC:
        return "long_500k needs sub-quadratic attention (pure full-attention arch)"
    if arch_id in ENCODER_ONLY and SHAPES[shape].kind == "decode":
        return "encoder-only arch has no decode step"
    return None


def runnable_cells() -> List[Tuple[str, str]]:
    cells = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if cell_skip_reason(a, s) is None:
                cells.append((a, s))
    return cells


def all_cells() -> List[Tuple[str, str, Optional[str]]]:
    return [(a, s, cell_skip_reason(a, s)) for a in ARCH_IDS for s in SHAPES]
