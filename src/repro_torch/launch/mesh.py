"""Production mesh construction, as abstract meshes.

As ``repro/launch/mesh.py``: the reference's production target is TPU
pods of 16 x 16 chips (("data", "model")), and 2 pods multi-pod
(("pod", "data", "model")); at more pods the same function takes
``pods=N``. The port runs on one device, so a mesh here is only axis
names and sizes: the sharding rules (:mod:`.sharding`) read it and the
dry run (:mod:`.dryrun`) sizes each device's shards on it. Nothing here
touches a device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, major to minor."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh: sizes {self.axis_sizes} do not match "
                             f"names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False,
                         pods: int = 2) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((pods, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh() -> AbstractMesh:
    """Single-device mesh (examples, tests)."""
    return AbstractMesh((1, 1), ("data", "model"))
