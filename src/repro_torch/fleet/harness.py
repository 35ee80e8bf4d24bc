"""Replay-equivalence harness: run-twice-compare with a readable
first-divergence report.

The fleet determinism contract -- two replays of the same seeded trace
through identically-configured fleets produce byte-identical
deterministic snapshots -- used to live as ad-hoc assertions scattered
across ``tests/test_fleet.py`` and ``benchmarks/fleet.py``. This module
makes the contract a first-class object shared by the tests, the fleet
benchmark, and the CI chaos gate: build a fleet, replay a trace, compare
the snapshots, and when they diverge say *where* (the JSON path of the
first differing leaves), not just that they differ.

Typical use::

    from repro_torch.fleet.harness import assert_deterministic
    eq = assert_deterministic(gen.lines(), n_nodes=4, domains=2,
                              device="cpu")
    det = eq.runs[0].deterministic       # first run's snapshot dict

Port: a copy of ``repro/fleet/harness.py`` whose fleets take ``device``
(``None``: the card); the snapshot diff is the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional

from ..core.config import TaijiConfig, small_test_config
from .controller import FleetConfig, FleetController
from .node import NodeAgent
from .trace import TraceReplayer


def build_fleet(n_nodes: int = 4, domains: int = 2,
                cfg: Optional[TaijiConfig] = None,
                fleet_cfg: Optional[FleetConfig] = None,
                device=None) -> FleetController:
    """The canonical test/bench fleet: ``n_nodes`` agents round-robined
    over ``domains`` failure domains, one shared TaijiConfig, every
    node's frames on ``device``."""
    cfg = cfg or small_test_config()
    nodes = [NodeAgent(i, cfg, failure_domain=i % domains, device=device)
             for i in range(n_nodes)]
    return FleetController(nodes, fleet_cfg or FleetConfig())


@dataclasses.dataclass
class ReplayRun:
    """One trace replay: the byte-stable snapshot plus the full result."""

    bytes: bytes            # deterministic snapshot serialization
    result: dict            # full snapshot (deterministic + latency)

    @property
    def deterministic(self) -> dict:
        return self.result["deterministic"]

    @property
    def counters(self) -> dict:
        """The replayer's op counters (``replay`` sub-dict)."""
        return self.result["deterministic"]["replay"]


def replay(lines, *, n_nodes: int = 4, domains: int = 2,
           cfg: Optional[TaijiConfig] = None,
           fleet_cfg: Optional[FleetConfig] = None,
           make_fleet: Optional[Callable[[], FleetController]] = None,
           upgrade_module_cls=None, device=None) -> ReplayRun:
    """One full trace replay through a fresh fleet (closed afterwards)."""
    fleet = (make_fleet() if make_fleet is not None
             else build_fleet(n_nodes, domains, cfg, fleet_cfg, device))
    try:
        rep = TraceReplayer(fleet, lines,
                            upgrade_module_cls=upgrade_module_cls)
        result = rep.run()
        return ReplayRun(bytes=rep.deterministic_bytes(), result=result)
    finally:
        fleet.close()


# ------------------------------------------------------- snapshot diffing
def snapshot_diff(a, b, path: str = "$", limit: int = 8) -> List[str]:
    """Structural diff of two JSON-compatible snapshots: one line per
    differing leaf (``$.path.to.key: left != right``), depth-first, at
    most ``limit`` entries so a totally-divergent replay stays readable."""
    out: List[str] = []
    _diff(a, b, path, out, limit)
    return out


def _diff(a, b, path: str, out: List[str], limit: int) -> None:
    if len(out) >= limit:
        return
    if type(a) is not type(b):
        out.append(f"{path}: type {type(a).__name__} != {type(b).__name__}")
        return
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a:
                out.append(f"{path}.{k}: missing in first")
            elif k not in b:
                out.append(f"{path}.{k}: missing in second")
            else:
                _diff(a[k], b[k], f"{path}.{k}", out, limit)
            if len(out) >= limit:
                return
    elif isinstance(a, list):
        if len(a) != len(b):
            out.append(f"{path}: length {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _diff(x, y, f"{path}[{i}]", out, limit)
            if len(out) >= limit:
                return
    elif a != b:
        out.append(f"{path}: {a!r} != {b!r}")


def first_divergence(a: bytes, b: bytes) -> Optional[str]:
    """Readable first-divergence report between two deterministic
    snapshot serializations, or ``None`` when byte-identical."""
    if a == b:
        return None
    diffs = snapshot_diff(json.loads(a.decode()), json.loads(b.decode()))
    if not diffs:
        return "serializations differ but no structural diff found"
    return "; ".join(diffs)


# -------------------------------------------------------- the contract
@dataclasses.dataclass
class Equivalence:
    """Outcome of a run-twice-compare."""

    identical: bool
    runs: List[ReplayRun]
    divergence: Optional[str]

    def report(self) -> str:
        if self.identical:
            return "byte-identical replays"
        return f"replays diverge: {self.divergence}"


def replay_twice(lines, **kw) -> Equivalence:
    """The fleet determinism contract in run-twice-compare form: replay
    the trace through two fresh identically-configured fleets and diff
    the deterministic snapshots."""
    runs = [replay(lines, **kw) for _ in range(2)]
    div = first_divergence(runs[0].bytes, runs[1].bytes)
    return Equivalence(identical=div is None, runs=runs, divergence=div)


def assert_deterministic(lines, **kw) -> Equivalence:
    """replay_twice + assert, with the divergence report as the message."""
    eq = replay_twice(lines, **kw)
    assert eq.identical, eq.report()
    return eq
