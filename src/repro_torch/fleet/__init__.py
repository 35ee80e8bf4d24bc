"""Fleet control plane: multi-node elasticity orchestration (paper §5,
"across more than 30,000 servers") + trace-driven workload replay +
deterministic chaos (failure injection, live MS migration).

Layering:
  node (NodeAgent = one TaijiSystem + entry table, stepped, killable)
  -> controller (admission, placement, staggered reclaim, rolling
     upgrade, failure recovery, live migration)
  -> trace (TSV format incl. chaos + captured payload ops,
     TraceGen/FailureSchedule synthesis, TraceRecorder capture,
     deterministic TraceReplayer)
  -> capture (real elastic_kv / elastic_params serving loops recorded
     through one instrumented GuestSpace)
  -> harness (run-twice-compare replay equivalence + divergence reports)

Port: a copy of ``repro/fleet`` over the port's systems, whose guest
frames live on a device (``device=``; the card by default, ``"cpu"`` for
the parity runs). Traces and deterministic snapshots are the reference's
byte for byte.
"""
from .node import NodeAgent, NodeDeadError, NodeNotServingError
from .controller import (REJECT_MIGRATE_BAD_SRC, REJECT_MIGRATE_NO_DST,
                         REJECT_MIGRATE_VERIFY, REJECT_NO_CAPACITY,
                         REJECT_OVERCOMMIT, FleetConfig, FleetController)
from .trace import (FailureSchedule, TraceGen, TraceHeader, TraceRecorder,
                    TraceReplayer, chaos_trace, decode_payload,
                    encode_payload, page_bytes, page_kind, paper_trace,
                    parse_line, touch_addr)
from .capture import (CapturedTrace, capture_expert_churn,
                      capture_kv_serving)
from .harness import (Equivalence, ReplayRun, assert_deterministic,
                      build_fleet, first_divergence, replay, replay_twice,
                      snapshot_diff)

__all__ = [
    "NodeAgent", "NodeDeadError", "NodeNotServingError",
    "FleetConfig", "FleetController",
    "REJECT_OVERCOMMIT", "REJECT_NO_CAPACITY",
    "REJECT_MIGRATE_BAD_SRC", "REJECT_MIGRATE_NO_DST",
    "REJECT_MIGRATE_VERIFY",
    "FailureSchedule", "TraceGen", "TraceHeader", "TraceRecorder",
    "TraceReplayer", "chaos_trace", "decode_payload", "encode_payload",
    "page_bytes", "page_kind", "paper_trace", "parse_line", "touch_addr",
    "CapturedTrace", "capture_expert_churn", "capture_kv_serving",
    "Equivalence", "ReplayRun", "assert_deterministic", "build_fleet",
    "first_divergence", "replay", "replay_twice", "snapshot_diff",
]
