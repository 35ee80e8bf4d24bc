"""Observability: stage-attributed span tracing + telemetry export.

See :mod:`repro_torch.obs.tracer` for the SpanTracer / stage tree / copy
counters / profiler ranges / Chrome-trace export and
:mod:`repro_torch.obs.prom` for Prometheus text exposition. Enabled
per-system via ``TaijiConfig.obs`` (``ObsConfig(enabled=True)``);
disabled (the default) costs one ``is not None`` branch per instrumented
call site.
"""
from .prom import render_prom
from .tracer import (
    SpanTracer,
    STAGES,
    STAGE_NAMES,
    aggregate,
    export_chrome,
    stage_tree,
)

__all__ = [
    "SpanTracer", "STAGES", "STAGE_NAMES",
    "aggregate", "export_chrome", "stage_tree", "render_prom",
]
