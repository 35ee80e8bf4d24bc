"""Prometheus text exposition for Metrics + SpanTracer.

One render path for everything an external scraper (or the future
autoscaler) consumes: the deterministic event counters, the latency
histograms (native power-of-two buckets, in seconds), derived gauges,
and -- when tracing is enabled -- per-stage span aggregates and the
per-stage counts and bytes of copies across PCIe.

The module is import-light on purpose: it reads ``Metrics`` and
``SpanTracer`` duck-typed, so ``repro_torch.core.metrics`` can delegate here
lazily without an import cycle.
"""
from __future__ import annotations

from typing import List


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _render_hist(lines: List[str], metric: str, hist,
                 labels: str = "") -> None:
    """Render one LatencyHistogram as a Prometheus histogram (seconds)."""
    base = f"{{{labels}" if labels else "{"
    cum = 0
    for i, c in enumerate(hist.buckets):
        cum += c
        if i < hist._NBUCKETS:
            le = (1 << (i + hist._BASE_SHIFT)) / 1e9
            le_s = f"{le:.9f}".rstrip("0").rstrip(".")
        else:
            le_s = "+Inf"
        sep = "," if labels else ""
        lines.append(f'{metric}_bucket{base}{sep}le="{le_s}"}} {cum}')
    lines.append(f"{metric}_sum{base}}} {hist.total_ns / 1e9:.9f}"
                 if labels else f"{metric}_sum {hist.total_ns / 1e9:.9f}")
    lines.append(f"{metric}_count{base}}} {hist.count}"
                 if labels else f"{metric}_count {hist.count}")


def render_prom(metrics, tracer=None, prefix: str = "taiji") -> str:
    """Render ``metrics`` (and optionally a tracer) as Prometheus text.

    ``tracer`` defaults to ``metrics.tracer``; pass an explicit tracer
    (or a merged fleet view) to override.
    """
    if tracer is None:
        tracer = getattr(metrics, "tracer", None)
    lines: List[str] = []

    # deterministic event counters -> counters
    det = metrics.deterministic_snapshot()
    for name in sorted(det):
        lines.append(f"# TYPE {prefix}_{name}_total counter")
        lines.append(f"{prefix}_{name}_total {det[name]}")

    # derived gauges
    lines.append(f"# TYPE {prefix}_compression_ratio gauge")
    lines.append(f"{prefix}_compression_ratio "
                 f"{metrics.compression_ratio():.6f}")

    # latency histograms (seconds; native power-of-two buckets)
    lines.append(f"# TYPE {prefix}_fault_latency_seconds histogram")
    _render_hist(lines, f"{prefix}_fault_latency_seconds",
                 metrics.fault_latency)
    for kind, hist in metrics.fault_latency_by_kind.items():
        if hist.count:
            _render_hist(lines, f"{prefix}_fault_latency_seconds", hist,
                         labels=f'kind="{_esc(kind)}"')
    for name, hist in (("swap_out", metrics.swap_out_latency),
                       ("swap_in", metrics.swap_in_latency)):
        if hist.count:
            lines.append(f"# TYPE {prefix}_{name}_latency_seconds histogram")
            _render_hist(lines, f"{prefix}_{name}_latency_seconds", hist)

    # tracer stage aggregates
    if tracer is not None:
        totals = tracer.totals()
        if totals:
            lines.append(f"# TYPE {prefix}_stage_seconds_total counter")
            lines.append(f"# TYPE {prefix}_stage_spans_total counter")
            lines.append(f"# TYPE {prefix}_stage_max_seconds gauge")
            for stage in sorted(totals):
                t = totals[stage]
                lab = f'stage="{_esc(stage)}"'
                lines.append(f"{prefix}_stage_seconds_total{{{lab}}} "
                             f"{t['total_ns'] / 1e9:.9f}")
                lines.append(f"{prefix}_stage_spans_total{{{lab}}} "
                             f"{t['count']}")
                lines.append(f"{prefix}_stage_max_seconds{{{lab}}} "
                             f"{t['max_ns'] / 1e9:.9f}")
        copies = tracer.copies()
        if copies:
            lines.append(f"# TYPE {prefix}_stage_copies_total counter")
            lines.append(f"# TYPE {prefix}_stage_copy_bytes_total counter")
            for stage in sorted(copies):
                for d in sorted(copies[stage]):
                    c = copies[stage][d]
                    lab = f'stage="{_esc(stage)}",dir="{d}"'
                    lines.append(f"{prefix}_stage_copies_total{{{lab}}} "
                                 f"{c['count']}")
                    lines.append(f"{prefix}_stage_copy_bytes_total{{{lab}}} "
                                 f"{c['bytes']}")
    return "\n".join(lines) + "\n"
