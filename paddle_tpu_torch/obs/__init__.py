"""paddle_tpu_torch.obs: metrics registry, spans, exporters and
per-request tracing (port of paddle_tpu/obs/, the same public names).

- `registry`: counters / gauges / fixed-bucket histograms with exact
  quantiles, as labeled families in the process-wide `REGISTRY`; the
  serving engine's `EngineStats` is a view over it.
- `trace`: nestable wall-clock spans with categories.
- `export`: JSON snapshot, Prometheus text and chrome trace, on demand
  or periodically.
- `reqtrace`: the per-request causal event ring and the flight
  recorder.

Importing this package pulls in the standard library and numpy only.
Recording is host arithmetic on values already fetched: the telemetry
adds no device synchronisation.
"""
from __future__ import annotations

from . import export, registry, reqtrace, trace
from .export import (SnapshotExporter, dump_snapshot, export_chrome_trace,
                     snapshot, to_prometheus)
from .registry import (DEFAULT_BUCKETS, Counter, Family, Gauge, Histogram,
                       MetricRegistry, REGISTRY)
from .reqtrace import ReqTraceRing, TraceEvent
from .trace import CATEGORIES, Span, SpanEvent, span

__all__ = [
    "REGISTRY", "MetricRegistry", "Family", "Counter", "Gauge", "Histogram",
    "DEFAULT_BUCKETS", "counter", "gauge", "histogram",
    "Span", "SpanEvent", "span", "CATEGORIES", "trace",
    "reqtrace", "ReqTraceRing", "TraceEvent",
    "snapshot", "dump_snapshot", "to_prometheus", "export_chrome_trace",
    "SnapshotExporter", "export", "registry",
    "set_roofline", "get_roofline",
]


def counter(name: str, help: str = "", labels=(), unit: str = "") -> Family:
    """Get-or-create a counter family in the default REGISTRY."""
    return REGISTRY.counter(name, help=help, labels=labels, unit=unit)


def gauge(name: str, help: str = "", labels=(), unit: str = "") -> Family:
    """Get-or-create a gauge family in the default REGISTRY."""
    return REGISTRY.gauge(name, help=help, labels=labels, unit=unit)


def histogram(name: str, help: str = "", labels=(), unit: str = "",
              buckets=DEFAULT_BUCKETS, sample_cap: int = 8192) -> Family:
    """Get-or-create a histogram family in the default REGISTRY."""
    return REGISTRY.histogram(name, help=help, labels=labels, unit=unit,
                              buckets=buckets, sample_cap=sample_cap)


def set_roofline(program: str, tokens_per_sec: float) -> None:
    """Publish a static-model roofline (tokens/s) for `program` as the
    `static_roofline_tokens_per_sec{program}` gauge."""
    gauge("static_roofline_tokens_per_sec",
          "static-model roofline throughput per program",
          labels=("program",),
          unit="tokens_per_second").labels(program=program).set(
              float(tokens_per_sec))


def get_roofline(program: str):
    """Roofline tokens/s previously published for `program`, or None."""
    fam = REGISTRY.get("static_roofline_tokens_per_sec")
    if fam is None:
        return None
    child = fam.get(program=program)
    if child is None:
        return None
    v = child.value
    return v if v > 0 else None
