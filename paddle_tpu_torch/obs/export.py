"""Exporters: JSON snapshot, Prometheus text format, chrome trace.

Port of paddle_tpu/obs/export.py. Three read paths over the registry
and the span table, on demand (`dump_snapshot`, `to_prometheus`,
`export_chrome_trace`) or every N seconds from a daemon thread
(`SnapshotExporter`). Exporters only read: they never mint series.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from . import trace as _trace
from .registry import REGISTRY, MetricRegistry

__all__ = ["snapshot", "dump_snapshot", "to_prometheus",
           "export_chrome_trace", "SnapshotExporter"]


def snapshot(registry: Optional[MetricRegistry] = None) -> dict:
    """JSON-able snapshot of every family (counters and gauges carry
    `value`; histograms count, sum, buckets and exact p50/p90/p99) with
    a wall-clock stamp."""
    reg = registry if registry is not None else REGISTRY
    return {"ts": time.time(), "metrics": reg.collect()}


def dump_snapshot(path: str,
                  registry: Optional[MetricRegistry] = None) -> str:
    """Write `snapshot()` to `path`."""
    snap = snapshot(registry)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    return path


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(str(v))}"'
                     for k, v in merged.items())
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return repr(float(v))


def to_prometheus(registry: Optional[MetricRegistry] = None) -> str:
    """Prometheus text exposition format v0.0.4: `# HELP`/`# TYPE`
    headers, one sample line per child, histograms as cumulative
    `_bucket{le=...}` / `_sum` / `_count`."""
    reg = registry if registry is not None else REGISTRY
    lines = []
    for fam in reg.collect():
        name = fam["name"]
        if fam["help"]:
            lines.append(f"# HELP {name} {_prom_escape(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam["series"]:
            if fam["type"] == "histogram":
                for le, c in s["buckets"].items():
                    lines.append(
                        f"{name}_bucket"
                        f"{_prom_labels(s['labels'], {'le': le})} {c}")
                lines.append(
                    f"{name}_sum{_prom_labels(s['labels'])} "
                    f"{_prom_num(s['sum'])}")
                lines.append(
                    f"{name}_count{_prom_labels(s['labels'])} "
                    f"{s['count']}")
            else:
                lines.append(
                    f"{name}{_prom_labels(s['labels'])} "
                    f"{_prom_num(s['value'])}")
    return "\n".join(lines) + "\n"


# gauge families rendered as chrome counter tracks: pool occupancy and
# scheduler depth beside the spans
DEFAULT_COUNTER_FAMILIES = ("serving_cache_blocks", "serving_running",
                            "serving_waiting")


def _gauge_counter_events(registry: MetricRegistry, families) -> list:
    """ph:"C" chrome counter events from the gauges' bounded histories,
    clipped to the trace window and rebased to its t0."""
    t0 = _trace._TraceState.t0
    pid = os.getpid()
    out = []
    for name in families:
        fam = registry.get(name)
        if fam is None or fam.kind != "gauge":
            continue
        for lbls, child in fam.children():
            track = name if not lbls else name + "{" + ",".join(
                f"{k}={v}" for k, v in sorted(lbls.items())) + "}"
            for ts, v in child.samples():
                if ts < t0:
                    continue             # sampled before trace enable()
                out.append({"name": track, "ph": "C", "cat": "gauge",
                            "ts": (ts - t0) * 1e6, "pid": pid, "tid": 0,
                            "args": {"value": v}})
    return out


def export_chrome_trace(path: str,
                        registry: Optional[MetricRegistry] = None,
                        counter_families=DEFAULT_COUNTER_FAMILIES) -> str:
    """Chrome-trace JSON of the recorded spans plus ph:"C" counter
    tracks from the listed gauge families (() for spans only)."""
    reg = registry if registry is not None else REGISTRY
    extra = _gauge_counter_events(reg, counter_families or ())
    return _trace.export_chrome(path, extra_events=extra)


class SnapshotExporter:
    """Daemon thread writing a registry snapshot to `path` every
    `interval_s` seconds; `stop()` joins it and writes one final
    snapshot, so a short run still leaves an artifact."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 registry: Optional[MetricRegistry] = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        self._running = False
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while True:
            self._wake.wait(self.interval_s)
            with self._lock:
                if not self._running:
                    return
            dump_snapshot(self.path, self.registry)

    def start(self) -> "SnapshotExporter":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._wake.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-snapshot-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> str:
        with self._lock:
            was = self._running
            self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if was:
            dump_snapshot(self.path, self.registry)
        return self.path

    def __enter__(self) -> "SnapshotExporter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
