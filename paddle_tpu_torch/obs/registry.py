"""Metrics registry: process-wide counters, gauges and histograms.

Port of paddle_tpu/obs/registry.py (host Python and numpy, the same
semantics). Every instrument site records into one registry through
labeled metric families, so the exporters, the engine's `EngineStats`
view and the harnesses read the same numbers.

- A Family is a named metric of one kind (counter | gauge | histogram)
  with a fixed tuple of label names; `family.labels(engine="eng0")`
  returns the child series for those label values, created on first
  use. A label-less family is its own single child.
- Counter: monotonic float (`inc`; a negative delta raises). Gauge:
  settable float (`set`/`inc`/`dec`) with a bounded (perf_counter,
  value) history for chrome-trace counter tracks. Histogram: fixed
  cumulative buckets (the Prometheus shape) plus a bounded window of
  raw samples, so `quantile(q)` equals `np.quantile` while the window
  holds every observation.
- One RLock per registry, shared by its families and children.

Recording is host arithmetic on values the caller already holds: it
never touches a device tensor.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Family", "MetricRegistry",
           "REGISTRY", "DEFAULT_BUCKETS"]

# latency buckets in seconds, 0.5 ms .. 60 s, roughly exponential
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))

#: raw-sample window per histogram child; quantiles are numpy-exact
#: while total observations <= this cap
DEFAULT_SAMPLE_CAP = 8192

#: bounded per-gauge (ts, value) history backing the chrome counter tracks
GAUGE_HISTORY_CAP = 512


class Counter:
    """Monotonic counter child: `inc` only goes up (a negative delta
    raises, which keeps EngineStats' delta setters honest)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter can only increase (inc({n}))")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value child. Every mutation also appends a
    (perf_counter, value) sample to a bounded history ring."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0
        self._history: deque = deque(maxlen=GAUGE_HISTORY_CAP)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._history.append((time.perf_counter(), self._value))

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self._history.append((time.perf_counter(), self._value))

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n
            self._history.append((time.perf_counter(), self._value))

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[float, float]]:
        """The bounded (perf_counter ts, value) history window."""
        with self._lock:
            return list(self._history)


def _norm_bounds(buckets: Sequence[float]) -> Tuple[float, ...]:
    """Validated histogram upper bounds: ascending, +inf-terminated."""
    bounds = tuple(float(b) for b in buckets)
    if not bounds or bounds[-1] != float("inf"):
        bounds = bounds + (float("inf"),)
    if list(bounds) != sorted(bounds):
        raise ValueError(f"bucket bounds must ascend: {bounds}")
    return bounds


class Histogram:
    """Fixed-bucket histogram child with an exact-quantile sample window
    (quantiles of the latest `sample_cap` observations; count, sum and
    buckets stay exact forever)."""

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 sample_cap: int = DEFAULT_SAMPLE_CAP):
        bounds = _norm_bounds(buckets)
        if sample_cap < 1:
            raise ValueError("sample_cap must be >= 1")
        self.bounds = bounds
        self.sample_cap = int(sample_cap)
        self._lock = lock
        self._count = 0
        self._sum = 0.0
        self._bucket_counts = [0] * len(bounds)
        self._samples: List[float] = []
        self._next = 0                       # ring write index once full

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._bucket_counts[i] += 1
                    break
            if len(self._samples) < self.sample_cap:
                self._samples.append(v)
            else:
                self._samples[self._next] = v
                self._next = (self._next + 1) % self.sample_cap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def buckets(self) -> Dict[float, int]:
        """Cumulative counts per upper bound (Prometheus `le` shape)."""
        with self._lock:
            out, acc = {}, 0
            for b, c in zip(self.bounds, self._bucket_counts):
                acc += c
                out[b] = acc
            return out

    def quantile(self, q: float) -> float:
        """np.quantile (linear interpolation) over the retained window;
        NaN with no samples."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if not self._samples:
                return float("nan")
            arr = np.asarray(self._samples, np.float64)
        return float(np.quantile(arr, q))

    def percentiles(self, qs: Iterable[float] = (0.5, 0.9, 0.99)
                    ) -> Dict[str, float]:
        """{'p50': ..., 'p90': ..., 'p99': ...}."""
        return {f"p{q * 100:g}": self.quantile(q) for q in qs}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: kind + label names + children per label
    values. A label-less family proxies record calls to its single
    implicit child."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labels: Sequence[str] = (), unit: str = "",
                 lock: Optional[threading.RLock] = None, **child_kw):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.label_names = tuple(labels)
        self._child_kw = child_kw
        self._lock = lock or threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kv) -> object:
        """Child for these label values (created on first use)."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](self._lock, **self._child_kw)
                self._children[key] = child
            return child

    def get(self, **kv) -> Optional[object]:
        """Existing child or None; never creates one."""
        key = tuple(str(kv.get(n, "")) for n in self.label_names)
        with self._lock:
            return self._children.get(key)

    def children(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in items]

    # ------------------------------------------------- label-less proxy
    def _default(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; call "
                f".labels(...) first")
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)


class MetricRegistry:
    """Family table. `counter`/`gauge`/`histogram` are get-or-create:
    re-declaring a name with the same kind and labels returns the same
    family; a kind or label-set mismatch raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, Family] = {}

    def _declare(self, name: str, kind: str, help: str, labels, unit: str,
                 **child_kw) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, re-declared as "
                        f"{kind}{tuple(labels)}")
                return fam
            fam = Family(name, kind, help=help, labels=labels, unit=unit,
                         lock=self._lock, **child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = (),
                unit: str = "") -> Family:
        return self._declare(name, "counter", help, labels, unit)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = (),
              unit: str = "") -> Family:
        return self._declare(name, "gauge", help, labels, unit)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), unit: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  sample_cap: int = DEFAULT_SAMPLE_CAP) -> Family:
        return self._declare(name, "histogram", help, labels, unit,
                             buckets=_norm_bounds(buckets),
                             sample_cap=sample_cap)

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def reset(self) -> None:
        """Drop every family (between runs only: instrument sites keep
        Family references)."""
        with self._lock:
            self._families.clear()

    def collect(self) -> List[dict]:
        """Plain-data snapshot of every family (the exporters' input)."""
        out: List[dict] = []
        for fam in self.families():
            series = []
            for lbls, child in fam.children():
                if fam.kind == "histogram":
                    series.append({
                        "labels": lbls,
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": {("+Inf" if b == float("inf")
                                     else repr(b)): c
                                    for b, c in child.buckets().items()},
                        "p50": child.quantile(0.5),
                        "p90": child.quantile(0.9),
                        "p99": child.quantile(0.99),
                    })
                else:
                    series.append({"labels": lbls, "value": child.value})
            out.append({"name": fam.name, "type": fam.kind,
                        "help": fam.help, "unit": fam.unit,
                        "labels": list(fam.label_names),
                        "series": series})
        return out


#: the process-wide default registry every instrument site records into
REGISTRY = MetricRegistry()
