"""Tracing spans: nestable wall-clock scopes with chrome-trace export.

Port of paddle_tpu/obs/trace.py. Span categories (`CATEGORIES`)
attribute host wall time to the phases a serving or training run cares
about (prefill / decode / schedule, checkpoint / restart / train). A
span records only while tracing is enabled; disabled, it costs two
attribute reads. With `annotate=True` an enabled span also enters
`torch.profiler.record_function`, so the same scope shows in a
torch.profiler device trace (the reference enters
jax.profiler.TraceAnnotation); torch is imported only then.

Left out: the reference module also hosts the profiler's RecordEvent
machinery (its `paddle_tpu.profiler` aliases these classes). The port
has no `profiler/` package yet, so there is no such shim here.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import List, Optional

__all__ = ["Span", "SpanEvent", "CATEGORIES", "enable", "disable",
           "is_enabled", "clear", "events", "export_chrome", "span"]

#: span categories used by instrument sites; free-form strings are
#: allowed, these are the cataloged ones
CATEGORIES = ("serving", "schedule", "prefill", "decode", "checkpoint",
              "restart", "train", "op", "deploy")


class SpanEvent:
    """One completed span."""

    __slots__ = ("name", "start", "end", "tid", "depth", "cat", "args")

    def __init__(self, name, start, end, tid, depth, cat=None, args=None):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid
        self.depth = depth
        self.cat = cat
        self.args = args

    @property
    def duration(self) -> float:
        return self.end - self.start


class _TraceState:
    """Process-wide trace table: class-attribute state under one lock;
    tls.depth gives each thread's nesting depth."""

    enabled = False
    events: List[SpanEvent] = []
    t0 = 0.0
    lock = threading.Lock()
    tls = threading.local()


def is_enabled() -> bool:
    return _TraceState.enabled


def enable() -> None:
    """Start recording spans (fresh table)."""
    if _TraceState.enabled:
        return
    with _TraceState.lock:
        _TraceState.events = []
        _TraceState.t0 = time.perf_counter()
    _TraceState.enabled = True


def disable() -> None:
    _TraceState.enabled = False


def clear() -> None:
    with _TraceState.lock:
        _TraceState.events = []
        _TraceState.t0 = time.perf_counter()


def events() -> List[SpanEvent]:
    with _TraceState.lock:
        return list(_TraceState.events)


class Span:
    """Scoped wall-clock span; a context manager or a decorator. `cat`
    tags the chrome-trace category; `args` (set at construction or
    mutated inside the scope) is read at end() and written into the
    trace event."""

    def __init__(self, name: str, cat: str = None, args: dict = None,
                 annotate: bool = True):
        self.name = name
        self.cat = cat
        self.args = args
        self.annotate = annotate
        self._t0 = None
        self._ann = None

    def begin(self):
        if _TraceState.enabled:
            self._t0 = time.perf_counter()
            if self.annotate:
                import torch
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            depth = getattr(_TraceState.tls, "depth", 0)
            _TraceState.tls.depth = depth + 1

    def end(self):
        if self._t0 is not None:
            t1 = time.perf_counter()
            _TraceState.tls.depth -= 1
            with _TraceState.lock:
                _TraceState.events.append(SpanEvent(
                    self.name, self._t0, t1,
                    threading.get_ident(), _TraceState.tls.depth,
                    self.cat, self.args))
            if self._ann is not None:
                self._ann.__exit__(None, None, None)
                self._ann = None
            self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with Span(self.name, cat=self.cat, annotate=self.annotate):
                return fn(*a, **k)
        return wrapper


def span(name: str, cat: str = None, args: dict = None,
         annotate: bool = True) -> Span:
    """`with obs.span("x", cat="decode"): ...`"""
    return Span(name, cat=cat, args=args, annotate=annotate)


def export_chrome(path: str, extra_events=None) -> str:
    """Write recorded spans as chrome://tracing JSON: ts/dur in
    microseconds from enable(), category "op" for unlabeled spans.
    `extra_events` are chrome event dicts appended verbatim (obs.export
    adds gauge counter tracks)."""
    evs = events()
    trace = {"traceEvents": [
        dict({"name": e.name, "ph": "X", "cat": e.cat or "op",
              "ts": (e.start - _TraceState.t0) * 1e6,
              "dur": (e.end - e.start) * 1e6,
              "pid": os.getpid(), "tid": e.tid},
             **({"args": e.args} if e.args else {}))
        for e in evs
    ] + list(extra_events or [])}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
