"""Step-span tracing (``torchrec_tpu/obs/spans.py``): nested,
thread-aware monotonic spans around the host stages (data load, cache
remap, prefetch staging, H2D, step dispatch, checkpoint save, the serving
request path).

Every span is a ``torch.profiler.record_function`` range, installed
tracer or not: close to free when no profiler runs, and a named range on
the host timeline (the CUDA kernels it launched beneath it) when one
does, which is the JAX package's ``jax_annotations`` option always on.
A :class:`SpanTracer` installed with :func:`install_tracer` also records
each span with ``time.perf_counter`` timestamps, its per-thread nesting
depth and its thread, in a bounded buffer (appends past ``max_spans``
are dropped and counted), and feeds it to the installed flight recorder.

Two exports of the same records: EventLog JSONL (``flush_jsonl``, one
``{"event": "span", ...}`` a line) and Chrome trace-event JSON
(``export_chrome_trace``, complete ``"ph": "X"`` events, one track a
thread), which ``python -m torchrec_tpu_torch.obs report`` reads.

With no tracer, ``span()`` returns a range whose ``set_attr`` does
nothing; with one, a span is two ``perf_counter`` calls and a locked list
append on top of the range.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from torchrec_tpu_torch.obs import flight_recorder as _flight

__all__ = [
    "SpanTracer",
    "current_tracer",
    "install_tracer",
    "span",
    "uninstall_tracer",
]


def _range(name: str, attrs: Optional[dict]):
    args = ", ".join(f"{k}={v}" for k, v in attrs.items()) if attrs else None
    return torch.profiler.record_function(name, args)


class _RangeSpan:
    """The span with no tracer installed: the profiler range alone."""

    __slots__ = ("_rf",)

    def __init__(self, name: str, attrs: Optional[dict]):
        self._rf = _range(name, attrs)

    def __enter__(self) -> "_RangeSpan":
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rf.__exit__(exc_type, exc, tb)
        return False

    def set_attr(self, key: str, value: Any) -> None:
        """No-op twin of ``_Span.set_attr``."""


class _Span:
    """One live span of a tracer: records itself on exit, also when an
    exception closed it (with ``attrs["error"]``, the exception's
    type)."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "wall0", "depth", "_rf")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._rf = _range(name, attrs)

    def set_attr(self, key: str, value: Any) -> None:
        """Attach or overwrite an attribute while the span is open, e.g.
        a measured sub-interval a consumer should prefer over the span's
        own duration (``attrs["seconds"]`` of the prefetch stage and wait
        spans, which ``obs report`` reads so that its overlap ratio is
        ``TieredStats``' to the float)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self.name)
        self._rf.__enter__()
        self.wall0 = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self.t0
        self._rf.__exit__(exc_type, exc, tb)
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs or ())
            attrs["error"] = exc_type.__name__
        tracer._record(self.name, self.t0, self.wall0, dur, self.depth, attrs)
        return False


class SpanTracer:
    """Collects spans from any thread into one bounded buffer (past
    ``max_spans`` a span is dropped and counted in ``dropped``).

    event_log: optional ``EventLog``-like object (``emit(event,
        **fields)``); when set, every span streams a JSONL line as it
        closes.  Leave None and call ``flush_jsonl`` at a boundary to
        keep the hot path free of writes.
    """

    def __init__(self, event_log: Any = None, max_spans: int = 200_000):
        self._event_log = event_log
        self._max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self.dropped = 0
        # the perf_counter epoch of the Chrome trace's timestamps
        self._epoch = time.perf_counter()

    def span(self, name: str, **attrs: Any) -> _Span:
        """Open a span: ``with tracer.span("stage"): ...``."""
        return _Span(self, name, attrs or None)

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, name: str, t0: float, wall0: float, dur: float,
                depth: int, attrs: Optional[dict]) -> None:
        thread = threading.current_thread()
        rec: Dict[str, Any] = {
            "name": name,
            "mono": t0,
            "t": wall0,
            "dur_s": dur,
            "tid": thread.ident,
            "thread": thread.name,
            "depth": depth,
        }
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            if len(self._spans) >= self._max_spans:
                self.dropped += 1
            else:
                self._spans.append(rec)
        if self._event_log is not None:
            self._event_log.emit("span", **{
                k: v for k, v in rec.items() if k not in ("t", "mono")})
        # the flight recorder's ring keeps the latest spans, so that a
        # post-mortem dump shows what the process was doing
        recorder = _flight.current_recorder()
        if recorder is not None:
            recorder.record_span(rec)

    @property
    def spans(self) -> List[Dict[str, Any]]:
        """A copy of the list of recorded spans (the records shared)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0

    def flush_jsonl(self, path: str) -> int:
        """Append every recorded span as an EventLog-shaped JSONL line
        (``event="span"``); returns the number written.  The records stay
        (the Chrome export works afterwards)."""
        spans = self.spans
        with open(path, "a", encoding="utf-8") as f:
            for rec in spans:
                f.write(json.dumps({"event": "span", **rec}) + "\n")
        return len(spans)

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event object (Perfetto, chrome://tracing): one
        complete ("ph": "X") event a span, microseconds from the tracer's
        epoch, one track a thread with its name."""
        pid = os.getpid()
        spans = self.spans
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "torchrec_tpu_torch"}}]
        named_tids = set()
        for rec in spans:
            tid = rec["tid"]
            if tid not in named_tids:
                named_tids.add(tid)
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tid, "args": {"name": rec["thread"]}})
            ev = {
                "ph": "X",
                "name": rec["name"],
                "cat": rec["name"].split("/", 1)[0],
                "pid": pid,
                "tid": tid,
                "ts": (rec["mono"] - self._epoch) * 1e6,
                "dur": rec["dur_s"] * 1e6,
            }
            if "attrs" in rec:
                ev["args"] = rec["attrs"]
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> int:
        """Write ``chrome_trace()`` to ``path``; returns the span count."""
        trace = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        return sum(1 for e in trace["traceEvents"] if e["ph"] == "X")


# One process-global tracer (the profiler is process-global too): library
# code calls the module-level ``span()``.  Install and uninstall at run
# boundaries, not mid-step.

_ACTIVE: Optional[SpanTracer] = None


def install_tracer(tracer: SpanTracer) -> Optional[SpanTracer]:
    """Make ``tracer`` the process's span sink; returns the one installed
    before (install it again to nest scopes)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


def uninstall_tracer() -> Optional[SpanTracer]:
    """Remove the installed tracer (spans become profiler ranges alone);
    returns it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None
    return prev


def current_tracer() -> Optional[SpanTracer]:
    """The installed tracer, or None."""
    return _ACTIVE


def span(name: str, **attrs: Any):
    """A span against the installed tracer, or the profiler range alone
    when none is installed; ``attrs`` ride along as the range's argument
    string and the record's attributes."""
    tracer = _ACTIVE
    if tracer is None:
        return _RangeSpan(name, attrs or None)
    return _Span(tracer, name, attrs or None)
