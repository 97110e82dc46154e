"""Crash flight recorder (``torchrec_tpu/obs/flight_recorder.py``, as it
is): bounded ring buffers of the run's last moments, dumped atomically
when something dies.

A worker that dies by ``StepWatchdog``'s ``os._exit``, a NaN rollback or
a SIGTERM leaves only its log; the structured telemetry (span records,
metric snapshots, step summaries) would go with the process.  The
:class:`FlightRecorder` keeps the most recent of each in fixed-size ring
buffers (``collections.deque``: telemetry degrades, never grows) and
writes the whole ring as one JSON file through a temporary name and
``os.replace``, so a reader only ever sees a complete dump.

Dump triggers:

* **NaN / bad step** and **rollback**: ``reliability.FaultTolerantTrainLoop``;
* **quarantine**: a bad step the input guardrails attributed to data;
* **watchdog expiry**: ``reliability.StepWatchdog`` dumps before its
  ``os._exit`` (the process is wedged in a collective; this is the only
  structured evidence it will leave);
* **SIGTERM/SIGINT preemption**: the train loop's preemption path;
* **autodump**: every ``autodump_interval`` recorded steps the ring is
  written again, so a SIGKILLed worker (which gets no trigger) leaves a
  dump current to its last recorded step.  ``ElasticSupervisor`` gathers
  the workers' dumps into one post-mortem bundle after a teardown.

One process-global recorder is installed at a run boundary
(:func:`install_recorder`); with none installed every hook is one
attribute read.  A tensor in a record collapses to a float when it has
one element (a read of the device's value), else to its shape and dtype.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

__all__ = [
    "FlightRecorder",
    "current_recorder",
    "install_recorder",
    "uninstall_recorder",
]


def _coerce(value: Any) -> Any:
    """Best-effort JSON-safe scalar: floats/ints/strs/bools pass, a
    one-element tensor or numpy array collapses to float, any other array
    to its shape and dtype, everything else to its ``repr`` (a dump must
    never fail because a payload was exotic)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    try:
        import numpy as np
        import torch

        if isinstance(value, torch.Tensor):
            if value.numel() == 1:
                return float(value.detach().reshape(-1)[0].item())
            return (f"<tensor shape={tuple(value.shape)} "
                    f"dtype={value.dtype}>")
        arr = np.asarray(value)
        if arr.size == 1:
            return float(arr.reshape(-1)[0])
        return f"<array shape={arr.shape} dtype={arr.dtype}>"
    except Exception:
        return repr(value)


class FlightRecorder:
    """Bounded in-memory recorder + atomic dumper.

    path: where dumps land (one file, rewritten per dump);
    capacity: ring size for spans and step summaries (metric snapshots
        keep ``capacity // 16`` — they are big rows, recent ones matter);
    meta: static identity fields stamped on every dump (rank, gen, pid);
    autodump_interval: re-persist the ring every N ``record_step`` calls
        (0 disables — event-triggered dumps only).
    """

    def __init__(
        self,
        path: str,
        capacity: int = 256,
        meta: Optional[Dict[str, Any]] = None,
        autodump_interval: int = 0,
    ):
        self.path = path
        self.meta = dict(meta or ())
        self.autodump_interval = int(autodump_interval)
        self._lock = threading.Lock()
        # dumps serialize separately from ring appends: an autodump on
        # the step thread and a watchdog/signal dump on another must
        # not interleave writes into one tmp file (same pid => same tmp
        # name) and publish torn JSON via the final rename
        self._dump_lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._steps: deque = deque(maxlen=capacity)
        self._metrics: deque = deque(maxlen=max(2, capacity // 16))
        self._events: deque = deque(maxlen=capacity)
        self._step_count = 0
        self.dump_count = 0
        self.dropped_dumps = 0
        self.last_dump_error: Optional[str] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- recording ----------------------------------------------------------

    def record_span(self, rec: Dict[str, Any]) -> None:
        """One closed span record (the ``SpanTracer._record`` shape);
        the dict is stored as-is — span records are already JSON-safe."""
        with self._lock:
            self._spans.append(rec)

    def record_step(self, step: int, **fields: Any) -> None:
        """One step summary (step number + whatever the caller knows:
        ``applied``, ``skipped``, a loss scalar).  Drives autodump."""
        rec = {"step": int(step), "t": time.time()}
        for k, v in fields.items():
            rec[k] = _coerce(v)
        with self._lock:
            self._steps.append(rec)
            self._step_count += 1
            do_dump = (
                self.autodump_interval > 0
                and self._step_count % self.autodump_interval == 0
            )
        if do_dump:
            self.dump("autodump")

    def record_metrics(
        self, flat: Dict[str, Any], step: Optional[int] = None
    ) -> None:
        """One flat metrics snapshot (``MetricsRegistry.flat()``)."""
        rec: Dict[str, Any] = {"t": time.time()}
        if step is not None:
            rec["step"] = int(step)
        rec["metrics"] = {k: _coerce(v) for k, v in flat.items()}
        with self._lock:
            self._metrics.append(rec)

    def note(self, kind: str, **fields: Any) -> None:
        """A discrete event worth keeping (bad step, drift alert,
        watchdog expiry) — the recorder's analogue of an EventLog line."""
        rec: Dict[str, Any] = {"kind": kind, "t": time.time()}
        for k, v in fields.items():
            rec[k] = _coerce(v)
        with self._lock:
            self._events.append(rec)

    # -- reads --------------------------------------------------------------

    def last_step(self) -> Optional[int]:
        """The most recent recorded step number (None when no steps)."""
        with self._lock:
            return self._steps[-1]["step"] if self._steps else None

    def snapshot(self) -> Dict[str, Any]:
        """The full dump payload as a dict (what ``dump`` serializes)."""
        with self._lock:
            return {
                "meta": dict(self.meta, pid=os.getpid()),
                "t": time.time(),
                "last_step": (
                    self._steps[-1]["step"] if self._steps else None
                ),
                "steps": list(self._steps),
                "spans": list(self._spans),
                "metrics": list(self._metrics),
                "events": list(self._events),
                "dump_count": self.dump_count,
            }

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str) -> Optional[str]:
        """Atomically persist the rings (tmp + ``os.replace``); returns
        the path, or None when the write failed.  Never raises: the
        callers are crash paths (watchdog expiry, signal handlers) where
        a secondary exception would mask the primary failure — a failed
        dump is counted and kept on ``last_dump_error`` instead."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with self._dump_lock:
                # snapshot INSIDE the dump lock: taken outside, a
                # descheduled autodump could publish its OLDER snapshot
                # over a newer watchdog/sigterm dump and erase the
                # crash evidence the rename just landed
                body = self.snapshot()
                body["reason"] = reason
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(body, f, default=_coerce)
                os.replace(tmp, self.path)
        except Exception as e:  # noqa: BLE001 — crash-path contract:
            # any serialization surprise (unJSONable dict KEYS bypass
            # `default=`, OSError, recursion) must be recorded, never
            # raised into a watchdog/signal handler
            with self._lock:
                self.dropped_dumps += 1
                self.last_dump_error = f"{type(e).__name__}: {e}"
            return None
        with self._lock:
            # under the ring lock: snapshot() reads dump_count there,
            # and concurrent watchdog + sigterm dumps both land here
            self.dump_count += 1
        return self.path

    @staticmethod
    def read_dump(path: str) -> Dict[str, Any]:
        """Load a dump file (the post-mortem harvester's reader)."""
        with open(path, encoding="utf-8") as f:
            return json.load(f)


# -- the installed recorder --------------------------------------------------
#
# Same contract as the span tracer's process-global: install at a run
# boundary, one attribute read on every hook when disabled.

_ACTIVE: Optional[FlightRecorder] = None


def install_recorder(recorder: FlightRecorder) -> Optional[FlightRecorder]:
    """Make ``recorder`` the process-global crash sink; returns the
    previously installed one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = recorder
    return prev


def uninstall_recorder() -> Optional[FlightRecorder]:
    """Remove the active recorder (hooks become no-ops); returns it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None
    return prev


def current_recorder() -> Optional[FlightRecorder]:
    """The installed recorder, or None when crash recording is off."""
    return _ACTIVE


def dump_all(reason: str) -> Optional[str]:
    """Dump the installed recorder if any (the one-line crash hook)."""
    rec = _ACTIVE
    if rec is None:
        return None
    return rec.dump(reason)
