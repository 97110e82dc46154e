"""MetricsRegistry — counters and fixed-bucket histograms.

The subset of ``torchrec_tpu/obs/registry.py`` that the inference server
uses: ``counter``, ``observe``, and the reads ``value`` and
``snapshot``.  Keys follow the ``<prefix>/<table>/<counter>`` namespace
(``utils.profiling.counter_key``).  A key registered as one kind raises
``ValueError`` when used as another.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# geometric-ish latency ladder in milliseconds
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class HistogramValue:
    """Fixed-bucket histogram: ``bounds`` are inclusive upper bounds; one
    implicit overflow bucket catches everything above the last.  Tracks
    sum/count/min/max."""

    __slots__ = ("bounds", "counts", "sum", "count", "min", "max")

    def __init__(self, bounds: Iterable[float]):
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def clone(self) -> "HistogramValue":
        h = HistogramValue(self.bounds)
        h.counts = list(self.counts)
        h.sum, h.count, h.min, h.max = self.sum, self.count, self.min, self.max
        return h


class MetricsRegistry:
    """Thread-safe named counters and histograms."""

    def __init__(
        self,
        default_buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS,
    ):
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}  # name -> counter|histogram
        self._values: Dict[str, Any] = {}  # float | HistogramValue
        self._default_buckets = tuple(default_buckets)

    def _bind(self, name: str, kind: str) -> None:
        prev = self._kinds.setdefault(name, kind)
        if prev != kind:
            raise ValueError(
                f"metric {name!r} already registered as {prev}, "
                f"cannot re-register as {kind}"
            )

    def counter(self, name: str, inc: float = 1.0) -> float:
        """Monotonic counter add; returns the new total."""
        with self._lock:
            self._bind(name, "counter")
            v = self._values.get(name, 0.0) + float(inc)
            self._values[name] = v
            return v

    def observe(
        self,
        name: str,
        value: float,
        buckets: Optional[Iterable[float]] = None,
    ) -> None:
        """Record one sample into the named histogram (created on first
        use with ``buckets`` or the registry default); ``buckets`` that
        disagree with an existing histogram's bounds raise."""
        with self._lock:
            self._bind(name, "histogram")
            h = self._values.get(name)
            if h is None:
                h = self._values[name] = HistogramValue(
                    buckets if buckets is not None else self._default_buckets
                )
            elif buckets is not None:
                want = tuple(sorted(float(b) for b in buckets))
                if want != h.bounds:
                    raise ValueError(
                        f"histogram {name!r} already has buckets "
                        f"{h.bounds}, cannot observe with {want}"
                    )
            h.observe(value)

    def value(self, name: str) -> float:
        """A counter's total (``KeyError`` if never incremented)."""
        with self._lock:
            v = self._values[name]
        if isinstance(v, HistogramValue):
            raise TypeError(f"{name} is a histogram; use snapshot()")
        return v

    def snapshot(self) -> Dict[str, Any]:
        """Deep-copied point-in-time state."""
        with self._lock:
            return {
                name: (v.clone() if isinstance(v, HistogramValue) else v)
                for name, v in self._values.items()
            }
