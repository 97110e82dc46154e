"""MetricsRegistry — counters, gauges, fixed-bucket histograms
(``torchrec_tpu/obs/registry.py``, whole).

One registry absorbs ``scalar_metrics()``-shaped surfaces under the
``<prefix>/<table>/<counter>`` namespace (``utils.profiling.counter_key``)
and serves three consumers:

* **Prometheus text exposition** (``to_prometheus``) — the
  ``HttpInferenceServer`` ``/metrics`` endpoint; 3-segment keys become
  ``<prefix>_<counter>{table="<table>"}`` families so one family
  aggregates across tables;
* **periodic JSONL dumps** (``dump_jsonl``);
* **snapshot/delta** — rate computation over any window without
  resetting the source counters.

Histograms are fixed-bucket (``DEFAULT_LATENCY_BUCKETS_MS``): p50/p99
come from bucket interpolation, so observation cost is one bisect + two
adds — no per-sample storage on the serving hot path.  The serving mesh
reads its hedging delay from ``quantiles``.

Collision semantics: a key registered as one kind (counter/gauge/
histogram) raises ``ValueError`` when re-registered as another.
Absorbing the SAME key from two surfaces of the same kind merges (gauge:
last write wins; counter: monotonic max).
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_MS",
    "HistogramValue",
    "MetricsRegistry",
]

# geometric-ish latency ladder in milliseconds: sub-ms serving hits
# through multi-second checkpoint saves
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class HistogramValue:
    """Fixed-bucket histogram: ``bounds`` are inclusive upper bounds;
    one implicit overflow bucket catches everything above the last.
    Tracks sum/count/min/max so means and tail quantiles stay honest at
    the edges (quantiles clamp to the observed range)."""

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
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in [0, 1]; NaN when empty."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                # bucket i covers (bounds[i-1], bounds[i]]; clamp both
                # ends to the observed range — the edge buckets are
                # half-open and tails must never report beyond what was
                # actually seen
                lo = self.bounds[i - 1] if i > 0 else -math.inf
                hi = self.bounds[i] if i < len(self.bounds) else math.inf
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                frac = (target - cum) / c
                return lo + frac * max(0.0, hi - lo)
            cum += c
        return self.max

    def merge(self, other: "HistogramValue") -> None:
        """Accumulate another histogram with IDENTICAL bounds."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"histogram bucket mismatch: {other.bounds} vs {self.bounds}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def clone(self) -> "HistogramValue":
        h = HistogramValue(self.bounds)
        h.counts = list(self.counts)
        h.sum, h.count, h.min, h.max = self.sum, self.count, self.min, self.max
        return h


class MetricsRegistry:
    """Thread-safe named metrics in the ``<prefix>/<table>/<counter>``
    namespace.  See module docstring for the consumer surfaces and the
    merge/collision contract.  ``default_buckets`` are the histogram
    bounds ``observe`` uses when a histogram's first observation does
    not name its own."""

    def __init__(
        self,
        default_buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS,
    ):
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}  # name -> counter|gauge|histogram
        self._values: Dict[str, Any] = {}  # float | HistogramValue
        self._default_buckets = tuple(default_buckets)

    # -- registration / update ---------------------------------------------

    def _bind(self, name: str, kind: str) -> None:
        prev = self._kinds.get(name)
        if prev is None:
            self._kinds[name] = kind
        elif prev != kind:
            raise ValueError(
                f"metric {name!r} already registered as {prev}, "
                f"cannot re-register as {kind} — the "
                "<prefix>/<table>/<counter> namespace is shared; pick "
                "a different counter name"
            )

    def counter(self, name: str, inc: float = 1.0) -> float:
        """Monotonic counter add; returns the new total."""
        with self._lock:
            self._bind(name, "counter")
            v = self._values.get(name, 0.0) + float(inc)
            self._values[name] = v
            return v

    def counter_set(self, name: str, total: float) -> float:
        """Set a counter to an externally-accumulated cumulative total
        (monotonic: keeps the max of current and ``total`` — absorbing
        module- and collection-level exports of the same source twice
        must not double-count or rewind)."""
        with self._lock:
            self._bind(name, "counter")
            v = max(self._values.get(name, 0.0), float(total))
            self._values[name] = v
            return v

    def gauge(self, name: str, value: float) -> None:
        """Point-in-time value; last write wins."""
        with self._lock:
            self._bind(name, "gauge")
            self._values[name] = float(value)

    def observe(
        self,
        name: str,
        value: float,
        buckets: Optional[Iterable[float]] = None,
    ) -> None:
        """Record one sample into the named fixed-bucket histogram
        (created on first use with ``buckets`` or the registry
        default).  Explicit ``buckets`` that disagree with an existing
        histogram's bounds raise — two call sites silently sharing the
        first one's ladder would quantize one of them on the wrong
        scale (the same loud-collision contract as kind mismatches)."""
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

    def absorb(self, scalars: Mapping[str, float], kind: str = "gauge") -> None:
        """Merge a ``scalar_metrics()``-shaped flat dict.  ``kind`` is
        how the absorbed keys register: "gauge" (last write wins — the
        right default for cumulative-from-source snapshots that only
        ever move forward together) or "counter" (monotonic max)."""
        if kind not in ("gauge", "counter"):
            raise ValueError(f"absorb kind must be gauge|counter, got {kind!r}")
        for k, v in scalars.items():
            if kind == "gauge":
                self.gauge(k, v)
            else:
                self.counter_set(k, v)

    # -- reads --------------------------------------------------------------

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def value(self, name: str) -> float:
        """Scalar value of a counter/gauge (KeyError if unknown)."""
        with self._lock:
            v = self._values[name]
        if isinstance(v, HistogramValue):
            raise TypeError(f"{name} is a histogram; use histogram()")
        return v

    def histogram(self, name: str) -> HistogramValue:
        with self._lock:
            v = self._values[name]
            kind = self._kinds[name]
        if not isinstance(v, HistogramValue):
            raise TypeError(f"{name} is a {kind}, not a histogram")
        return v

    def quantiles(
        self, name: str, qs: Iterable[float] = (0.5, 0.99)
    ) -> Tuple[float, ...]:
        """Bucket-interpolated quantiles of the named histogram in one
        consistent read (cloned under the lock — a concurrent observe
        cannot tear the p50 against the p99); the serving SLO surface
        (``bench.py --mode serving`` reads p50/p99 here)."""
        with self._lock:
            v = self._values[name]
            if not isinstance(v, HistogramValue):
                raise TypeError(
                    f"{name} is a {self._kinds[name]}, not a histogram"
                )
            h = v.clone()
        return tuple(h.quantile(float(q)) for q in qs)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._values)

    def _consistent_items(self) -> List[Tuple[str, Any]]:
        """(name, value) pairs with histograms CLONED under the lock —
        readers must never iterate a live HistogramValue a concurrent
        observe() is mutating (a torn read shows a cumulative bucket
        above its own _count: an invalid exposition)."""
        with self._lock:
            return [
                (n, v.clone() if isinstance(v, HistogramValue) else v)
                for n, v in self._values.items()
            ]

    def flat(self) -> Dict[str, float]:
        """Every metric as flat floats: counters/gauges verbatim,
        histograms expanded to p50/p99/count/sum/mean sub-keys."""
        items = self._consistent_items()
        out: Dict[str, float] = {}
        for name, v in items:
            if isinstance(v, HistogramValue):
                out[f"{name}/p50"] = v.quantile(0.5)
                out[f"{name}/p99"] = v.quantile(0.99)
                out[f"{name}/count"] = float(v.count)
                out[f"{name}/sum"] = v.sum
                out[f"{name}/mean"] = v.sum / v.count if v.count else math.nan
            else:
                out[name] = v
        return out

    # -- snapshot / delta ---------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Deep-copied point-in-time state, suitable for ``delta``."""
        with self._lock:
            return {
                name: (v.clone() if isinstance(v, HistogramValue) else v)
                for name, v in self._values.items()
            }

    def delta(self, prev: Mapping[str, Any]) -> Dict[str, float]:
        """Flat change since ``prev`` (a ``snapshot()``): counters and
        histogram counts/sums as differences, gauges as current values —
        rate computation over a window without resetting sources."""
        cur = self.snapshot()
        with self._lock:
            kinds = dict(self._kinds)
        out: Dict[str, float] = {}
        for name, v in cur.items():
            p = prev.get(name)
            if isinstance(v, HistogramValue):
                pc = p.count if isinstance(p, HistogramValue) else 0
                ps = p.sum if isinstance(p, HistogramValue) else 0.0
                out[f"{name}/count"] = float(v.count - pc)
                out[f"{name}/sum"] = v.sum - ps
            elif kinds.get(name) == "counter":
                out[name] = v - (p if isinstance(p, (int, float)) else 0.0)
            else:
                out[name] = v
        return out

    # -- exports ------------------------------------------------------------

    def dump_jsonl(
        self,
        path: str,
        step: Optional[int] = None,
        extra: Optional[Mapping[str, Any]] = None,
        flat: Optional[Mapping[str, float]] = None,
    ) -> None:
        """Append one ``{"t", "step", "metrics": {...flat...}}`` line —
        the periodic machine-readable dump the train loop writes and
        ``obs report`` consumes.  ``flat``: a caller-precomputed
        :meth:`flat` result to reuse (the telemetry tick shares one
        flatten across its dump/recorder consumers instead of
        recomputing histogram quantiles per consumer)."""
        rec: Dict[str, Any] = {"t": time.time()}
        if step is not None:
            rec["step"] = int(step)
        if extra:
            rec.update(extra)
        # non-finite values (a NaN-injected step's loss gauge) become
        # null: bare NaN/Infinity tokens are not RFC JSON and break
        # strict consumers of this machine-readable stream
        rec["metrics"] = {
            k: (v if math.isfinite(v) else None)
            for k, v in (self.flat() if flat is None else flat).items()
        }
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, default=str) + "\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4).

        3-segment ``<prefix>/<table>/<counter>`` keys become one family
        ``<prefix>_<counter>`` with a ``table`` label; other keys
        flatten with ``_``.  Histograms emit the standard cumulative
        ``_bucket{le=...}`` / ``_sum`` / ``_count`` series."""
        items = sorted(self._consistent_items())
        with self._lock:
            kinds = dict(self._kinds)
        families: Dict[str, List[Tuple[Dict[str, str], Any, str]]] = {}
        for name, v in items:
            fam, labels = _expo_name(name)
            families.setdefault(fam, []).append((labels, v, kinds[name]))
        lines: List[str] = []
        for fam, series in families.items():
            kind_set = {k for _, _, k in series}
            kind = kind_set.pop() if len(kind_set) == 1 else "untyped"
            lines.append(f"# TYPE {fam} {kind}")
            for labels, v, _k in series:
                if isinstance(v, HistogramValue):
                    cum = 0
                    for bound, c in zip(v.bounds, v.counts):
                        cum += c
                        lines.append(
                            f"{fam}_bucket{_labels(labels, le=_fmt(bound))}"
                            f" {cum}"
                        )
                    lines.append(
                        f"{fam}_bucket{_labels(labels, le='+Inf')} {v.count}"
                    )
                    lines.append(f"{fam}_sum{_labels(labels)} {_fmt(v.sum)}")
                    lines.append(f"{fam}_count{_labels(labels)} {v.count}")
                else:
                    lines.append(f"{fam}{_labels(labels)} {_fmt(v)}")
        return "\n".join(lines) + "\n"


# -- prometheus helpers ------------------------------------------------------

_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def _seg(s: str) -> str:
    s = _BAD_CHARS.sub("_", s)
    return s or "_"


def _expo_name(key: str) -> Tuple[str, Dict[str, str]]:
    """Metric key -> (exposition family name, labels)."""
    parts = key.split("/")
    if len(parts) == 3:
        name, labels = f"{_seg(parts[0])}_{_seg(parts[2])}", {"table": parts[1]}
    else:
        name, labels = "_".join(_seg(p) for p in parts), {}
    if name[0].isdigit():
        name = f"m_{name}"
    return name, labels


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: Dict[str, str], **extra: str) -> str:
    merged = {**labels, **extra}
    if not merged:
        return ""
    body = ",".join(f'{_seg(k)}="{_esc(v)}"' for k, v in merged.items())
    return "{" + body + "}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return f"{float(v):.10g}"
