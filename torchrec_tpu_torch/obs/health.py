"""Streaming health monitoring: live drift against the plan's assumptions
(``torchrec_tpu/obs/health.py``).

A :class:`HealthMonitor` reads the run's ``MetricsRegistry`` at the
metric cadence, derives per-table live signals (the occupancy rate, the
cache hit rate over the check window from counter deltas, the vocabulary
churn, the wire bytes of each link class) and scores each against the
:class:`~torchrec_tpu_torch.obs.assumptions.PlanAssumptions` the planner
stamped on the plan.

An alarm needs three rules to hold for ``min_consecutive`` checks in a
row (a bias to no false alarm):

* **EWMA**: the live signal is smoothed (``alpha``), so one noisy batch
  trips nothing;
* **absolute threshold**: ``|ewma - expected| > abs_tol``;
* **windowed z-score**: the deviation also exceeds ``z_threshold``
  standard deviations of the detector's first ``warmup`` samples, so a
  signal that is always noisy at the tolerance's scale cannot alarm on
  its noise.

The scores are exported as ``health/<table>/<signal>_drift`` (deviation
over tolerance: >= 1 means the absolute rule tripped) with ``_live``,
``_expected`` and ``_alarm`` beside them, through the registry's
Prometheus and JSONL paths.  A check costs one ``registry.flat()`` and a
few lookups.  Alarm onsets also go to the installed flight recorder and
to the ``on_alarm`` callbacks (the plan migrator's trigger,
``reliability/migration.py``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

from torchrec_tpu_torch.obs import flight_recorder as _flight
from torchrec_tpu_torch.obs.assumptions import PlanAssumptions

__all__ = [
    "DriftAlert",
    "DriftDetector",
    "HealthMonitor",
]

#: Sigma floor for the z-rule: a deterministic warmup (zero variance)
#: must not make every later deviation infinitely significant.
_SIGMA_FLOOR = 1e-6


@dataclasses.dataclass
class DriftAlert:
    """One alarm onset: ``table``'s ``signal`` left its plan-time
    envelope at ``step`` (the first check where all three rules held
    ``min_consecutive`` times).  ``expected`` is the plan-time value,
    ``observed`` the live EWMA at alarm time, ``score`` the
    deviation/tolerance ratio (>= 1 by construction), and ``z`` the
    deviation in baseline standard deviations."""

    table: str
    signal: str
    step: Optional[int]
    expected: float
    observed: float  # the EWMA at alarm time
    score: float  # |deviation| / abs_tol (>= 1 by construction)
    z: float


class DriftDetector:
    """EWMA + warmup-baseline z-score + absolute threshold for one
    (table, signal) stream; see the module docstring for the rules.

    ``expected`` is the plan-time value deviations are measured from;
    ``abs_tol`` the absolute-deviation threshold; ``z_threshold`` the
    deviation bound in baseline sigmas; ``alpha`` the EWMA smoothing
    weight of the newest sample; ``warmup`` how many leading samples
    establish the baseline sigma (no alarms during warmup); and
    ``min_consecutive`` how many consecutive tripped checks an alarm
    onset requires."""

    def __init__(
        self,
        expected: float,
        abs_tol: float = 0.15,
        z_threshold: float = 4.0,
        alpha: float = 0.3,
        warmup: int = 8,
        min_consecutive: int = 3,
    ):
        self.expected = float(expected)
        self.abs_tol = float(abs_tol)
        self.z_threshold = float(z_threshold)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.min_consecutive = int(min_consecutive)
        self.ewma: Optional[float] = None
        self.baseline_sigma: Optional[float] = None
        self.ticks = 0
        self._warm: List[float] = []
        self._consecutive = 0
        self.alarmed = False  # current alarm state (not latched)

    def update(self, value: float) -> Tuple[float, float, bool]:
        """Fold one live sample; returns ``(score, z, newly_alarmed)``
        — ``newly_alarmed`` is True only on the tick the alarm turns
        on, so callers count alarm ONSETS, not alarm duration."""
        v = float(value)
        self.ticks += 1
        self.ewma = (
            v
            if self.ewma is None
            else self.alpha * v + (1.0 - self.alpha) * self.ewma
        )
        if self.ticks <= self.warmup:
            self._warm.append(v)
            if self.ticks == self.warmup:
                mean = sum(self._warm) / len(self._warm)
                var = sum((x - mean) ** 2 for x in self._warm) / len(
                    self._warm
                )
                self.baseline_sigma = math.sqrt(var)
            return self.score, 0.0, False
        dev = self.ewma - self.expected
        sigma = max(self.baseline_sigma or 0.0, _SIGMA_FLOOR)
        z = dev / sigma
        tripped = (
            abs(dev) > self.abs_tol and abs(z) > self.z_threshold
        )
        self._consecutive = self._consecutive + 1 if tripped else 0
        was = self.alarmed
        self.alarmed = self._consecutive >= self.min_consecutive
        return self.score, z, self.alarmed and not was

    @property
    def score(self) -> float:
        """|EWMA deviation| / abs_tol — >= 1 means the absolute rule is
        tripped (0 before the first sample)."""
        if self.ewma is None:
            return 0.0
        return abs(self.ewma - self.expected) / max(self.abs_tol, 1e-12)


# -- live-signal extraction ---------------------------------------------------
#
# The monitor reads the same flat keys `obs report --placement-features`
# mines: point-in-time occupancy-rate gauges where a surface exports
# one, windowed hit rates recomputed from cumulative counter deltas
# (rate over the check window, without resetting any source).

_HIT_RATE_PREFIXES = ("tiered", "serving_cache", "mch")

# counter families carrying per-table insert/eviction churn — MPZCH
# managed-collision modules and the dynamic-vocab admission layer
_CHURN_PREFIXES = ("mch", "vocab")


def _live_occupancy(
    flat: Dict[str, float], table: str, feature_names=()
) -> Optional[float]:
    """Real-ids-per-slot occupancy of this table's id stream — ONLY
    from sources that share ``expected_occupancy``'s padding-efficiency
    semantics: the per-key KJT occupancy gauges and the bucketing
    mean-occupancy/static-cap ratio.  (The ``tiered``/``serving_cache``
    ``occupancy_rate`` exports measure CACHE-FILL fraction, which
    saturates at 1.0 in LFU steady state — a different quantity, so
    feeding it here would alarm on every healthy cached table.)  The
    per-key gauges are FEATURE-keyed, so the lookup tries the table
    name plus every feature the assumptions say route to it."""
    for name in (table, *feature_names):
        v = flat.get(f"kjt/{name}/occupancy_rate")
        if v is not None and math.isfinite(v):
            return float(v)
        occ = flat.get(f"bucketing/{name}/mean_occupancy")
        cap = flat.get(f"bucketing/{name}/mean_static_cap")
        if occ is not None and cap:
            return float(occ) / float(cap)
    return None


def _live_hit_rate(
    flat: Dict[str, float],
    prev: Dict[str, float],
    table: str,
    min_window_lookups: int,
) -> Optional[float]:
    """Windowed hit rate from counter deltas since the previous check;
    None when NO counter family saw enough lookups this window to
    judge (a noisy micro-window must not feed the detector).  All
    ``_HIT_RATE_PREFIXES`` families are tried — a table exported under
    two surfaces must not go blind because the first one is idle."""
    for prefix in _HIT_RATE_PREFIXES:
        lk = f"{prefix}/{table}/lookup_count"
        cur = flat.get(lk)
        if cur is None:
            continue
        d_lookups = cur - prev.get(lk, 0.0)
        hk = f"{prefix}/{table}/hit_count"
        d_hits = flat.get(hk, 0.0) - prev.get(hk, 0.0)
        if d_lookups >= min_window_lookups and d_hits >= 0.0:
            return min(1.0, d_hits / d_lookups)
    return None


def _live_churn_rate(
    flat: Dict[str, float],
    prev: Dict[str, float],
    table: str,
    min_window_lookups: int,
) -> Optional[float]:
    """Windowed vocab-churn rate — (inserts + evictions) per lookup
    since the previous check — from the MPZCH / dynamic-vocab counter
    families.  A healthy steady-state table churns near zero; a drifted
    id stream (new campaign, upstream remap bug, vocab-drift fault
    injection) shows up here before hit-rate collapses.  None when no
    family saw enough lookups this window (same gating as the hit-rate
    signal: a noisy micro-window must not feed the detector)."""
    for prefix in _CHURN_PREFIXES:
        lk = f"{prefix}/{table}/lookup_count"
        cur = flat.get(lk)
        if cur is None:
            continue
        d_lookups = cur - prev.get(lk, 0.0)
        d_churn = 0.0
        for counter in ("insert_count", "eviction_count"):
            ck = f"{prefix}/{table}/{counter}"
            d_churn += flat.get(ck, 0.0) - prev.get(ck, 0.0)
        if d_lookups >= min_window_lookups and d_churn >= 0.0:
            return min(1.0, d_churn / d_lookups)
    return None


class HealthMonitor:
    """Periodic drift checks of a live ``MetricsRegistry`` against the
    plan's :class:`PlanAssumptions`.

    Call :meth:`observe` at metric-collection cadence (the train loop's
    ``attach_health`` wires it into ``attach_telemetry``'s interval);
    each call reads one registry snapshot, updates every detector, and
    writes the ``health/*`` gauges back into the same registry so the
    Prometheus / JSONL / report paths pick them up for free.  Alerts
    are also noted into the installed flight recorder, so a post-mortem
    dump shows the drift that preceded a crash.

    abs_tol / z_threshold / alpha / warmup / min_consecutive configure
    every detector (see :class:`DriftDetector`); ``wire_ratio_tol`` is
    the absolute tolerance on the live/expected wire-bytes *ratio*
    (1.0 = alarm past 2x or below 0x); ``min_window_lookups`` gates the
    windowed hit-rate signal; ``churn_tol`` is the absolute tolerance
    on the vocab-churn rate around its expected-zero steady state (the
    MPZCH / dynamic-vocab insert+eviction counters).
    """

    # flat detector knobs mirror DriftDetector's surface 1:1; a config
    # object would just rename them
    def __init__(  # the detectors' knobs, one for one
        self,
        registry: Any,
        assumptions: PlanAssumptions,
        abs_tol: float = 0.15,
        z_threshold: float = 4.0,
        alpha: float = 0.3,
        warmup: int = 8,
        min_consecutive: int = 3,
        wire_ratio_tol: float = 1.0,
        min_window_lookups: int = 32,
        churn_tol: float = 0.25,
    ):
        self.registry = registry
        self.assumptions = assumptions
        self.abs_tol = abs_tol
        self.z_threshold = z_threshold
        self.alpha = alpha
        self.warmup = warmup
        self.min_consecutive = min_consecutive
        self.wire_ratio_tol = wire_ratio_tol
        self.min_window_lookups = min_window_lookups
        self.churn_tol = churn_tol
        self._detectors: Dict[Tuple[str, str], DriftDetector] = {}
        self._prev_flat: Dict[str, float] = {}
        self.alerts: List[DriftAlert] = []
        self._alarm_callbacks: List[Any] = []
        self.checks = 0
        self.overhead_seconds = 0.0

    # -- programmatic alarm surface ------------------------------------------

    def on_alarm(self, callback) -> None:
        """Register ``callback(alert: DriftAlert)`` to fire on alarm
        ONSETS — exactly once per persistence-crossing of a (table,
        signal) detector, not once per alarmed tick (the detector's
        ``newly_alarmed`` edge).  A signal that recovers and drifts out
        again crosses again and fires again.  This is the edge-triggered
        surface the migration trigger policy (and any pager integration)
        consumes; the ``health/*/_alarm`` gauges remain the level-
        triggered export.  Callbacks run synchronously on the
        ``observe`` caller's thread; their exceptions propagate (a
        broken trigger must surface, not silently disarm migration)."""
        self._alarm_callbacks.append(callback)

    def alarmed(self) -> bool:
        """Level-triggered view: is ANY (table, signal) detector
        currently in its alarmed state?  The hysteresis check trigger
        policies pair with the edge-triggered ``on_alarm``."""
        return any(d.alarmed for d in self._detectors.values())

    def live_signals(self) -> Dict[str, Dict[str, float]]:
        """Current live EWMA per (table, signal), shaped for
        ``EstimatorContext.from_telemetry`` ({table: {"occupancy": ...,
        "hit_rate": ...}}): what a replan should price with instead of
        the plan-time beliefs.  Detectors that have not yet folded a
        sample are omitted; the ``link:*`` wire-ratio detectors ride
        along under their ``link:`` keys for callers that want them."""
        out: Dict[str, Dict[str, float]] = {}
        for (table, signal), det in self._detectors.items():
            if det.ewma is not None:
                out.setdefault(table, {})[signal] = float(det.ewma)
        return out

    # -- detectors -----------------------------------------------------------

    def _detector(
        self, table: str, signal: str, expected: float, abs_tol: float
    ) -> DriftDetector:
        det = self._detectors.get((table, signal))
        if det is None:
            det = self._detectors[(table, signal)] = DriftDetector(
                expected,
                abs_tol=abs_tol,
                z_threshold=self.z_threshold,
                alpha=self.alpha,
                warmup=self.warmup,
                min_consecutive=self.min_consecutive,
            )
        return det

    def _check(
        self,
        table: str,
        signal: str,
        expected: float,
        live: float,
        step: Optional[int],
        out: List[DriftAlert],
        abs_tol: Optional[float] = None,
    ) -> None:
        from torchrec_tpu_torch.utils.profiling import counter_key

        det = self._detector(
            table, signal, expected,
            self.abs_tol if abs_tol is None else abs_tol,
        )
        score, z, newly = det.update(live)
        reg = self.registry
        reg.gauge(counter_key("health", table, f"{signal}_drift"), score)
        reg.gauge(counter_key("health", table, f"{signal}_live"), det.ewma)
        reg.gauge(counter_key("health", table, f"{signal}_expected"),
                  expected)
        reg.gauge(
            counter_key("health", table, f"{signal}_alarm"),
            1.0 if det.alarmed else 0.0,
        )
        if newly:
            out.append(
                DriftAlert(
                    table=table,
                    signal=signal,
                    step=step,
                    expected=expected,
                    observed=float(det.ewma),
                    score=score,
                    z=z,
                )
            )

    # -- the periodic check --------------------------------------------------

    def observe(self, step: Optional[int] = None) -> List[DriftAlert]:
        """One health check: returns the alarm ONSETS this check
        produced (empty on a healthy tick)."""
        t0 = time.perf_counter()
        flat = self.registry.flat()
        new_alerts: List[DriftAlert] = []
        # the first check has no previous snapshot: a delta against 0
        # would be the LIFETIME aggregate (cold-start misses included),
        # and that outlier would poison the detectors' baseline sigma —
        # the windowed hit-rate signal starts on check 2
        first_check = self.checks == 0
        for table, ta in self.assumptions.tables.items():
            occ = _live_occupancy(flat, table, ta.feature_names)
            if occ is not None:
                self._check(
                    table, "occupancy", ta.expected_occupancy, occ,
                    step, new_alerts,
                )
            if ta.expected_hit_rate is not None and not first_check:
                hr = _live_hit_rate(
                    flat, self._prev_flat, table, self.min_window_lookups
                )
                if hr is not None:
                    self._check(
                        table, "hit_rate", ta.expected_hit_rate, hr,
                        step, new_alerts,
                    )
            if not first_check:
                # churn's expectation is steady-state zero: admissions
                # and evictions should be rare once the hot set is
                # resident, so the detector alarms on sustained churn
                # above churn_tol — the drift signature of a sliding or
                # corrupted id stream
                churn = _live_churn_rate(
                    flat, self._prev_flat, table, self.min_window_lookups
                )
                if churn is not None:
                    self._check(
                        table, "churn", 0.0, churn,
                        step, new_alerts, abs_tol=self.churn_tol,
                    )
        for link, expected_bytes in sorted(
            self.assumptions.wire_bytes_per_step.items()
        ):
            if expected_bytes <= 0:
                continue
            live = flat.get(f"wire/link:{link}/bytes_per_step")
            if live is None:
                continue
            self._check(
                f"link:{link}", "wire_ratio", 1.0,
                float(live) / expected_bytes, step, new_alerts,
                abs_tol=self.wire_ratio_tol,
            )
        self.checks += 1
        self._prev_flat = flat
        reg = self.registry
        reg.counter("health/monitor/check_count")
        if new_alerts:
            reg.counter("health/monitor/alert_count", len(new_alerts))
            self.alerts.extend(new_alerts)
            rec = _flight.current_recorder()
            if rec is not None:
                for a in new_alerts:
                    rec.note("drift_alert", **dataclasses.asdict(a))
            for cb in self._alarm_callbacks:
                for a in new_alerts:
                    cb(a)
        if step is not None:
            reg.gauge("health/monitor/last_check_step", float(step))
        self.overhead_seconds += time.perf_counter() - t0
        reg.gauge("health/monitor/overhead_s", self.overhead_seconds)
        return new_alerts

    # -- summaries -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Structured state for reports/benches: per-(table, signal)
        expected/ewma/score/alarm plus run counters."""
        tables: Dict[str, Dict[str, Any]] = {}
        for (table, signal), det in sorted(self._detectors.items()):
            tables.setdefault(table, {})[signal] = {
                "expected": det.expected,
                "live": det.ewma,
                "score": round(det.score, 4),
                "alarm": det.alarmed,
            }
        return {
            "checks": self.checks,
            "alerts": len(self.alerts),
            "overhead_s": self.overhead_seconds,
            "plan_assumptions": self.assumptions.fingerprint(),
            "tables": tables,
        }
