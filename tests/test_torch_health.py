"""The port's drift monitor (``torchrec_tpu_torch/obs/health.py``)
against the JAX package's (``torchrec_tpu/obs/health.py``).

Both are host arithmetic over a metrics registry: fed the same samples
(the same registry writes, in the same order), the port's
``DriftDetector`` scores and z values, and ``HealthMonitor``'s alert
onsets, level state, ``live_signals``, ``summary`` and the ``health/*``
gauges it writes back, are equal to the JAX package's, ``==`` on every
float (the same float64 operations in the same order).  The live inputs
come from the port's own counter surfaces where they exist (the tiered
collection's ``TieredStats``, the KJT occupancy gauges).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from torchrec_tpu.obs import HealthMonitor as JMonitor
from torchrec_tpu.obs import MetricsRegistry as JRegistry
from torchrec_tpu.obs import PlanAssumptions as JPlan
from torchrec_tpu.obs import TableAssumptions as JTable
from torchrec_tpu.obs.health import DriftDetector as JDetector
from torchrec_tpu_torch.obs import (
    DriftDetector,
    HealthMonitor,
    MetricsRegistry,
    PlanAssumptions,
    TableAssumptions,
)
from torchrec_tpu_torch.obs import flight_recorder
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor
from torchrec_tpu_torch.utils.profiling import TieredStats, counter_key

KNOBS = dict(warmup=4, min_consecutive=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("knobs", [
    dict(), dict(abs_tol=0.05, z_threshold=2.0, alpha=0.5, warmup=3,
                 min_consecutive=1)], ids=["default", "tight"])
def test_detector_scores_equal_jax(seed, knobs):
    """A noisy signal that steps away from its expectation halfway: every
    update's (score, z, onset), the EWMA, sigma and alarm state equal."""
    rng = np.random.RandomState(seed)
    xs = np.concatenate([0.9 + 0.01 * rng.randn(20),
                         0.4 + 0.01 * rng.randn(20)])
    a, b = DriftDetector(0.9, **knobs), JDetector(0.9, **knobs)
    onsets = 0
    for x in xs:
        ra, rb = a.update(float(x)), b.update(float(x))
        assert ra == rb
        assert (a.ewma, a.baseline_sigma, a.alarmed) == (
            b.ewma, b.baseline_sigma, b.alarmed)
        onsets += ra[2]
    assert onsets >= 1
    assert a.score == b.score


def _plans(**table_kw):
    kw = dict(expected_occupancy=0.9, expected_hit_rate=0.6,
              feature_names=["f0"], **table_kw)
    wire = {"ici": 1000.0}
    return (PlanAssumptions(tables={"t0": TableAssumptions(**kw)},
                            wire_bytes_per_step=wire),
            JPlan(tables={"t0": JTable(**kw)}, wire_bytes_per_step=wire))


def _feed(regs, occ, hits, lookups, churn, wire):
    """One tick's samples into every registry, the same writes in the
    same order: the KJT occupancy gauge, the tiered counters (as
    ``TieredStats`` exports them), the vocab churn counters, the wire
    bytes."""
    stats = TieredStats()
    stats.record_capacity("t0", 64)
    stats.record_remap("t0", lookups, hits, lookups - hits, 0, 64)
    flat = {k: v for k, v in stats.scalar_metrics("tiered").items()
            if k.startswith("tiered/t0/")}
    for reg in regs:
        reg.gauge(counter_key("kjt", "f0", "occupancy_rate"), occ)
        for k in ("lookup_count", "hit_count"):
            reg.counter(counter_key("tiered", "t0", k),
                        flat[counter_key("tiered", "t0", k)])
        reg.counter(counter_key("vocab", "t0", "lookup_count"), lookups)
        reg.counter(counter_key("vocab", "t0", "insert_count"), churn)
        reg.gauge("wire/link:ici/bytes_per_step", wire)


def _health_gauges(flat):
    return {k: v for k, v in flat.items() if k.startswith("health/")
            and not k.endswith("overhead_s")}


def test_monitor_alerts_equal_jax():
    """Occupancy, hit-rate, churn and wire-ratio drifts in turn: the same
    alert onsets at the same steps, the same level state and live
    signals at every tick, the same gauges and summary."""
    plan, jplan = _plans()
    reg, jreg = MetricsRegistry(), JRegistry()
    mon = HealthMonitor(reg, plan, **KNOBS)
    jmon = JMonitor(jreg, jplan, **KNOBS)
    seen = []
    mon.on_alarm(seen.append)
    rng = np.random.RandomState(0)
    for step in range(48):
        occ = 0.9 if step < 12 else 0.3
        hit = 0.6 if step < 20 else 0.1
        churn = 2 if step < 28 else 90
        wire = 1000.0 if step < 36 else 4000.0
        lookups = 200 + int(rng.randint(0, 20))
        _feed((reg, jreg), occ + 0.01 * rng.randn(),
              int(lookups * (hit + 0.02 * rng.randn())), lookups, churn, wire)
        a, b = mon.observe(step=step), jmon.observe(step=step)
        assert [dataclasses.asdict(x) for x in a] == [
            dataclasses.asdict(x) for x in b]
        assert mon.alarmed() == jmon.alarmed()
        assert mon.live_signals() == jmon.live_signals()
        assert _health_gauges(reg.flat()) == _health_gauges(jreg.flat())
    signals = {(a.table, a.signal) for a in mon.alerts}
    assert signals == {("t0", "occupancy"), ("t0", "hit_rate"),
                       ("t0", "churn"), ("link:ici", "wire_ratio")}
    assert [dataclasses.asdict(x) for x in seen] == [
        dataclasses.asdict(x) for x in jmon.alerts]
    sa, sb = mon.summary(), jmon.summary()
    for s in (sa, sb):
        s.pop("overhead_s")
    assert sa == sb


def test_clean_stream_raises_no_alert_and_matches_jax():
    """A stream that stays inside its envelope: no alert in either, the
    same detector scores."""
    plan, jplan = _plans()
    reg, jreg = MetricsRegistry(), JRegistry()
    mon, jmon = HealthMonitor(reg, plan, **KNOBS), JMonitor(jreg, jplan,
                                                            **KNOBS)
    rng = np.random.RandomState(3)
    for step in range(30):
        _feed((reg, jreg), 0.9 + 0.02 * rng.randn(),
              int(200 * (0.6 + 0.03 * rng.randn())), 200, 1, 1000.0)
        assert mon.observe(step) == jmon.observe(step) == []
    assert not mon.alerts and not mon.alarmed()
    assert _health_gauges(reg.flat()) == _health_gauges(jreg.flat())


def test_live_inputs_from_the_ports_surfaces(tmp_path):
    """The monitor reads what the port exports: a KJT's per-key
    occupancy gauges (under its feature's name) and ``TieredStats``'
    counters; an alert onset is noted in the installed flight recorder;
    a window with too few lookups feeds no hit-rate sample."""
    plan = PlanAssumptions(tables={"t0": TableAssumptions(
        expected_occupancy=0.9, expected_hit_rate=0.9,
        feature_names=["f0"])})
    reg = MetricsRegistry()
    mon = HealthMonitor(reg, plan, warmup=2, min_consecutive=1)
    rec = flight_recorder.FlightRecorder(str(tmp_path / "flight.json"),
                                         capacity=16)
    flight_recorder.install_recorder(rec)
    try:
        stats = TieredStats()
        for step in range(8):
            n = 3 if step < 4 else 1  # f0's ids an example: 3 of 4, then 1
            kjt = KeyedJaggedTensor.from_lengths_packed(
                ["f0"], torch.arange(4 * n), torch.full((4,), n),
                caps=[16])
            reg.absorb(kjt.scalar_metrics())
            stats.record_remap("t0", 100, 90 if step < 4 else 10, 0, 0, 1)
            reg.absorb(stats.scalar_metrics("tiered"))
            mon.observe(step)
    finally:
        flight_recorder.uninstall_recorder()
    live = mon.live_signals()["t0"]
    assert math.isclose(live["occupancy"], mon._detectors[
        ("t0", "occupancy")].ewma)
    assert {a.signal for a in mon.alerts} == {"occupancy", "hit_rate"}
    notes = [e for e in rec.snapshot()["events"]
             if e.get("kind") == "drift_alert"]
    assert len(notes) == len(mon.alerts)
    quiet = HealthMonitor(MetricsRegistry(), plan, min_window_lookups=1000)
    quiet.registry.absorb(stats.scalar_metrics("tiered"))
    quiet.observe(0)
    quiet.observe(1)
    assert ("t0", "hit_rate") not in quiet._detectors
