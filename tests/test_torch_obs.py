"""The port's span tracer, device-metrics pump and bucketing counters
(``torchrec_tpu_torch/obs/{spans,device_poll}.py``,
``utils/profiling.py::{annotate,PaddingStats}``): the JAX package's
``tests/test_obs.py`` span, Chrome-trace, JSONL and ``annotate`` cases
ported; every span a profiler range with a tracer or without; the pump's
off-thread landing, its drop at a full queue, and the value at ``submit``
after an in-place change; and ``PaddingStats`` against the JAX package's
on the same call sequence."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from torchrec_tpu.utils.profiling import PaddingStats as JPaddingStats
from torchrec_tpu_torch.obs import (
    DeviceMetricsPump,
    FlightRecorder,
    MetricsRegistry,
    SpanTracer,
    install_recorder,
    install_tracer,
    span,
    uninstall_recorder,
    uninstall_tracer,
)
from torchrec_tpu_torch.obs.report import validate_chrome_trace
from torchrec_tpu_torch.utils.profiling import PaddingStats, annotate


@pytest.fixture
def tracer():
    t = SpanTracer()
    prev = install_tracer(t)
    yield t
    install_tracer(prev) if prev is not None else uninstall_tracer()


def test_span_nesting_depth_and_duration(tracer):
    with span("outer", foo=1):
        time.sleep(0.003)
        with span("inner"):
            time.sleep(0.001)
    spans = {s["name"]: s for s in tracer.spans}
    assert spans["outer"]["depth"] == 0
    assert spans["inner"]["depth"] == 1
    assert spans["inner"]["dur_s"] <= spans["outer"]["dur_s"]
    assert spans["inner"]["mono"] >= spans["outer"]["mono"]
    assert spans["outer"]["attrs"] == {"foo": 1}


def test_span_is_a_profiler_range_with_or_without_tracer():
    """No tracer: nothing recorded, ``set_attr`` a no-op, and still a
    named range on the profiler's timeline; with one, the same range and
    a record."""
    assert uninstall_tracer() is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("obs_test/bare", n=3) as sp:
            sp.set_attr("seconds", 1.0)
        t = SpanTracer()
        install_tracer(t)
        try:
            with span("obs_test/traced"):
                pass
        finally:
            uninstall_tracer()
    names = {e.key for e in prof.key_averages()}
    assert {"obs_test/bare", "obs_test/traced"} <= names
    assert [s["name"] for s in t.spans] == ["obs_test/traced"]


def test_span_records_error_attr(tracer):
    with pytest.raises(ValueError):
        with span("failing"):
            raise ValueError("boom")
    (rec,) = tracer.spans
    assert rec["attrs"]["error"] == "ValueError"


def test_span_set_attr_lands_in_the_record(tracer):
    with span("tiered/prefetch_wait") as sp:
        sp.set_attr("seconds", 0.25)
    assert tracer.spans[0]["attrs"] == {"seconds": 0.25}


def test_span_thread_safety(tracer):
    N, per = 8, 50

    def work(i):
        for _ in range(per):
            with span(f"outer_{i}"):
                with span(f"inner_{i}"):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    spans = tracer.spans
    assert len(spans) == N * per * 2
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s["thread"], []).append(s)
    assert len(by_thread) == N
    for recs in by_thread.values():
        assert {s["depth"] for s in recs
                if s["name"].startswith("inner")} == {1}
        assert {s["depth"] for s in recs
                if s["name"].startswith("outer")} == {0}


def test_span_buffer_bound_drops_and_counts():
    t = SpanTracer(max_spans=3)
    prev = install_tracer(t)
    try:
        for _ in range(5):
            with span("x"):
                pass
    finally:
        install_tracer(prev) if prev is not None else uninstall_tracer()
    assert len(t.spans) == 3
    assert t.dropped == 2


def test_chrome_trace_schema_valid(tracer, tmp_path):
    with span("a/b", k="v"):
        with span("a/c"):
            pass
    path = str(tmp_path / "trace.json")
    assert tracer.export_chrome_trace(path) == 2
    assert validate_chrome_trace(path) == 2
    doc = json.load(open(path))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"a/b", "a/c"}
    for e in xs:
        assert e["dur"] >= 0 and e["ts"] >= 0
        assert e["cat"] == "a"
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "thread_name" for e in metas)


def test_span_jsonl_flush_round_trip(tracer, tmp_path):
    with span("stage_x"):
        pass
    path = str(tmp_path / "events.jsonl")
    assert tracer.flush_jsonl(path) == 1
    (rec,) = [json.loads(ln) for ln in open(path)]
    assert rec["event"] == "span" and rec["name"] == "stage_x"
    assert rec["dur_s"] >= 0


def test_annotate_emits_spans(tracer):
    with annotate("legacy_phase"):
        pass
    assert [s["name"] for s in tracer.spans] == ["legacy_phase"]

    @annotate("decorated_phase")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    assert [s["name"] for s in tracer.spans] == ["legacy_phase",
                                                 "decorated_phase"]


def test_closed_spans_feed_the_flight_recorder(tracer, tmp_path):
    rec = FlightRecorder(str(tmp_path / "flight.json"))
    prev = install_recorder(rec)
    try:
        with span("recorded"):
            pass
    finally:
        install_recorder(prev) if prev is not None else uninstall_recorder()
    assert [s["name"] for s in rec.snapshot()["spans"]] == ["recorded"]


# -- the pump -------------------------------------------------------------------


def test_pump_lands_metrics_off_thread():
    r = MetricsRegistry()
    pump = DeviceMetricsPump(r, histograms=("loss",))
    try:
        for i in range(3):
            assert pump.submit({"loss": torch.tensor(1.5 + i),
                                "id_violations": torch.tensor([1, 2])},
                               step=i)
        pump.flush()
    finally:
        pump.close()
    assert r.value("step/loss") == 3.5
    assert r.value("step/id_violations") == 3.0
    assert r.value("obs/pump/last_step") == 2.0
    assert r.histogram("step/loss/hist").count == 3


class _BlockingLeaf:
    """Its host conversion blocks until released: pins the worker."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def __array__(self, dtype=None, copy=None):
        self.entered.set()
        assert self.release.wait(timeout=10)
        return np.asarray(0.0, np.float32)


def test_pump_bounded_queue_drops_instead_of_blocking():
    r = MetricsRegistry()
    pump = DeviceMetricsPump(r, capacity=1)
    leaf = _BlockingLeaf()
    try:
        assert pump.submit({"slow": leaf})
        assert leaf.entered.wait(timeout=10)
        assert pump.submit({"x": 1.0})
        t0 = time.perf_counter()
        assert not pump.submit({"y": 2.0})
        assert time.perf_counter() - t0 < 1.0
        leaf.release.set()
        pump.flush()
    finally:
        leaf.release.set()
        pump.close()
    assert pump.dropped == 1
    assert r.value("obs/pump/dropped_count") == 1.0
    assert r.value("step/x") == 1.0
    assert "step/y" not in r.names()


def test_pump_lands_the_value_at_submit():
    """A step that updates its metric tensor in place after ``submit``
    (the worker pinned meanwhile) does not change what lands."""
    r = MetricsRegistry()
    pump = DeviceMetricsPump(r, capacity=4)
    leaf = _BlockingLeaf()
    loss = torch.tensor([0.25, 0.5])
    try:
        assert pump.submit({"slow": leaf})
        assert leaf.entered.wait(timeout=10)
        assert pump.submit({"loss": loss, "bf16": loss.to(torch.bfloat16)})
        loss.add_(100.0)  # in place, as a torch step may
        leaf.release.set()
        pump.flush()
    finally:
        leaf.release.set()
        pump.close()
    assert r.value("step/loss") == 0.75
    assert r.value("step/bf16") == 0.75
    assert "obs/pump/fetch_error_count" not in r.names()


# -- PaddingStats ----------------------------------------------------------------


def test_padding_stats_match_jax():
    """The same calls in both packages: the same ``scalar_metrics`` (the
    port adds ``dispatch_count``), ``wire_bytes_per_step`` and
    ``program_count``.  The port's pipeline records a signature's program
    as it builds the clone, before its first dispatch; the JAX package
    has no such call and counts the signatures with a trace ledger."""
    keys = ["a", "b"]
    calls = [
        ("record_batch", (keys, [3, 5], [4, 8], [16, 16])),
        ("record_program", ((4, 8),)),
        ("record_dispatch", ((4, 8),)),
        ("record_compile", ((4, 8), {"all_to_all:fwd": 96.0,
                                     "link:ici": 96.0, "link:dcn": 0.0})),
        ("record_batch", (keys, [1, 7], [2, 8], [16, 16])),
        ("record_program", ((2, 8),)),
        ("record_dispatch", ((2, 8),)),
        ("record_compile", ((2, 8), {"all_to_all:fwd": 48.0,
                                     "link:ici": 32.0, "link:dcn": 16.0})),
        ("record_compile", ((2, 8), {"all_to_all:bwd": 8.0})),
        ("record_fallback", ()),
        ("record_batch", (keys, [4, 8], [4, 8], [16, 16])),
        ("record_dispatch", ((4, 8),)),
        ("record_overflow_fallback", ()),
    ]
    j, p = JPaddingStats(), PaddingStats()
    for name, args in calls:
        if name != "record_program":
            getattr(j, name)(*args)
        getattr(p, name)(*args)
    want = j.scalar_metrics("tiered/bucketing")
    got = p.scalar_metrics("tiered/bucketing")
    assert got.pop("tiered/bucketing/dispatch_count") == 3.0
    assert got == want
    assert p.wire_bytes_per_step() == j.wire_bytes_per_step()
    assert p.program_count == j.program_count == 2
    assert "bucketing/a/mean_occupancy" in p.scalar_metrics()
