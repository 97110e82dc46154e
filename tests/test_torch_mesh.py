"""The port's serving mesh (``inference/mesh.py``) over the port's
servers: the router answers like one replica, a replica killed
mid-stream costs no request, the circuit breaker ejects and the probe
reinstates, hedging beats a slow replica, and with every replica down
the answer is the degraded fallback — the cases of the JAX package's
``tests/test_mesh.py``, on the native queue and the python one.

Replicas run a plain PyTorch serving function (the dense features' sum),
so scores are exact."""

import threading
import time

import numpy as np
import pytest
import torch

from torchrec_tpu.inference.mesh import ReplicaRouter as JRouter
from torchrec_tpu.inference.serving import InferenceServer as JServer
from torchrec_tpu_torch.inference import (
    AllReplicasDown,
    CircuitBreaker,
    InferenceServer,
    QueueStopped,
    ReplicaRouter,
)

NUM_DENSE, CAP = 2, 4
D = np.asarray([1.0, 2.0], np.float32)
IDS = [np.asarray([1, 2], np.int64)]


class Fn(torch.nn.Module):
    device = torch.device("cpu")

    def __init__(self, delay_s=0.0, fail=False):
        super().__init__()
        self.delay_s, self.fail = delay_s, fail

    def forward(self, dense, kjt):
        if self.fail:
            raise RuntimeError("injected replica fault")
        if self.delay_s:
            time.sleep(self.delay_s)
        return dense.sum(dim=1)


def make_replica(delay_s=0.0, fail=False, start=True, queue="native"):
    srv = InferenceServer(Fn(delay_s, fail), ["f0"], [CAP],
                          num_dense=NUM_DENSE, max_batch_size=4,
                          max_latency_us=500, queue=queue)
    if start:
        srv.start()
    return srv


def kill(server):
    """A killed process as the router sees it: the queue stops at once,
    in-flight requests are never answered."""
    server._running = False
    server._queue.shutdown()


def make_router(replicas, **kw):
    kw.setdefault("probe_interval_s", 0.01)
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("deadline_us", 5_000_000)
    return ReplicaRouter(replicas, **kw)


@pytest.mark.parametrize("queue", ["native", "python"])
def test_routes_and_answers_like_a_single_replica(queue):
    reps = {f"r{i}": make_replica(queue=queue) for i in range(3)}
    single = make_replica(queue=queue)
    router = make_router(reps)
    try:
        rng = np.random.RandomState(0)
        for _ in range(8):
            d = rng.rand(NUM_DENSE).astype(np.float32)
            score, degraded, reason = router.predict_ex(d, IDS)
            assert score == single.predict(d, IDS)
            assert not degraded and reason is None
        assert router.metrics.value("mesh/request_count") == 8
        with pytest.raises(ValueError):  # malformed: no retry
            router.predict_ex(D, [np.asarray([1]), np.asarray([2])])
        assert "mesh/retry_count" not in router.metrics.names()
    finally:
        router.stop()
        for s in [*reps.values(), single]:
            s.stop()


@pytest.mark.parametrize("queue", ["native", "python"])
def test_replica_kill_mid_stream_zero_failed_requests(queue):
    reps = {f"r{i}": make_replica(queue=queue) for i in range(3)}
    router = make_router(reps, failure_threshold=2)
    router.start_probes()
    try:
        for i in range(40):
            if i == 10:
                kill(reps["r1"])
            score, degraded, reason = router.predict_ex(D, IDS)
            assert score == pytest.approx(3.0), (i, reason)
            assert not degraded, (i, reason)
        time.sleep(0.05)  # a probe sweep
        assert sorted(router.routable()) == ["r0", "r2"]
        with pytest.raises(QueueStopped):
            reps["r1"].predict(D, IDS)
    finally:
        router.stop()
        for n, s in reps.items():
            if n != "r1":
                s.stop()


def test_breaker_ejects_faulty_replica_and_probe_reinstates():
    rep = make_replica(fail=True)
    router = make_router({"r0": rep}, failure_threshold=2, cooldown_s=0.05,
                         hedge=False, max_attempts=2)
    try:
        score, degraded, reason = router.predict_ex(D, IDS)
        assert degraded and reason.startswith("mesh:")
        assert router.metrics.value("mesh/ejected_count") == 1
        assert router.routable() == []
        rep._fn = Fn()  # healed
        time.sleep(0.06)
        router.probe_once()
        assert router.metrics.value("mesh/reinstated_count") == 1
        assert router.routable() == ["r0"]
        score, degraded, _ = router.predict_ex(D, IDS)
        assert score == pytest.approx(3.0) and not degraded
    finally:
        router.stop()
        rep.stop()


def test_hedged_request_beats_a_slow_replica():
    slow, fast = make_replica(delay_s=0.25), make_replica()
    router = make_router({"slow": slow, "fast": fast}, hedge=True,
                         hedge_min_s=0.02, hedge_warmup=1 << 30)
    try:
        t0 = time.monotonic()
        for _ in range(6):
            score, degraded, _ = router.predict_ex(D, IDS)
            assert score == pytest.approx(3.0) and not degraded
        took = time.monotonic() - t0
        m = router.metrics
        assert m.value("mesh/hedge_count") >= 1
        assert m.value("mesh/hedge_win_count") >= 1
        assert took < 0.5, took
    finally:
        router.stop()
        slow.stop()
        fast.stop()


def test_hedge_delay_reads_the_live_p99():
    reps = {"a": make_replica(), "b": make_replica()}
    router = make_router(reps, hedge=True, hedge_min_s=0.001,
                         hedge_warmup=4)
    try:
        for _ in range(32):  # the delay is recomputed every 32 successes
            router.predict_ex(D, IDS)
        p99 = router.metrics.quantiles("mesh/request_latency_ms", (0.99,))[0]
        assert router._hedge_delay() == pytest.approx(
            max(0.001, p99 * 1e-3))
    finally:
        router.stop()
        for s in reps.values():
            s.stop()


def test_all_replicas_down_serves_degraded_fallback():
    rep = make_replica()
    router = make_router({"r0": rep}, fallback_score=0.25)
    kill(rep)
    router.probe_once()
    try:
        score, degraded, reason = router.predict_ex(D, IDS)
        assert score == 0.25 and degraded and reason.startswith("mesh:")
        assert router.metrics.value("mesh/degraded_fallback_count") == 1
        with pytest.raises(AllReplicasDown):
            router.predict(D, IDS, strict=True)
    finally:
        router.stop()


def test_circuit_breaker_unit_semantics():
    br = CircuitBreaker(failure_threshold=3, cooldown_s=0.05)
    assert not br.record_failure() and not br.record_failure()
    br.record_success()
    assert not br.record_failure() and not br.record_failure()
    assert br.record_failure() is True
    assert br.open and not br.record_failure()
    assert not br.probe_eligible()
    time.sleep(0.06)
    assert br.probe_eligible()
    br.reinstate()
    assert not br.open
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)


def test_router_counters_match_jax_on_one_script():
    """The same script (a kill mid-stream, a probe sweep, hedging off)
    through the JAX router over JAX replicas and the port's over the
    port's: the same answers and the same mesh counters."""

    class NpFn:
        def __call__(self, dense, kjt):
            return np.asarray(dense).sum(axis=1)

    jreps = {f"r{i}": JServer(NpFn(), ["f0"], [CAP], num_dense=NUM_DENSE,
                              max_batch_size=4, max_latency_us=500,
                              queue="python") for i in range(2)}
    treps = {f"r{i}": make_replica(start=False) for i in range(2)}
    out = []
    for cls, reps in ((JRouter, jreps), (ReplicaRouter, treps)):
        for s in reps.values():
            s.start()
        router = cls(reps, hedge=False, failure_threshold=1, backoff_s=0.001,
                     probe_interval_s=0.01, deadline_us=5_000_000)
        answers = []
        try:
            for i in range(12):
                if i == 4:
                    kill(reps["r1"])
                answers.append(router.predict_ex(D, IDS)[:2])
            router.probe_once()
            answers.append(tuple(router.routable()))
        finally:
            router.stop()
            reps["r0"].stop()
        names = [n for n in router.metrics.names() if n.startswith("mesh/")
                 and "latency" not in n]
        out.append((answers, {n: router.metrics.value(n) for n in names}))
    assert out[1] == out[0]


def test_drain_answers_inflight_then_refuses_new():
    rep = make_replica(delay_s=0.1)
    results = {}

    def client():
        results["score"] = rep.predict(D, IDS, timeout_us=5_000_000)

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.03)
    assert rep.drain(deadline_s=5.0) is True
    t.join(timeout=2)
    assert results["score"] == pytest.approx(3.0)
    assert rep.metrics.value("serving/drained_request_count") >= 1
    with pytest.raises(QueueStopped):
        rep.predict(D, IDS)
