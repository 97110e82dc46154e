"""Port parity for the serving front ends and the metrics registry: HTTP
(``/predict``, ``/health``, ``/metrics``, drain), gRPC (CPU only: the GPU
host has no ``grpcio``), and ``MetricsRegistry`` against the JAX
package's (``quantiles``, ``delta``, ``to_prometheus`` and the rest on
the same observations).

Replica servers here run a plain PyTorch serving function (the dense
features' sum plus each feature's id count) through the port's queues,
so no lookup kernel is involved; scores are exact."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torchrec_tpu.obs.registry import MetricsRegistry as JRegistry
from torchrec_tpu_torch.inference import (
    HttpInferenceServer,
    InferenceServer,
)
from torchrec_tpu_torch.obs.registry import MetricsRegistry as TRegistry

NUM_DENSE, CAP = 2, 4
D = np.asarray([1.0, 2.0], np.float32)
IDS = [np.asarray([1, 2], np.int64)]


class SumFn(torch.nn.Module):
    """dense.sum + the number of ids in each example, optionally slow."""

    device = torch.device("cpu")

    def __init__(self, delay_s=0.0):
        super().__init__()
        self.delay_s = delay_s

    def forward(self, dense, kjt):
        if self.delay_s:
            time.sleep(self.delay_s)
        return dense.sum(dim=1) + kjt.lengths().to(torch.float32)


def _server(queue="native", delay_s=0.0, **kw):
    return InferenceServer(SumFn(delay_s), ["f0"], [CAP], NUM_DENSE,
                           max_batch_size=4, max_latency_us=500, queue=queue,
                           **kw)


def _post(port, body, timeout=5):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("queue", ["native", "python"])
def test_http_predict_health_metrics(queue):
    srv = _server(queue)
    http = HttpInferenceServer(srv)
    port = http.serve()
    try:
        rng = np.random.RandomState(0)
        for _ in range(6):
            d = rng.rand(NUM_DENSE).astype(np.float32)
            ids = [rng.randint(0, 9, size=(rng.randint(0, CAP + 1),))]
            got = _post(port, {"float_features": d.tolist(),
                               "id_list_features": {"f0": ids[0].tolist()}})
            assert got == {"score": srv.predict(d, ids), "degraded": False}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health") as r:
            assert r.status == 200 and json.loads(r.read()) == {
                "status": "ok"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert text == srv.metrics.to_prometheus()
        # replies leave without waiting on the client's delayed ACK
        assert http._httpd.RequestHandlerClass.disable_nagle_algorithm
        assert "# TYPE serving_request_latency_ms histogram" in text
        assert "serving_request_count 12" in text
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"float_features": [1.0]})  # wrong dense width
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
        assert exc.value.code == 404
    finally:
        http.stop()


def test_http_degraded_answer_carries_its_reason():
    srv = _server(feature_rows=[10], degrade_on_bad_input=True)
    http = HttpInferenceServer(srv)
    port = http.serve()
    try:
        got = _post(port, {"float_features": [1.0, 2.0],
                           "id_list_features": {"f0": [1, 99]}})
        assert got["degraded"] and "dropped 1 invalid ids" in got[
            "degraded_reason"]
        assert got["score"] == 4.0  # the dropped id is gone
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            assert ('serving_degraded_count{table="invalid_ids"} 1'
                    in r.read().decode())
    finally:
        http.stop()


def test_http_draining_refuses_new_keepalive_requests():
    http = HttpInferenceServer(_server())
    port = http.serve()
    try:
        http._draining = True  # what drain() flips before the teardown
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"float_features": [1.0, 2.0],
                         "id_list_features": {"f0": [1]}})
        assert exc.value.code == 503
        assert "draining" in json.loads(exc.value.read())["error"]
    finally:
        http._draining = False
        http.stop()


@pytest.mark.parametrize("queue", ["native", "python"])
def test_http_drain_closes_listener_then_finishes_inflight(queue):
    srv = _server(queue, delay_s=0.1)
    http = HttpInferenceServer(srv)
    port = http.serve()
    results = {}

    def client():
        results.update(_post(port, {"float_features": [1.0, 2.0],
                                    "id_list_features": {"f0": [1]}}))

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.05)
    assert http.drain(deadline_s=5.0) is True
    t.join(timeout=2)
    assert results.get("score") == 4.0
    m = srv.metrics
    assert m.value("serving/drain_count") == 1
    assert m.value("serving/drained_request_count") >= 1
    assert "serving/drain_abandoned_count" not in m.names()


# ---------------------------------------------------------------------------
# gRPC (grpcio and protobuf on the CPU host only)
# ---------------------------------------------------------------------------


def test_grpc_predict_matches_in_process():
    pytest.importorskip("grpc")
    from torchrec_tpu.inference.grpc_server import (
        GrpcPredictClient as JClient,
    )
    from torchrec_tpu_torch.inference.grpc_server import (
        GrpcInferenceServer,
        GrpcPredictClient,
        request_from_arrays,
    )

    srv = _server()
    g = GrpcInferenceServer(srv)
    port = g.serve()
    clients = (GrpcPredictClient(port), JClient(port))
    try:
        rng = np.random.RandomState(1)
        for i in range(6):
            d = rng.rand(NUM_DENSE).astype(np.float32)
            ids = [rng.randint(0, 9, size=(rng.randint(0, CAP + 1),))]
            got = clients[i % 2].predict(d, ids)
            assert list(got) == ["default"]
            assert got["default"].tolist() == [srv.predict(d, ids)]
        req = request_from_arrays(D, IDS)
        assert req.batch_size == 1 and req.id_list_features.num_features == 1
        import grpc

        with pytest.raises(grpc.RpcError) as exc:  # over capacity
            clients[0].predict(D, [np.arange(CAP + 1)])
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        for c in clients:
            c.close()
        g.stop()


def test_inference_package_imports_no_grpc():
    import subprocess
    import sys

    code = ("import sys, torchrec_tpu_torch.inference\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'grpc' "
            "or m.startswith('google.protobuf') or m.endswith('_pb2')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# MetricsRegistry against the JAX package's
# ---------------------------------------------------------------------------


def _feed(reg, rng):
    for v in rng.lognormal(0.0, 1.5, size=300):
        reg.observe("serving/request_latency_ms", float(v))
    for v in rng.randint(1, 64, size=40):
        reg.observe("serving/batch_size", float(v),
                    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
    reg.counter("serving/request_count", 300)
    reg.counter("mesh/r0/failure_count", 3)
    reg.gauge("mesh/r0/healthy", 1.0)
    reg.counter_set("tiered/t0/hits", 17)
    reg.counter_set("tiered/t0/hits", 12)  # monotonic: keeps 17
    reg.absorb({"kjt/f0/occupancy": 0.5, "kjt/f1/occupancy": 0.25})
    reg.absorb({"tiered/t1/misses": 4.0}, kind="counter")


def test_registry_matches_jax_on_the_same_observations(tmp_path):
    regs = (JRegistry(), TRegistry())
    snaps = []
    for reg in regs:
        _feed(reg, np.random.RandomState(2))
        snaps.append(reg.snapshot())
        reg.counter("serving/request_count", 5)
        reg.observe("serving/request_latency_ms", 7.0)
    j, t = regs
    assert t.to_prometheus() == j.to_prometheus()
    assert t.names() == j.names()
    assert t.flat() == j.flat()
    assert t.delta(snaps[1]) == j.delta(snaps[0])
    for qs in ((0.5, 0.99), (0.0, 0.25, 1.0)):
        assert t.quantiles("serving/request_latency_ms", qs) == (
            j.quantiles("serving/request_latency_ms", qs))
    for name in ("serving/request_count", "mesh/r0/healthy",
                 "tiered/t0/hits", "kjt/f1/occupancy"):
        assert t.kind(name) == j.kind(name)
        assert t.value(name) == j.value(name)
    h = t.histogram("serving/batch_size")
    assert h.quantile(0.5) == j.histogram("serving/batch_size").quantile(0.5)
    for reg, name in ((j, "j.jsonl"), (t, "t.jsonl")):
        reg.dump_jsonl(str(tmp_path / name), step=3)
    jl = json.loads((tmp_path / "j.jsonl").read_text())
    tl = json.loads((tmp_path / "t.jsonl").read_text())
    assert tl["metrics"] == jl["metrics"] and tl["step"] == 3


def test_registry_collisions_and_merge():
    reg = TRegistry()
    reg.counter("a/b")
    with pytest.raises(ValueError):
        reg.gauge("a/b", 1.0)
    with pytest.raises(TypeError):
        reg.quantiles("a/b")
    with pytest.raises(ValueError):
        reg.absorb({"x": 1.0}, kind="histogram")
    reg.observe("h", 1.0, buckets=(1.0, 2.0))
    with pytest.raises(ValueError):
        reg.observe("h", 1.0, buckets=(1.0, 3.0))
    a = reg.histogram("h").clone()
    b = reg.histogram("h").clone()
    b.observe(2.0)
    a.merge(b)
    assert a.count == 3 and a.sum == 4.0
    from torchrec_tpu_torch.obs.registry import HistogramValue

    with pytest.raises(ValueError):
        a.merge(HistogramValue((5.0,)))
