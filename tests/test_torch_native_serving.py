"""Port parity for the serving tier's host library (``csrc/host/*.cpp``,
built with g++ at first use): the native batching queue, the id
transformers and the TCP front end, against the JAX package's.

The JAX package's queue and transformers are built here into a private
temporary directory, so this file never races another test process on
the JAX package's shared build.

Tolerance for scores ``rtol = 1e-5, atol = 1e-6``: the pooled embeddings
agree to the last bits, but the float32 matmuls of XLA and of PyTorch sum
in different orders."""

import ctypes
import os
import subprocess
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from torchrec_tpu.inference import predict_factory as jpf
from torchrec_tpu.inference import serving as jserving
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JConfig,
)
from torchrec_tpu_torch.inference import (
    InferenceServer,
    NetworkInferenceServer,
    PredictClient,
    PyBatchingQueue,
    QueueStopped,
    build_serving_fn,
    load_packaged_model,
)
from torchrec_tpu_torch.inference import serving as tserving
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

RTOL, ATOL = 1e-5, 1e-6
D, NUM_DENSE = 8, 3
ROWS = [50, 30]
FEATURES = ["f0", "f1"]
CAPS = [3, 2]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's batching queue and id transformers
    (``csrc/*.cpp``), built with g++ into a private directory and
    declared as the port's host library is (its ``trec_`` names); the
    JAX transformers load it in place of ``csrc_build.load_native``."""
    srcs = ["batching_queue.cpp", "id_transformer.cpp",
            "mp_id_transformer.cpp", "lfu_id_transformer.cpp"]
    out = str(tmp_path_factory.mktemp("jax_native") / "libjax.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    out, *(os.path.join(ROOT, "csrc", s) for s in srcs),
                    "-lpthread"], check=True, capture_output=True)
    lib = ctypes.CDLL(out, mode=ctypes.RTLD_GLOBAL)
    for name, (argtypes, restype) in _native._HOST_SIGNATURES.items():
        jname = name.replace("trt_", "trec_")
        if name.startswith("trt_srv") or not hasattr(lib, jname):
            continue
        fn = getattr(lib, jname)
        fn.argtypes, fn.restype = list(argtypes), restype
    mp = pytest.MonkeyPatch()
    mp.setattr(jserving, "load_native", lambda: lib)
    try:
        yield lib
    finally:
        mp.undo()


def _tables(cls=EmbeddingBagConfig):
    return tuple(cls(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                     feature_names=[f])
                 for i, (r, f) in enumerate(zip(ROWS, FEATURES)))


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {f"t{i}": rng.randn(r, D).astype(np.float32)
            for i, r in enumerate(ROWS)}


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(NUM_DENSE).astype(np.float32),
             [rng.randint(0, r, size=(rng.randint(0, c + 1),))
              for r, c in zip(ROWS, CAPS)]) for _ in range(n)]


def _wire(ids):
    lengths = np.asarray([len(x) for x in ids], np.int32)
    flat = (np.concatenate(ids).astype(np.int64) if lengths.sum()
            else np.zeros((0,), np.int64))
    return flat, lengths


def _native_queue(max_batch, latency_us, num_dense=1, num_features=1):
    return tserving._NativeQueue(_native.load_host_library(), max_batch,
                                 latency_us, num_dense, num_features,
                                 max_ids_hint=4)


def _one(q, i):
    return q.enqueue(np.full(q.num_dense, float(i), np.float32),
                     np.asarray([i], np.int64), np.asarray([1], np.int32))


# ---------------------------------------------------------------------------
# the native queue (tests/test_bucketed_serving.py and tests/test_mesh.py,
# on the port's library)
# ---------------------------------------------------------------------------


def test_native_queue_coalesces_to_max_batch():
    q = _native_queue(4, 10_000_000, num_dense=2)
    for i in range(4):
        _one(q, i)
    n, rids, dense, ids, lengths = q.dequeue_batch(1_000_000)
    assert n == 4
    np.testing.assert_array_equal(dense[:, 0], [0, 1, 2, 3])
    np.testing.assert_array_equal(ids, [0, 1, 2, 3])
    np.testing.assert_array_equal(lengths.reshape(-1), [1, 1, 1, 1])
    q.shutdown()


def test_native_queue_flushes_on_latency_deadline():
    q = _native_queue(64, 20_000)
    q.enqueue(np.zeros(1, np.float32), np.asarray([7], np.int64),
              np.asarray([1], np.int32))
    t0 = time.monotonic()
    n, _, _, ids, _ = q.dequeue_batch(2_000_000)
    took = time.monotonic() - t0
    assert n == 1 and ids.tolist() == [7]
    assert took < 1.0  # flushed at the 20 ms deadline, not the 2 s timeout
    q.shutdown()


def test_native_queue_timeout_and_shutdown():
    q = _native_queue(4, 1_000)
    n, *_ = q.dequeue_batch(30_000)
    assert n == 0  # empty timeout
    assert q.wait_result(123, 30_000) is None  # nothing posted
    rid = _one(q, 1)
    box = {}

    def waiter():
        t0 = time.monotonic()
        try:
            q.wait_result(rid, 30_000_000)
        except QueueStopped:
            box["raised"] = True
        box["took"] = time.monotonic() - t0

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    q.shutdown()
    t.join(timeout=2)
    assert not t.is_alive() and box.get("raised") and box["took"] < 2.0
    n, *_ = q.dequeue_batch(10_000_000)  # shutdown, not timeout
    assert n == -1
    with pytest.raises(QueueStopped):
        _one(q, 2)


def test_native_queue_results_round_trip():
    q = _native_queue(2, 1_000)
    rid = _one(q, 1)
    q.post_result(rid, 2.5)
    assert q.wait_result(rid, 1_000_000) == 2.5
    assert q.wait_result(rid, 10_000) is None  # consumed
    rid = _one(q, 2)
    q.post_result(rid, 4.5)
    q.shutdown()
    assert q.wait_result(rid, 1_000) == 4.5  # posted before the shutdown


def test_native_queue_pending_and_outstanding():
    q = _native_queue(4, 1_000)
    assert q.outstanding() == 0 and q.pending() == 0
    rid = _one(q, 1)
    assert q.outstanding() == 1 and q.pending() == 1
    q.dequeue_batch(50_000)
    assert q.pending() == 0 and q.outstanding() == 1  # inside "executor"
    q.post_result(rid, 0.0)
    assert q.outstanding() == 0
    q.shutdown()


def test_native_queue_grows_its_id_buffer():
    """A batch with more ids than the first buffer holds takes the resize
    protocol (-2) and returns every id."""
    q = _native_queue(3, 10_000_000, num_features=2)
    for i in range(3):
        q.enqueue(np.zeros(1, np.float32), np.arange(10 * i, 10 * i + 7),
                  np.asarray([4, 3], np.int32))
    n, _, _, ids, lengths = q.dequeue_batch(1_000_000)
    assert n == 3
    np.testing.assert_array_equal(
        ids, np.concatenate([np.arange(10 * i, 10 * i + 7)
                             for i in range(3)]))
    np.testing.assert_array_equal(lengths, [[4, 3]] * 3)
    q.shutdown()


def test_native_queue_refuses_malformed_requests():
    q = _native_queue(4, 1_000, num_dense=2, num_features=2)
    with pytest.raises(ValueError):
        q.enqueue(np.zeros(3, np.float32), np.zeros(0, np.int64),
                  np.zeros(2, np.int32))
    with pytest.raises(ValueError):  # lengths do not cover the ids
        q.enqueue(np.zeros(2, np.float32), np.arange(3),
                  np.asarray([1, 1], np.int32))
    q.shutdown()


@pytest.mark.parametrize("queue", ["native", "python"])
def test_native_queue_forms_the_jax_batches(jax_native, queue):
    """The same request stream, enqueued before any dequeue, gives the JAX
    queue's batches (request ids, dense, flat ids, lengths)."""
    reqs = _requests(11, seed=1)

    def batches(q):
        out = []
        for d, ids in reqs:
            q.enqueue(d, *_wire(ids))
        while True:
            n, rids, dense, ids, lengths = q.dequeue_batch(20_000)
            if n <= 0:
                break
            out.append((rids.copy(), dense.copy(), ids.copy(),
                        lengths.copy()))
        q.shutdown()
        return out

    jq = jserving._NativeQueue(jax_native, 4, 1_000, NUM_DENSE,
                               len(FEATURES), max_ids_hint=4)
    tq = (_native_queue(4, 1_000, NUM_DENSE, len(FEATURES))
          if queue == "native"
          else PyBatchingQueue(4, 1_000, NUM_DENSE, len(FEATURES)))
    jb, tb = batches(jq), batches(tq)
    assert [len(b[0]) for b in jb] == [4, 4, 3]
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_both_libraries_in_one_process(jax_native, tmp_path):
    """The JAX package's library and the port's, loaded into one process
    (the JAX one first, its symbols global): the port's TCP front end
    enqueues into the port's queue, and each library's queue is its
    own."""
    jq = jserving._NativeQueue(jax_native, 4, 1_000, 1, 1, max_ids_hint=4)
    lib = _native.load_host_library()
    assert not hasattr(lib, "trec_bq_create")
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    fn = build_serving_fn(None, qebc, device="cpu")
    srv = NetworkInferenceServer(fn, FEATURES, CAPS, NUM_DENSE,
                                 max_batch_size=4, max_latency_us=500)
    port = srv.serve()
    client = PredictClient(port)
    try:
        d, ids = _requests(1, seed=2)[0]
        assert client.predict(d, ids) == pytest.approx(
            srv.predict(d, ids), rel=RTOL, abs=ATOL)
        assert jq.pending() == 0
        _one(jq, 3)
        assert jq.pending() == 1 and srv._queue.pending() == 0
    finally:
        client.close()
        srv.stop()
        jq.shutdown()


def test_host_library_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises (no fallback to the python queue)."""
    monkeypatch.setattr(_native, "_HOST_LIB", [])
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "GXX_FLAGS",
                        _native.GXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.load_host_library()
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    fn = build_serving_fn(None, qebc, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        InferenceServer(fn, FEATURES, CAPS, NUM_DENSE)


def test_concurrent_builds_load_one_library(tmp_path):
    """Processes that build the host library at once take turns on its
    lock: each loads a whole library."""
    code = (
        "import sys\n"
        "from torchrec_tpu_torch.ops import _native\n"
        f"_native.BUILD_DIR = {str(tmp_path)!r}\n"
        "lib = _native.load_host_library()\n"
        "q = lib.trt_bq_create(2, 1000, 1, 1)\n"
        "print(lib.trt_bq_pending(q))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(["python", "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [o.strip() for o, _ in outs] == ["0", "0", "0"]
    built = [n for n in os.listdir(tmp_path) if n.endswith(".so")]
    assert len(built) == 1 and not any(n.endswith(".tmp")
                                       for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# id transformers: the same id streams give the same slots and evictions
# ---------------------------------------------------------------------------


def _streams(seed, n_batches=12, size=40, vocab=300):
    rng = np.random.RandomState(seed)
    return [np.minimum(rng.zipf(1.3, size=size) - 1, vocab - 1).astype(
        np.int64) for _ in range(n_batches)]


@pytest.mark.parametrize("kind,kwargs", [
    ("IdTransformer", {"capacity": 32}),
    ("MpIdTransformer", {"capacity": 64, "max_probe": 4}),
    ("LfuIdTransformer", {"capacity": 48, "policy": "lfu"}),
    ("LfuIdTransformer", {"capacity": 48, "policy": "distance_lfu",
                          "decay_exponent": 1.5}),
    ("PyLfuIdTransformer", {"capacity": 24, "policy": "lfu"}),
    ("PyLfuIdTransformer", {"capacity": 24, "policy": "distance_lfu"}),
])
def test_id_transformers_match_jax(jax_native, kind, kwargs):
    jt = getattr(jserving, kind)(**kwargs)
    tt = getattr(tserving, kind)(**kwargs)
    for ids in _streams(zlib.crc32(f"{kind}{sorted(kwargs.items())}".encode())
                        % 1000):
        a, b = jt.transform(ids), tt.transform(ids)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert len(jt) == len(tt)
    assert len(tt) == kwargs["capacity"] or kind == "MpIdTransformer"


# ---------------------------------------------------------------------------
# servers: the JAX server and the port's native one on one artifact
# ---------------------------------------------------------------------------


def test_native_server_scores_match_jax(tmp_path):
    """One artifact served by the JAX server and by the port's server on
    the native queue, 4 client threads each: every score within the
    stated tolerance, no executor error."""
    path = str(tmp_path / "artifact")
    jpf.package_model(path, _tables(JConfig), _weights(),
                      dict(zip(FEATURES, CAPS)), NUM_DENSE)
    jfn, _ = jpf.load_packaged_model(path)
    tfn, _ = load_packaged_model(path, device="cpu")
    reqs = _requests(24, seed=3)
    kw = dict(max_batch_size=4, max_latency_us=500)
    answers = []
    for srv in (jserving.InferenceServer(jfn, FEATURES, CAPS, NUM_DENSE,
                                         queue="python", **kw),
                InferenceServer(tfn, FEATURES, CAPS, NUM_DENSE, **kw)):
        got = {}

        def client(k, srv=srv, got=got):
            for i in range(k, len(reqs), 4):
                got[i] = srv.predict(*reqs[i])

        srv.start()
        try:
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            srv.stop()
        assert "serving/executor_error_count" not in srv.metrics.names()
        answers.append([got[i] for i in range(len(reqs))])
    assert np.isfinite(answers[1]).all()
    np.testing.assert_allclose(answers[1], answers[0], rtol=RTOL, atol=ATOL)


def test_tcp_client_gets_the_in_process_score():
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    fn = build_serving_fn(None, qebc, device="cpu")
    srv = NetworkInferenceServer(fn, FEATURES, CAPS, NUM_DENSE,
                                 max_batch_size=8, max_latency_us=500)
    port = srv.serve()
    clients = [PredictClient(port) for _ in range(3)]
    reqs = _requests(15, seed=4)
    try:
        tcp = [clients[i % 3].predict(*r) for i, r in enumerate(reqs)]
        local = [srv.predict(*r) for r in reqs]
        np.testing.assert_array_equal(tcp, local)
        # over capacity and the wrong dense width: status 2 (malformed)
        with pytest.raises(ValueError, match="malformed"):
            clients[0].predict(reqs[0][0], [np.arange(CAPS[0] + 1),
                                            np.arange(1)])
        with pytest.raises(ValueError, match="malformed"):
            clients[1].predict(np.zeros(NUM_DENSE + 1, np.float32),
                               reqs[0][1])
    finally:
        for c in clients:
            c.close()
        srv.stop()


def test_tcp_drain_answers_inflight_then_stops():
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    fn = build_serving_fn(None, qebc, device="cpu")

    class Slow(torch.nn.Module):
        device = torch.device("cpu")

        def forward(self, dense, kjt):
            time.sleep(0.1)
            return fn(dense, kjt)

    srv = NetworkInferenceServer(Slow(), FEATURES, CAPS, NUM_DENSE,
                                 max_batch_size=4, max_latency_us=500)
    port = srv.serve()
    d, ids = _requests(1, seed=5)[0]
    got = {}

    def client():
        c = PredictClient(port)
        got["score"] = c.predict(d, ids)
        c.close()

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.03)
    assert srv.drain(deadline_s=5.0) is True
    t.join(timeout=2)
    assert got["score"] == pytest.approx(float(fn(*_one_batch(d, ids))[0]),
                                         rel=RTOL, abs=ATOL)
    assert srv.metrics.value("serving/drained_request_count") >= 1
    assert "serving/drain_abandoned_count" not in srv.metrics.names()


def _one_batch(d, ids):
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    flat, lengths = _wire(ids)
    kjt = KeyedJaggedTensor.from_lengths_packed(FEATURES, flat, lengths,
                                                caps=CAPS)
    return torch.from_numpy(d[None]), kjt


def test_sigterm_drain_in_a_subprocess(tmp_path):
    """``install_sigterm_drain``: SIGTERM drains the server (in-flight
    answered), then the process dies of SIGTERM."""
    code = (
        "import os, signal, threading, time\n"
        "import numpy as np, torch\n"
        "from torchrec_tpu_torch.inference import InferenceServer, "
        "install_sigterm_drain\n"
        "class Fn(torch.nn.Module):\n"
        "    device = torch.device('cpu')\n"
        "    def forward(self, dense, kjt):\n"
        "        time.sleep(0.2)\n"
        "        return dense.sum(dim=1)\n"
        "srv = InferenceServer(Fn(), ['f0'], [2], 2, max_batch_size=2,\n"
        "                      max_latency_us=500)\n"
        "srv.start()\n"
        "install_sigterm_drain(srv, 5.0)\n"
        "def client():\n"
        "    s = srv.predict(np.asarray([1.0, 2.0], np.float32),\n"
        "                    [np.asarray([1])])\n"
        f"    open({str(tmp_path / 'score')!r}, 'w').write(str(s))\n"
        "t = threading.Thread(target=client); t.start()\n"
        "while srv._queue.outstanding() < 1:  # the request is in\n"
        "    time.sleep(0.001)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(5)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(["python", "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == -15, proc.stderr
    assert float((tmp_path / "score").read_text()) == 3.0


def test_transformer_handles_are_freed():
    t = tserving.IdTransformer(4)
    h = t._h
    assert h and ctypes.c_void_p(h).value
    t.__del__()
    assert t._h is None
