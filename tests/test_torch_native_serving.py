"""Port parity for the serving tier's host library (``csrc/host/*.cpp``,
built with g++ at first use): the native batching queue, the id
transformers and the TCP front end, against the JAX package's; and
serving with no Python in the request path (``export_native`` ->
``NativeInferenceServer``: the AOTInductor package run by the C++ loop of
``csrc/host/aoti_executor.cpp``) against the JAX package's
``load_packaged_model`` on the JAX package's own tiny artifact
(``tests/test_native_serving.py``'s), within that test's bounds: 1e-6
for the exported program, 1e-4 for the native server.  Two AOTInductor
compiles in all, in module-scoped fixtures.

The JAX package's queue and transformers are built here into a private
temporary directory, so this file never races another test process on
the JAX package's shared build.

Tolerance for scores ``rtol = 1e-5, atol = 1e-6``: the pooled embeddings
agree to the last bits, but the float32 matmuls of XLA and of PyTorch sum
in different orders."""

import ctypes
import json
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


# ---------------------------------------------------------------------------
# no Python in the request path: export_native -> NativeInferenceServer
# (the JAX package's tests/test_native_serving.py, on the port)
# ---------------------------------------------------------------------------

NB = 8  # the export's static batch
NCAPS = {"f0": 4, "f1": 4}


@pytest.fixture(scope="module")
def native_artifact(tmp_path_factory):
    """The JAX package's tiny artifact (t0 100 x 8, t1 60 x 4, int8, caps
    4, 3 dense, seed 3), exported by the port on the CPU."""
    from torchrec_tpu.modules.embedding_configs import PoolingType
    from torchrec_tpu_torch.inference import export_native

    path = str(tmp_path_factory.mktemp("native_artifact"))
    tables = (
        JConfig(num_embeddings=100, embedding_dim=8, name="t0",
                feature_names=["f0"], pooling=PoolingType.SUM),
        JConfig(num_embeddings=60, embedding_dim=4, name="t1",
                feature_names=["f1"], pooling=PoolingType.SUM),
    )
    rng = np.random.RandomState(3)
    weights = {"t0": rng.randn(100, 8).astype(np.float32),
               "t1": rng.randn(60, 4).astype(np.float32)}
    jpf.package_model(path, tables, weights, NCAPS, num_dense=3,
                      quant_dtype="int8")
    manifest = export_native(path, batch_size=NB, device="cpu")
    return path, manifest


def _flat(dense, f0, f1):
    """One request as example 0 of the export's static batch."""
    vals = np.zeros((4 * NB * 2,), np.int32)
    lens = np.zeros((2 * NB,), np.int32)
    vals[:len(f0)] = f0
    lens[0] = len(f0)
    vals[4 * NB:4 * NB + len(f1)] = f1
    lens[NB] = len(f1)
    d = np.zeros((NB, 3), np.float32)
    d[0] = dense
    return d, vals, lens


def _jax_scores(path, batches):
    """The JAX package's serving function on each (dense, values,
    lengths) batch of the flat layout."""
    import jax.numpy as jnp

    from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT

    fn, _ = jpf.load_packaged_model(path)
    return [np.asarray(fn(d, JKJT(["f0", "f1"], jnp.asarray(v),
                                  jnp.asarray(l), caps=[4 * NB, 4 * NB])))
            .reshape(-1) for d, v, l in batches]


def _tiny_requests(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3).astype(np.float32),
             [rng.randint(0, 100, size=rng.randint(0, 5)).astype(np.int64),
              rng.randint(0, 60, size=rng.randint(0, 5)).astype(np.int64)])
            for _ in range(n)]


def test_export_writes_all_artifacts(native_artifact):
    from torchrec_tpu_torch.inference.predict_factory import (
        package_constant_names,
    )

    path, manifest = native_artifact
    assert manifest["formats"] == ["pt2", "aoti"]
    for name in ("model.pt2", "model_aoti.pt2", "native_manifest.json"):
        assert os.path.exists(os.path.join(path, name))
    assert not os.path.exists(os.path.join(path, "native_manifest.json.tmp"))
    with open(os.path.join(path, "native_manifest.json")) as f:
        mani = json.load(f)
    assert mani == json.loads(json.dumps(manifest))
    assert mani["features"] == ["f0", "f1"] and mani["caps"] == [4, 4]
    assert [i["name"] for i in mani["inputs"]] == ["dense", "values",
                                                   "lengths"]
    assert [i["shape"] for i in mani["inputs"]] == [[NB, 3], [64], [16]]
    assert mani["device"] == "cpu" and mani["batch_size"] == NB
    # exactly the constants the package lists: the tables, nothing folded
    assert mani["constants"] == package_constant_names(
        os.path.join(path, "model_aoti.pt2"))
    assert mani["constants"] == sorted(
        f"serving.quant_ebc.params.{t}.{k}" for t in ("t0", "t1")
        for k in ("q", "scale", "bias"))
    # no table inside the package
    tables = os.path.getsize(os.path.join(path, "tables.npz"))
    assert os.path.getsize(os.path.join(path, "model_aoti.pt2")) < 2**24
    assert tables > 0


def test_pt2_reloads_and_matches_jax(native_artifact):
    """``model.pt2`` round-trips through ``torch.export.load`` and
    matches the JAX serving function (the JAX test's bound)."""
    path, _ = native_artifact
    ep = torch.export.load(os.path.join(path, "model.pt2"))
    rng = np.random.RandomState(0)
    dense = rng.randn(NB, 3).astype(np.float32)
    vals = np.zeros((4 * NB * 2,), np.int32)
    lens = np.zeros((2 * NB,), np.int32)
    vals[0:3] = [5, 9, 77]
    lens[0], lens[1] = 2, 1
    vals[4 * NB] = 13
    lens[NB] = 1
    got = ep.module()(*(torch.from_numpy(x) for x in (dense, vals, lens)))
    ref, = _jax_scores(path, [(dense, vals, lens)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_native_server_no_python_request_path(native_artifact):
    """TCP client -> native queue -> the C++ executor loop -> scores, with
    no Python serving function: within 1e-4 of the JAX package (its
    bound) and within the file's tolerance of the port's eager module."""
    from torchrec_tpu_torch.inference import NativeInferenceServer
    from torchrec_tpu_torch.inference.predict_factory import flat_serving

    path, _ = native_artifact
    srv = NativeInferenceServer(path, max_latency_us=1000)
    assert srv._fn is None
    port = srv.serve(port=0)
    reqs = _tiny_requests(6, seed=1)
    try:
        client = PredictClient(port)
        got = [client.predict(d, ids) for d, ids in reqs]
        client.close()
        stats = srv.loop_stats()
    finally:
        srv.stop()
    assert stats["batches"] >= 1 and stats["failed_batches"] == 0
    batches = [_flat(d, *ids) for d, ids in reqs]
    jax_ref = [s[0] for s in _jax_scores(path, batches)]
    np.testing.assert_allclose(got, jax_ref, rtol=0, atol=1e-4)
    module, _ = flat_serving(path, "cpu", None, NB)
    eager = [float(module(*(torch.from_numpy(x) for x in b))[0])
             for b in batches]
    np.testing.assert_allclose(got, eager, rtol=RTOL, atol=ATOL)


def test_native_server_direct_run_and_in_process_predict(native_artifact):
    """``run`` (one batch straight through the executor) and in-process
    ``predict`` (into the same queue as TCP) give the eager scores."""
    from torchrec_tpu_torch.inference import NativeInferenceServer
    from torchrec_tpu_torch.inference.predict_factory import flat_serving

    path, _ = native_artifact
    srv = NativeInferenceServer(path, max_latency_us=500)
    reqs = _tiny_requests(5, seed=7)
    try:
        batch = _flat(*reqs[0][0:1], *reqs[0][1])
        direct = srv.run(*batch)
        with pytest.raises(ValueError, match="inputs"):
            srv.run(batch[0][:4], *batch[1:])
        srv.start()
        local = [srv.predict(d, ids) for d, ids in reqs]
    finally:
        srv.stop()
    module, _ = flat_serving(path, "cpu", None, NB)
    eager = module(*(torch.from_numpy(x) for x in batch)).numpy()
    np.testing.assert_allclose(direct, eager, rtol=RTOL, atol=ATOL)
    ref = [float(module(*(torch.from_numpy(x)
                          for x in _flat(d, *ids)))[0]) for d, ids in reqs]
    np.testing.assert_allclose(local, ref, rtol=RTOL, atol=ATOL)


def test_native_executor_open_fails_loud(native_artifact, tmp_path):
    """A corrupt package fails at open, with the executor's reason."""
    import shutil

    from torchrec_tpu_torch.inference import NativeInferenceServer

    path, _ = native_artifact
    broken = tmp_path / "broken"
    broken.mkdir()
    for name in ("metadata.json", "tables.npz", "native_manifest.json"):
        shutil.copy(os.path.join(path, name), broken / name)
    (broken / "model_aoti.pt2").write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match="native executor open failed"):
        NativeInferenceServer(str(broken))


def test_native_server_double_stop_is_safe(native_artifact):
    from torchrec_tpu_torch.inference import NativeInferenceServer

    srv = NativeInferenceServer(native_artifact[0], max_latency_us=500)
    srv.serve(port=0)
    srv.stop()
    srv.stop()  # a second stop is a no-op, not a NULL dereference


def test_grpc_over_native_server(native_artifact):
    """The gRPC Predictor front end over ``NativeInferenceServer``:
    requests enter the native queue and the C++ loop answers them."""
    pytest.importorskip("grpc")
    from torchrec_tpu_torch.inference import NativeInferenceServer
    from torchrec_tpu_torch.inference.grpc_server import (
        GrpcInferenceServer,
        GrpcPredictClient,
    )

    path, _ = native_artifact
    srv = GrpcInferenceServer(NativeInferenceServer(path,
                                                    max_latency_us=500))
    port = srv.serve(port=0)
    try:
        client = GrpcPredictClient(port)
        dense = np.random.RandomState(5).randn(3).astype(np.float32)
        out = client.predict(dense, [np.array([4, 9]), np.array([11])])
        empty = client.predict(np.zeros(3, np.float32),
                               [np.zeros(0, np.int64), np.zeros(0, np.int64)])
        client.close()
    finally:
        srv.stop()
    ref = [s[0] for s in _jax_scores(path, [
        _flat(dense, [4, 9], [11]), _flat(np.zeros(3, np.float32), [], [])])]
    np.testing.assert_allclose([out["default"][0], empty["default"][0]], ref,
                               rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def failing_package(native_artifact, tmp_path_factory):
    """The tiny artifact with a package (the second compile) whose run
    raises when a dense feature exceeds 1e6: the flat signature, scores
    ``sum(dense) + lengths' example sums``, through a Python operator
    that the package calls back."""
    import shutil

    path, manifest = native_artifact
    out = str(tmp_path_factory.mktemp("failing"))
    for name in ("metadata.json", "tables.npz"):
        shutil.copy(os.path.join(path, name), os.path.join(out, name))

    @torch.library.custom_op("trt_test::checked_sum", mutates_args=())
    def checked_sum(dense: torch.Tensor) -> torch.Tensor:
        if float(dense.abs().max()) > 1e6:
            raise ValueError("dense feature out of range")
        return dense.sum(-1)

    @checked_sum.register_fake
    def _(dense):
        return dense.new_empty(dense.shape[:1])

    class Flat(torch.nn.Module):
        def forward(self, dense, values, lengths):
            per = lengths.view(2, NB).sum(0).to(torch.float32)
            return checked_sum(dense) + per + values[:1].float() * 0

    ep = torch.export.export(Flat(), (torch.zeros((NB, 3)),
                                      torch.zeros((64,), dtype=torch.int32),
                                      torch.zeros((16,), dtype=torch.int32)))
    torch._inductor.aoti_compile_and_package(
        ep, package_path=os.path.join(out, "model_aoti.pt2"))
    with open(os.path.join(out, "native_manifest.json"), "w") as f:
        json.dump(dict(manifest, constants=[], formats=["aoti"]), f)
    return out


def test_run_error_posts_nan_and_loop_serves_next(failing_package):
    """A batch whose run fails is answered NaN at once (the TCP front end
    turns a NaN into status 1 well before the request timeout) and the
    loop serves the next batch."""
    from torchrec_tpu_torch.inference import NativeInferenceServer

    srv = NativeInferenceServer(failing_package, max_latency_us=500)
    port = srv.serve(port=0)
    try:
        client = PredictClient(port)
        ok1 = client.predict(np.ones(3, np.float32),
                             [np.array([1, 2]), np.array([3])])
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="failed"):
            client.predict(np.full(3, 1e7, np.float32),
                           [np.array([1]), np.zeros(0, np.int64)])
        bad_s = time.perf_counter() - t0
        bad = srv.predict(np.full(3, 1e7, np.float32),
                          [np.zeros(0, np.int64), np.zeros(0, np.int64)])
        ok2 = client.predict(np.full(3, 2.0, np.float32),
                             [np.zeros(0, np.int64), np.array([5])])
        client.close()
        stats = srv.loop_stats()
    finally:
        srv.stop()
    assert ok1 == pytest.approx(3.0 + 3) and ok2 == pytest.approx(6.0 + 1)
    assert np.isnan(bad) and bad_s < 5.0
    assert stats == {"batches": 4, "failed_batches": 2}
