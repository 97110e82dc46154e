"""Port parity for the bucketed serving tier (``inference/
bucketed_serving.py``): the ladder, signatures and admission against the
JAX package's, bucketed programs bitwise equal to the full-pad program
(plain versions on the CPU), the dedup programs bitwise equal to the
others, and served scores against the JAX ``BucketedInferenceServer``.

Tolerance against JAX ``rtol = 1e-5, atol = 1e-6``: the pooled
embeddings agree to the last bits, but the float32 matmuls of XLA and of
PyTorch sum in different orders.  Within the port the comparisons are
bitwise (padding adds +0.0 under SUM pooling and the dedup kernels pool
in slot order like the others)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.inference import predict_factory as jpf
from torchrec_tpu.inference.bucketed_serving import (
    BucketedInferenceServer as JBucketed,
)
from torchrec_tpu.inference.bucketed_serving import (
    BucketedServingCache as JCache,
)
from torchrec_tpu.inference.bucketed_serving import (
    ServingBucketConfig as JConfig,
)
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JTable,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.sparse import KeyedTensor as JKT
from torchrec_tpu_torch.inference import (
    BucketedInferenceServer,
    BucketedServingCache,
    HotRowServingCache,
    ServingBucketConfig,
    build_serving_fn,
    load_packaged_model,
)
from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

RTOL, ATOL = 1e-5, 1e-6
D, NUM_DENSE = 8, 3
FEATURES = ["f_sum", "f_mean", "f2"]
CAPS = [4, 3, 5]
ROWS = [60, 60, 90]
MAX_BATCH = 16


def _tables(cls=EmbeddingBagConfig, pooling=PoolingType):
    return tuple(
        cls(num_embeddings=r, embedding_dim=D, name=f"t{i}",
            feature_names=[f],
            pooling=pooling.MEAN if f == "f_mean" else pooling.SUM)
        for i, (r, f) in enumerate(zip(ROWS, FEATURES)))


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {f"t{i}": rng.randn(r, D).astype(np.float32)
            for i, r in enumerate(ROWS)}


def _gen_batch(rng, n, corrupt=False):
    """One formed batch (n, dense, flat request-major ids, lengths)."""
    dense = rng.randn(n, NUM_DENSE).astype(np.float32)
    lengths = np.stack(
        [rng.randint(0, np.asarray(CAPS) + 1) for _ in range(n)]
    ).astype(np.int32)
    ids = [rng.randint(0, ROWS[f], size=lengths[i, f])
           for i in range(n) for f in range(len(FEATURES))]
    flat = (np.concatenate(ids).astype(np.int64) if lengths.sum()
            else np.zeros((0,), np.int64))
    if corrupt and len(flat):
        k = max(1, len(flat) // 6)
        pos = rng.choice(len(flat), size=k, replace=False)
        flat[pos[: k // 2 + 1]] = 10**6
        flat[pos[k // 2 + 1:]] = -7
        dense[rng.randint(0, n), rng.randint(0, NUM_DENSE)] = np.nan
    return n, dense, flat, lengths


def _server(fn, config, dedup, **kw):
    return BucketedInferenceServer(
        fn, FEATURES, CAPS, NUM_DENSE, max_batch_size=MAX_BATCH,
        max_latency_us=500, feature_rows=ROWS, degrade_on_bad_input=True,
        bucket_config=config, dedup=dedup, **kw)


def _emb_only_fn(data_type=DataType.INT8):
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights(),
                                                  data_type)
    return build_serving_fn(None, qebc, apply_sigmoid=False, device="cpu")


class _Nothing(torch.nn.Module):
    device = torch.device("cpu")


# ---------------------------------------------------------------------------
# ladder / signature / admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(max_programs=4),
    dict(batch_floor=2, batch_growth=3.0, id_floor=4, max_programs=6),
    dict(max_programs=1),
])
def test_signature_and_resolve_match_jax(cfg):
    """The same seeded sequence of formed batches gives the JAX cache's
    signatures, admissions, fallbacks and fallback counts."""
    j = JCache(lambda d, k: None, FEATURES, CAPS, NUM_DENSE, MAX_BATCH,
               config=JConfig(**cfg))
    t = BucketedServingCache(_Nothing(), FEATURES, CAPS, NUM_DENSE,
                             MAX_BATCH, config=ServingBucketConfig(**cfg))
    assert t.full_signature == j.full_signature
    rng = np.random.RandomState(3)
    for _ in range(60):
        n = int(rng.randint(1, MAX_BATCH + 1))
        occ = [int(rng.randint(0, c * n + 1)) for c in CAPS]
        sig = t.signature(n, occ)
        assert sig == j.signature(n, occ)
        assert t.resolve(sig) == j.resolve(sig)
    names = ("serving/program_fallback_count",)
    assert [t.metrics.value(x) if x in t.metrics.names() else 0
            for x in names] == [j.metrics.value(x) if x in j.metrics.names()
                                else 0 for x in names]
    assert ServingBucketConfig.full_pad() == ServingBucketConfig(
        **JConfig.full_pad().__dict__)


def test_program_count_bounded_and_warmed():
    fn = _emb_only_fn()
    srv = _server(fn, ServingBucketConfig(max_programs=3), dedup=False)
    srv.warmup([(2, (8, 8, 8))])
    assert srv.cache.program_count == 2
    rng = np.random.RandomState(4)
    for n in (1, 3, 5, 9, 16, 2, 7):
        srv._run_batch(*_gen_batch(rng, n))
    m = srv.metrics
    assert srv.cache.program_count <= 3
    assert m.value("serving/program_count") == srv.cache.program_count
    assert m.value("serving/program_compile_count") == (
        srv.cache.program_count)
    assert m.value("serving/bucketed_dispatch_count") == 7
    assert m.value("serving/program_fallback_count") >= 1
    with pytest.raises(ValueError, match="called with batch"):
        srv.cache.run(srv.cache.full_signature,
                      *srv.cache.example_inputs((2, (8, 8, 8))))


# ---------------------------------------------------------------------------
# bitwise: bucketed == full pad, dedup == the other kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data_type", [DataType.INT8, DataType.INT4,
                                       DataType.BF16])
def test_bucketed_scores_bitwise_full_pad(data_type):
    """Batch sizes x ragged lengths x degraded inputs: every bucketed
    program (dedup on and off) gives the full-pad program's scores and
    degradation reasons, bitwise."""
    fn = _emb_only_fn(data_type)
    full = _server(fn, ServingBucketConfig.full_pad(), dedup=False)
    arms = [_server(fn, ServingBucketConfig(max_programs=4), dedup=d)
            for d in (False, True)]
    rng = np.random.RandomState(5)
    for n in (1, 2, 5, 9, 16):
        for corrupt in (False, True):
            batch = _gen_batch(rng, n, corrupt)
            s_full, r_full = full._run_batch(*batch)
            for srv in arms:
                s, r = srv._run_batch(*batch)
                assert np.array_equal(s, s_full), (n, corrupt, srv.cache.dedup)
                assert r == r_full
    for srv in arms:
        assert srv.cache.program_count <= 4


@pytest.mark.parametrize("data_type", [DataType.INT8, DataType.INT2,
                                       DataType.FP16, DataType.BF16])
def test_dedup_program_pools_like_the_other_kernel(data_type):
    """A program's pooled KeyedTensor: the dedup kernels' (B5, B4) equal
    to the other kernels' (B3, B1; B5 itself for int4/int2) bitwise, at
    every signature the batches resolve to, and to the full-pad
    program's rows."""
    fn = _emb_only_fn(data_type)
    caches = {d: BucketedServingCache(
        fn, FEATURES, CAPS, NUM_DENSE, MAX_BATCH,
        ServingBucketConfig(max_programs=5), dedup=d) for d in (False, True)}
    assert caches[True]._fn.quant_ebc.lookup_kernel == "dedup"
    assert caches[False]._fn is fn
    srv = _server(fn, ServingBucketConfig.full_pad(), dedup=False)
    rng = np.random.RandomState(6)
    for n in (1, 4, 11):
        n, dense, ids, lengths = _gen_batch(rng, n)
        sig = caches[True].resolve(caches[True].signature(
            n, lengths.sum(axis=0)))
        d, kjt = srv._device_inputs(n, dense, ids, lengths, sig[0],
                                    list(sig[1]))
        for x in (True, False):
            caches[x].run(caches[x].resolve(sig), d, kjt)
        kts = [caches[x].fn.quant_ebc(kjt) for x in (True, False)]
        assert torch.equal(kts[0].values(), kts[1].values())
        fd, fkjt = srv._device_inputs(n, dense, ids, lengths, MAX_BATCH,
                                      [c * MAX_BATCH for c in CAPS])
        full = fn.quant_ebc(fkjt).values()
        assert torch.equal(kts[0].values()[:n], full[:n])


# ---------------------------------------------------------------------------
# against the JAX server
# ---------------------------------------------------------------------------


def _jax_dlrm():
    import jax

    jtables = _tables(JTable, JPooling)
    model = JDLRM(
        embedding_bag_collection=EmbeddingBagCollection(tables=jtables),
        dense_in_features=NUM_DENSE, dense_arch_layer_sizes=(16, D),
        over_arch_layer_sizes=(16, 1))
    kt0 = JKT(FEATURES, [D] * 3, jnp.zeros((1, 3 * D)))
    params = model.init(jax.random.key(1), jnp.zeros((1, NUM_DENSE)), kt0,
                        method=JDLRM.forward_from_embeddings)
    return jtables, params


@pytest.mark.parametrize("dedup", [False, True])
def test_bucketed_scores_match_jax(tmp_path, dedup):
    """One DLRM artifact served by the JAX bucketed server and the port's
    (the same bucket policy, dedup on and off): scores within the stated
    tolerance, reasons and signatures equal."""
    jtables, params = _jax_dlrm()
    path = str(tmp_path / "artifact")
    jpf.package_model(path, jtables, _weights(), dict(zip(FEATURES, CAPS)),
                      NUM_DENSE, dense_params=params,
                      model_config={"arch": "dlrm",
                                    "dense_arch_layer_sizes": [16, D],
                                    "over_arch_layer_sizes": [16, 1]})
    jfn, _ = jpf.load_packaged_model(path)
    tfn, _ = load_packaged_model(path, device="cpu")
    kw = dict(max_batch_size=MAX_BATCH, max_latency_us=500,
              feature_rows=ROWS, degrade_on_bad_input=True, queue="python")
    jsrv = JBucketed(jfn, FEATURES, CAPS, NUM_DENSE,
                     bucket_config=JConfig(max_programs=3), dedup=dedup, **kw)
    tsrv = BucketedInferenceServer(
        tfn, FEATURES, CAPS, NUM_DENSE,
        bucket_config=ServingBucketConfig(max_programs=3), dedup=dedup, **kw)
    rng = np.random.RandomState(7)
    for n in (1, 6, 16, 3):
        for corrupt in (False, True):
            batch = _gen_batch(rng, n, corrupt)
            s_j, r_j = jsrv._run_batch(*batch)
            s_t, r_t = tsrv._run_batch(*batch)
            np.testing.assert_allclose(s_t, s_j, rtol=RTOL, atol=ATOL)
            assert r_t == r_j
    assert sorted(tsrv.cache._programs) == sorted(jsrv.cache._programs)


def test_bucketed_end_to_end_native_queue():
    """Concurrent clients through the native queue against the bucketed
    tier: per-request scores equal the full-pad module's on one batch."""
    fn = _emb_only_fn()
    srv = _server(fn, ServingBucketConfig(max_programs=6), dedup=True)
    srv.warmup()
    rng = np.random.RandomState(8)
    reqs = []
    for _ in range(40):
        ids = [rng.randint(0, r, size=(rng.randint(0, c + 1),))
               for r, c in zip(ROWS, CAPS)]
        reqs.append((rng.rand(NUM_DENSE).astype(np.float32), ids))
    got = {}

    def client(k):
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
    full = _server(fn, ServingBucketConfig.full_pad(), dedup=False)
    lengths = np.asarray([[len(x) for x in ids] for _, ids in reqs],
                         np.int32)
    flat = np.concatenate([np.concatenate(ids) for _, ids in reqs])
    ref = []
    for i in range(0, len(reqs), MAX_BATCH):
        n = min(MAX_BATCH, len(reqs) - i)
        lo = int(lengths[:i].sum())
        hi = lo + int(lengths[i:i + n].sum())
        ref += list(full._run_batch(
            n, np.stack([d for d, _ in reqs[i:i + n]]), flat[lo:hi],
            lengths[i:i + n])[0])
    assert np.array_equal(np.asarray([got[i] for i in range(len(reqs))],
                                     np.float32), np.asarray(ref))


# ---------------------------------------------------------------------------
# arguments
# ---------------------------------------------------------------------------


def test_dedup_kinds_options_and_hot_rows():
    fn = _emb_only_fn()
    for kind in (True, "xla_dedup", "pallas_dedup"):
        c = BucketedServingCache(fn, FEATURES, CAPS, NUM_DENSE, 4,
                                 dedup=kind)
        assert c.dedup and c._fn.quant_ebc.lookup_kernel == "dedup"
    assert BucketedServingCache(fn, FEATURES, CAPS, NUM_DENSE, 4,
                                dedup="xla_dedup").dedup_kernel == "xla_dedup"
    with pytest.raises(ValueError, match="not a dedup kernel kind"):
        BucketedServingCache(fn, FEATURES, CAPS, NUM_DENSE, 4, dedup="pallas")
    with pytest.raises(ValueError, match="no counterpart"):
        BucketedServingCache(fn, FEATURES, CAPS, NUM_DENSE, 4, dedup=True,
                             dedup_opts={"interpret": True})
    # a hot-row cache makes the programs take its tensors as a third
    # argument, their zeros of its shapes in a warm-up
    hot = HotRowServingCache.from_host_weights(
        {"big": np.ones((40, 4), np.float32)}, {"big": 8}, {"f1": "big"},
        device="cpu")
    srv = _server(_Nothing(), None, dedup=False, hot_rows=hot)
    assert srv._hot is hot
    extra = srv.cache.example_inputs(srv.cache.full_signature)[2]
    assert torch.equal(extra["big"], torch.zeros((8, 4)))
    with pytest.raises(TypeError, match="with_lookup_kernel"):
        BucketedServingCache(_Nothing(), FEATURES, CAPS, NUM_DENSE, 4,
                             dedup=True)
    # the dedup view shares the tables: nothing copied
    view = fn.with_lookup_kernel("dedup")
    assert view.quant_ebc.params["t0"].q.data_ptr() == (
        fn.quant_ebc.params["t0"].q.data_ptr())
