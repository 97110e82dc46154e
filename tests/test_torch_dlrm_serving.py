"""Port parity for quantized DLRM serving: the dense model carried across
from flax, artifacts read and written by both packages, the serving
module behind the dynamic-batching server, and the device rules.

Tolerance for scores ``rtol = 1e-5, atol = 1e-6``: the pooled embeddings
agree to the last bits, but the float32 matmuls of XLA and of PyTorch sum
in different orders."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.inference import predict_factory as jpf
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JConfig,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import KeyedTensor as JKT
from torchrec_tpu_torch.convert import (
    dense_leaves_from_flax_order,
    dense_leaves_to_flax_order,
    dlrm_state_dict_from_flax,
)
from torchrec_tpu_torch.inference import (
    InferenceServer,
    build_serving_fn,
    load_packaged_model,
    package_model,
)
from torchrec_tpu_torch.models.dlrm import DLRM as TDLRM
from torchrec_tpu_torch.models.dlrm import load_dense_state_dict
from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection
from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT
from torchrec_tpu_torch.sparse import KeyedTensor as TKT

RTOL, ATOL = 1e-5, 1e-6
D, NUM_DENSE = 8, 5
ROWS = [60, 40, 100]
FEATURES = ["f0", "f1", "f2"]
CAPS = [3, 2, 4]
DENSE_ARCH = (16, D)
OVER_ARCH = (32, 16, 1)


def _tables(cls=EmbeddingBagConfig, pooling=PoolingType):
    return tuple(
        cls(num_embeddings=r, embedding_dim=D, name=f"t{i}",
            feature_names=[f],
            pooling=pooling.MEAN if i == 1 else pooling.SUM)
        for i, (r, f) in enumerate(zip(ROWS, FEATURES))
    )


def _port_dlrm():
    """The port's DLRM over a collection on meta (serving's lookup is the
    quantized collection's)."""
    return TDLRM(TEBC(_tables(), device="meta"), NUM_DENSE, DENSE_ARCH,
                 OVER_ARCH)


def _jax_dlrm(dense_arch=DENSE_ARCH, over_arch=OVER_ARCH, seed=1):
    jtables = _tables(JConfig, JPooling)
    model = JDLRM(
        embedding_bag_collection=EmbeddingBagCollection(tables=jtables),
        dense_in_features=NUM_DENSE,
        dense_arch_layer_sizes=dense_arch,
        over_arch_layer_sizes=over_arch,
    )
    kt0 = JKT(FEATURES, [D] * len(FEATURES),
              jnp.zeros((1, D * len(FEATURES))))
    params = model.init(jax.random.key(seed), jnp.zeros((1, NUM_DENSE)),
                        kt0, method=JDLRM.forward_from_embeddings)
    return model, jtables, params


def _batch(seed, B=6):
    rng = np.random.RandomState(seed)
    lengths = np.concatenate(
        [rng.randint(0, c + 1, size=(B,)) for c in CAPS]
    ).astype(np.int32)
    values = np.concatenate([
        rng.randint(0, r, size=(int(lengths[f * B:(f + 1) * B].sum()),))
        for f, r in enumerate(ROWS)
    ]).astype(np.int64)
    caps = [c * B for c in CAPS]
    dense = rng.rand(B, NUM_DENSE).astype(np.float32)
    return (JKJT.from_lengths_packed(FEATURES, values, lengths, caps=caps),
            TKJT.from_lengths_packed(FEATURES, values, lengths, caps=caps),
            dense)


def _weights(seed=2):
    rng = np.random.RandomState(seed)
    return {f"t{i}": rng.randn(r, D).astype(np.float32)
            for i, r in enumerate(ROWS)}


def _model_config():
    return {"arch": "dlrm", "dense_arch_layer_sizes": list(DENSE_ARCH),
            "over_arch_layer_sizes": list(OVER_ARCH)}


def test_tril_indices_pair_order():
    for F in (1, 2, 5, 27):
        li, lj = jnp.tril_indices(F, k=-1)
        t = torch.tril_indices(F, F, offset=-1)
        np.testing.assert_array_equal(np.asarray(li), t[0].numpy())
        np.testing.assert_array_equal(np.asarray(lj), t[1].numpy())


def test_forward_from_embeddings_matches_flax():
    model, _, params = _jax_dlrm()
    np_params = jax.tree.map(np.asarray, params)
    port = _port_dlrm()
    load_dense_state_dict(port, dlrm_state_dict_from_flax(np_params))
    rng = np.random.RandomState(4)
    B = 7
    dense = rng.randn(B, NUM_DENSE).astype(np.float32)
    emb = rng.randn(B, D * len(FEATURES)).astype(np.float32)
    ref = np.asarray(model.apply(
        params, jnp.asarray(dense), JKT(FEATURES, [D] * 3, jnp.asarray(emb)),
        method=JDLRM.forward_from_embeddings,
    ))
    with torch.no_grad():
        got = port.forward_from_embeddings(
            torch.from_numpy(dense), TKT(FEATURES, [D] * 3,
                                         torch.from_numpy(emb))
        ).numpy()
    assert got.shape == ref.shape == (B, 1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_dense_leaves_in_flatten_order():
    """12 dense-arch layers make ``Perceptron_10`` sort before
    ``Perceptron_2``; the over arch's final ``Dense_0`` sorts before its
    ``MLP_0``."""
    dense_arch = (8,) * 11 + (D,)
    _, _, params = _jax_dlrm(dense_arch=dense_arch)
    np_params = jax.tree.map(np.asarray, params)
    leaves = jax.tree.flatten(np_params)[0]
    sd = dlrm_state_dict_from_flax(np_params)
    back = dense_leaves_to_flax_order(sd)
    assert len(back) == len(leaves)
    for a, b in zip(leaves, back):
        np.testing.assert_array_equal(a, b)
    sd2 = dense_leaves_from_flax_order(leaves, sd.keys())
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd[k], sd2[k])
    with pytest.raises(ValueError):
        dense_leaves_from_flax_order(leaves[:-1], sd.keys())


@pytest.mark.parametrize("quant_dtype", ["int8", "int4"])
def test_jax_artifact_served_by_port(tmp_path, quant_dtype):
    model, jtables, params = _jax_dlrm()
    path = str(tmp_path / "jax_artifact")
    jpf.package_model(
        path, jtables, _weights(), dict(zip(FEATURES, CAPS)), NUM_DENSE,
        quant_dtype=quant_dtype, dense_params=params,
        model_config=_model_config(),
    )
    jfn, _ = jpf.load_packaged_model(path)
    tfn, meta = load_packaged_model(path, device="cpu")
    assert meta["quant_dtype"] == quant_dtype
    for seed in (5, 6):
        jkjt, tkjt, dense = _batch(seed)
        ref = np.asarray(jfn(jnp.asarray(dense), jkjt))
        got = tfn(torch.from_numpy(dense), tkjt).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant_dtype", ["int8", "int2"])
def test_port_artifact_served_by_jax(tmp_path, quant_dtype):
    _, _, params = _jax_dlrm(seed=3)
    port = _port_dlrm()
    load_dense_state_dict(
        port, dlrm_state_dict_from_flax(jax.tree.map(np.asarray, params))
    )
    path = str(tmp_path / "port_artifact")
    package_model(
        path, _tables(), _weights(), dict(zip(FEATURES, CAPS)), NUM_DENSE,
        quant_dtype=quant_dtype, dense_state_dict=port.state_dict(),
        model_config=_model_config(),
    )
    jfn, jmeta = jpf.load_packaged_model(path)
    tfn, _ = load_packaged_model(path, device="cpu")
    assert jmeta["quant_dtype"] == quant_dtype
    jkjt, tkjt, dense = _batch(7)
    ref = np.asarray(jfn(jnp.asarray(dense), jkjt))
    got = tfn(torch.from_numpy(dense), tkjt).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_artifact_dense_weights_hold_no_table(tmp_path):
    """``package_model`` given a whole model's state dict writes its dense
    leaves only, and the loaded DLRM's collection stays on meta."""
    port = _port_dlrm()
    path = str(tmp_path / "artifact")
    package_model(path, _tables(), _weights(), dict(zip(FEATURES, CAPS)),
                  NUM_DENSE, dense_state_dict=port.state_dict(),
                  model_config=_model_config())
    with np.load(f"{path}/dense.npz") as blob:
        assert len(blob.files) == sum(
            not k.startswith("sparse_arch.") for k in port.state_dict())
    tfn, _ = load_packaged_model(path, device="cpu")
    assert tfn.model.embedding_bag_collection.is_meta


def test_embedding_only_artifact(tmp_path):
    path = str(tmp_path / "emb_only")
    package_model(path, _tables(), _weights(), dict(zip(FEATURES, CAPS)),
                  NUM_DENSE)
    jfn, _ = jpf.load_packaged_model(path)
    tfn, _ = load_packaged_model(path, device="cpu")
    jkjt, tkjt, dense = _batch(8)
    np.testing.assert_allclose(
        tfn(torch.from_numpy(dense), tkjt).numpy(),
        np.asarray(jfn(jnp.asarray(dense), jkjt)), rtol=RTOL, atol=ATOL,
    )


def test_inference_server_matches_direct_calls():
    """Four client threads through the python batching queue; every
    score equals the serving module's own on the same request."""
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    model = _port_dlrm()
    fn = build_serving_fn(model, qebc, device="cpu")
    srv = InferenceServer(fn, FEATURES, CAPS, NUM_DENSE, max_batch_size=4,
                          max_latency_us=500, queue="python")
    rng = np.random.RandomState(9)
    reqs = []
    for _ in range(24):
        ids = [rng.randint(0, r, size=(rng.randint(0, c + 1),))
               for r, c in zip(ROWS, CAPS)]
        reqs.append((rng.rand(NUM_DENSE).astype(np.float32), ids))
    results = {}

    def client(k):
        for i in range(k, len(reqs), 4):
            results[i] = srv.predict(*reqs[i])

    srv.start()
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        srv.stop()
    errors = srv.metrics.snapshot().get("serving/executor_error_count", 0)
    assert errors == 0
    assert srv.metrics.value("serving/request_count") == len(reqs)
    # direct: all requests as one batch (rows are independent)
    B = len(reqs)
    lengths = np.asarray([[len(x) for x in ids] for _, ids in reqs],
                         np.int32)
    values = np.concatenate([np.asarray(reqs[i][1][f], np.int64)
                             for f in range(3) for i in range(B)])
    kjt = TKJT.from_lengths_packed(FEATURES, values, lengths.T.reshape(-1),
                                   caps=[c * B for c in CAPS])
    dense = torch.from_numpy(np.stack([d for d, _ in reqs]))
    direct = fn(dense, kjt).numpy()
    got = np.asarray([results[i] for i in range(B)], np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, direct, rtol=RTOL, atol=ATOL)


def test_degraded_requests_match_jax_server(tmp_path):
    """Graceful degradation (``_sanitize_requests`` and the truncation in
    ``predict_ex``) gives the JAX server's scores, flags and reasons on
    the same artifact; ``drain`` then answers everything and stops."""
    from torchrec_tpu.inference.serving import InferenceServer as JServer

    model, jtables, params = _jax_dlrm()
    path = str(tmp_path / "artifact")
    jpf.package_model(
        path, jtables, _weights(), dict(zip(FEATURES, CAPS)), NUM_DENSE,
        dense_params=params, model_config=_model_config(),
    )
    jfn, _ = jpf.load_packaged_model(path)
    tfn, _ = load_packaged_model(path, device="cpu")
    rng = np.random.RandomState(11)
    reqs = []
    for i in range(12):
        dense = rng.rand(NUM_DENSE).astype(np.float32)
        ids = [rng.randint(0, r, size=(rng.randint(0, c + 1),))
               for r, c in zip(ROWS, CAPS)]
        if i % 4 == 1:  # out-of-range and negative ids: dropped
            ids[0] = np.concatenate([ids[0], [ROWS[0] + 3, -2]])[-CAPS[0]:]
        if i % 4 == 2:  # non-finite dense: zeroed
            dense[1] = np.nan
        if i % 4 == 3:  # over capacity: truncated
            ids[2] = rng.randint(0, ROWS[2], size=(CAPS[2] + 2,))
        reqs.append((dense, ids))
    kw = dict(max_batch_size=4, max_latency_us=500, feature_rows=ROWS,
              degrade_on_bad_input=True, queue="python")
    answers = []
    for srv in (JServer(jfn, FEATURES, CAPS, NUM_DENSE, **kw),
                InferenceServer(tfn, FEATURES, CAPS, NUM_DENSE, **kw)):
        srv.start()
        try:
            answers.append([srv.predict_ex(d, ids) for d, ids in reqs])
        finally:
            assert srv.drain(deadline_s=5.0)
        errors = srv.metrics.snapshot().get("serving/executor_error_count", 0)
    assert errors == 0
    (jans, tans) = answers
    assert [a[1:] for a in tans] == [a[1:] for a in jans]
    assert sum(a[1] for a in tans) == 9
    np.testing.assert_allclose([a[0] for a in tans], [a[0] for a in jans],
                               rtol=RTOL, atol=ATOL)


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without a card and without device="cpu", the entry points raise
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "a")
    package_model(path, _tables(), _weights(), dict(zip(FEATURES, CAPS)),
                  NUM_DENSE)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_packaged_model(path)
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_serving_fn(None, qebc)
    with pytest.raises(RuntimeError, match="CUDA"):
        qebc.to()
    with pytest.raises(RuntimeError, match="CUDA"):
        qebc.to("cuda")
    assert qebc.to("cpu").device.type == "cpu"


def test_quant_ebc_kernel_rules():
    """int4/int2 tables take the dedup kernel only; int8 and the FP16/BF16
    serving tables take either, and both kernels give the same bits."""
    tables, w = _tables(), _weights()
    with pytest.raises(ValueError):
        QuantEmbeddingBagCollection.from_float(tables, w, DataType.INT4,
                                               lookup_kernel="tbe")
    _, tkjt, _ = _batch(10)
    for dt in (DataType.INT8, DataType.FP16, DataType.BF16):
        tbe_kt = QuantEmbeddingBagCollection.from_float(
            tables, w, dt, lookup_kernel="tbe")(tkjt)
        dedup_kt = QuantEmbeddingBagCollection.from_float(
            tables, w, dt, lookup_kernel="dedup")(tkjt)
        assert tbe_kt.values().dtype == torch.float32
        assert torch.equal(tbe_kt.values(), dedup_kt.values()), dt


def test_server_rejects_other_queues():
    """The JAX contract: an unknown queue kind raises, and ``"native"``
    (the default) serves."""
    qebc = QuantEmbeddingBagCollection.from_float(_tables(), _weights())
    fn = build_serving_fn(None, qebc, device="cpu")
    with pytest.raises(ValueError, match="unknown queue kind"):
        InferenceServer(fn, FEATURES, CAPS, NUM_DENSE, queue="bogus")
    _, tkjt, dense = _batch(12, B=1)
    srv = InferenceServer(fn, FEATURES, CAPS, NUM_DENSE)
    srv.start()
    try:
        ids = [tkjt[f].values()[:int(tkjt[f].lengths()[0])].numpy()
               for f in FEATURES]
        score = srv.predict(dense[0], ids)
    finally:
        srv.stop()
    assert score == pytest.approx(
        float(fn(torch.from_numpy(dense), tkjt)[0]), rel=RTOL, abs=ATOL)
