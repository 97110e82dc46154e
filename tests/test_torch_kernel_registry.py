"""The port's process-wide kernel registry (``ops/embedding_ops.py``,
``ops/quant_ops.py``, ``ops/fused_update.py``) against the JAX package's:
the names, their mapping onto the port's kernels (no name selects a plain
version), the precedence of an explicit kernel, ``trace_kernels``
restoring the previous selection and options, the reentrant lock, the
environment overrides, and ``dequantize_rowwise_int8``."""

import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import embedding_ops as jeo
from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import quant_ops as jqo
from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.ops import embedding_ops as teo
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import quant_ops as tqo
from torchrec_tpu_torch.quant.embedding_modules import (
    QuantEmbeddingBagCollection,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_match_jax_and_map_onto_kernels():
    assert teo.POOLED_KERNELS == jeo.POOLED_KERNELS
    assert tqo.QUANT_KERNELS == jqo.QUANT_KERNELS
    assert tfu.UPDATE_KERNELS == jfu.UPDATE_KERNELS
    assert teo.get_pooled_lookup_kernel() == jeo.get_pooled_lookup_kernel()
    assert tqo.get_quant_lookup_kernel() == jqo.get_quant_lookup_kernel()
    assert tfu.get_sparse_update_kernel() == jfu.get_sparse_update_kernel()
    want_pooled = {"xla": "tbe", "pallas": "tbe", "xla_dedup": "dedup",
                   "pallas_dedup": "dedup"}
    want_update = {"xla": "tbe", "pallas": "tbe", "pallas_dedup": "dedup"}
    want_quant = {"xla": None, "pallas": None, "xla_dedup": "dedup",
                  "pallas_dedup": "dedup"}  # None: the per-table default
    for name in teo.POOLED_KERNELS:
        with teo.trace_kernels(pooled=name):
            assert teo.resolve_lookup_kernel(None) == want_pooled[name]
    for name in tfu.UPDATE_KERNELS:
        with teo.trace_kernels(update=name):
            assert tfu.resolve_update_kernel(None) == want_update[name]
    for name in tqo.QUANT_KERNELS:
        with teo.trace_kernels(quant=name):
            assert tqo.resolve_quant_kernel(None) == want_quant[name]
    # an explicit kernel keeps the port's names; a JAX name raises there
    assert teo.resolve_lookup_kernel("dedup") == "dedup"
    for fn in (teo.resolve_lookup_kernel, tfu.resolve_update_kernel,
               tqo.resolve_quant_kernel):
        with pytest.raises(ValueError):
            fn("xla")
    # every name lands on a kernel of the port, never a plain version
    assert set(teo.POOLED_KERNEL_MAP.values()) <= set(teo.LOOKUP_KERNELS)
    assert set(tfu.UPDATE_KERNEL_MAP.values()) <= set(tfu.FUSED_KERNELS)
    for bad in ("plain", "xla_plain"):
        with pytest.raises(ValueError):
            teo.set_pooled_lookup_kernel(bad)
        with pytest.raises(ValueError):
            tfu.set_sparse_update_kernel(bad)
        with pytest.raises(ValueError):
            tqo.set_quant_lookup_kernel(bad)


def _dmp(**kw):
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = [EmbeddingBagConfig(num_embeddings=20, embedding_dim=8,
                                 name="t0", feature_names=["f0"])]
    ebc = EmbeddingBagCollection(tables, device="meta", kernel="tbe")
    model = DLRM(ebc, 4, (8,), (8, 1))
    return DistributedModelParallel(
        model, tables, table_wise_plan(tables), 4, {"f0": 4},
        device="cpu", **kw)


def test_registry_read_at_build_and_explicit_wins():
    tables = [EmbeddingBagConfig(num_embeddings=20, embedding_dim=8,
                                 name="t0", feature_names=["f0"])]
    default = _dmp()
    assert (default.lookup_kernel, default.update_kernel) == ("tbe", "tbe")
    with teo.trace_kernels(pooled="pallas_dedup", update="pallas_dedup"):
        dmp = _dmp()
        explicit = _dmp(lookup_kernel="tbe", update_kernel="tbe")
        ebc = EmbeddingBagCollection(tables, device="meta")
        assert ebc.kernel == "dedup"
    assert (dmp.lookup_kernel, dmp.update_kernel) == ("dedup", "dedup")
    assert (explicit.lookup_kernel, explicit.update_kernel) == ("tbe", "tbe")
    # a bucketed signature's clone reads the registry again unless the
    # DMP named its kernels
    with teo.trace_kernels(pooled="xla_dedup"):
        assert default.with_feature_caps({"f0": 2}).lookup_kernel == "dedup"
        assert explicit.with_feature_caps({"f0": 2}).lookup_kernel == "tbe"
    assert default.with_feature_caps({"f0": 2}).lookup_kernel == "tbe"
    q = {"t0": {"q": torch.zeros((20, 8), dtype=torch.uint8),
                "scale": torch.ones(20), "bias": torch.zeros(20)}}
    qt = [EmbeddingBagConfig(num_embeddings=20, embedding_dim=8, name="t0",
                             feature_names=["f0"], data_type=DataType.INT8)]
    assert QuantEmbeddingBagCollection(qt, q)._kernels["t0"] == "tbe"
    with teo.trace_kernels(quant="pallas_dedup"):
        assert QuantEmbeddingBagCollection(qt, q)._kernels["t0"] == "dedup"
        assert QuantEmbeddingBagCollection(qt, q, lookup_kernel="tbe"
                                           )._kernels["t0"] == "tbe"


def test_trace_kernels_restores_selection_and_options():
    teo.set_pooled_lookup_kernel("xla_dedup", chunk=64, u_cap=7)
    tfu.set_sparse_update_kernel("pallas", group=4)
    try:
        before = (dict(teo._PALLAS_OPTS), dict(teo._PALLAS_DEDUP_OPTS),
                  dict(tfu._UPDATE_PALLAS_OPTS), dict(tqo._QUANT_DEDUP_OPTS))
        with teo.trace_kernels(pooled="pallas", quant="pallas_dedup",
                               update="pallas_dedup", interpret=True,
                               id_cap=32):
            assert teo.get_pooled_lookup_kernel() == "pallas"
            assert tqo.get_quant_lookup_kernel() == "pallas_dedup"
            assert tfu.get_sparse_update_kernel() == "pallas_dedup"
            assert teo._PALLAS_OPTS["interpret"] is True
            assert tfu._UPDATE_DEDUP_OPTS["id_cap"] == 32
        assert teo.get_pooled_lookup_kernel() == "xla_dedup"
        assert tqo.get_quant_lookup_kernel() == "xla"
        assert tfu.get_sparse_update_kernel() == "pallas"
        assert (dict(teo._PALLAS_OPTS), dict(teo._PALLAS_DEDUP_OPTS),
                dict(tfu._UPDATE_PALLAS_OPTS),
                dict(tqo._QUANT_DEDUP_OPTS)) == before
        with pytest.raises(RuntimeError):
            with teo.trace_kernels(pooled="xla"):
                raise RuntimeError("restored on the way out")
        assert teo.get_pooled_lookup_kernel() == "xla_dedup"
    finally:
        teo.set_pooled_lookup_kernel("xla")
        tfu.set_sparse_update_kernel("xla")


def test_lock_is_reentrant_and_serializes():
    with teo.TRACE_KERNEL_LOCK:
        with teo.trace_kernels(pooled="pallas"):  # takes it again
            teo.set_pooled_lookup_kernel("xla_dedup")
            tfu.set_sparse_update_kernel("pallas_dedup")
        assert teo.get_pooled_lookup_kernel() == "xla"
    seen = []
    with teo.TRACE_KERNEL_LOCK:
        t = threading.Thread(target=lambda: seen.append(
            teo.set_pooled_lookup_kernel("pallas")))
        t.start()
        t.join(0.2)
        assert t.is_alive() and teo.get_pooled_lookup_kernel() == "xla"
    t.join()
    assert teo.get_pooled_lookup_kernel() == "pallas"
    teo.set_pooled_lookup_kernel("xla")


def test_environment_overrides():
    code = ("from torchrec_tpu_torch.ops import embedding_ops as e, "
            "fused_update as f, quant_ops as q; "
            "print(e.get_pooled_lookup_kernel(), "
            "f.get_sparse_update_kernel(), q.get_quant_lookup_kernel())")
    env = dict(os.environ, TORCHREC_TPU_POOLED_KERNEL="pallas_dedup",
               TORCHREC_TPU_SPARSE_UPDATE_KERNEL="pallas_dedup",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["pallas_dedup", "pallas_dedup", "xla"], (
        out.stderr[-2000:])


def test_dequantize_rowwise_int8_equals_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(50, 16).astype(np.float32)
    q, scale, bias = tqo.quantize_rowwise_int8(torch.from_numpy(w))
    jq, js, jb = jqo.quantize_rowwise_int8(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    got = tqo.dequantize_rowwise_int8(q, scale, bias)
    want = jqo.dequantize_rowwise_int8(jq, js, jb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), w, atol=float(scale.max()))
