"""Port parity for capacity bucketing and the bucketed train pipeline: the
ladder arithmetic, the KJT repack, the Zipf options of
``RandomRecDataset``, the step cache's admission rule, and the slice as a
whole, the port's ``BucketedTrainPipeline`` on the dedup kernel family
against the JAX one on its Pallas dedup kernels in interpret mode, at one
device.

Tolerances, with their reasons:

* The ladder, the repack and the dataset: exact.
* The pipeline against JAX (3 steps, float32 tables and dense): losses
  ``atol = 1e-6``, tables ``atol = 2e-6``, optimizer states ``rtol =
  1e-5`` (and ``atol = 1e-9`` for entries near zero), dense parameters
  ``atol = 1e-6``: XLA and PyTorch sum the matmuls in different orders,
  and rowwise Adagrad's mean over D reduces in another order in the port
  (``tests/test_torch_dedup_tbe.py``).  With Adam, at most one table
  element in 10,000 may differ by up to ``1e-5``: where a column's
  gradient is about 1e-9, ``v`` is about 1e-18 and ``sqrt(v)`` meets
  ``eps``, so Adam turns the dense side's last-bit differences in ``m``
  (relative 1e-3 at 1e-9, within the states' ``atol``) into ``lr``-sized
  steps of the direction (measured: one element of 64,000 off by
  8.3e-6).
* The bucketed pipeline against the full-capacity step in the port:
  bitwise (every rung holds its key's ids, so only padding differs).
"""

import itertools

import jax
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.planner.planners import EmbeddingShardingPlanner
from torchrec_tpu.parallel.train_pipeline import (
    BucketedTrainPipeline as JBucketed,
)
from torchrec_tpu.parallel.train_pipeline import BucketingConfig as JBucketing
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import bucket_ladder as jladder
from torchrec_tpu.sparse import bucketed_cap as jcap
from torchrec_tpu_torch.convert import train_state_from_jax, train_state_to_jax
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import (
    DistributedModelParallel,
    stack_batches,
)
from torchrec_tpu_torch.parallel.train_pipeline import (
    BucketedStepCache,
    BucketedTrainPipeline,
    BucketingConfig,
    DataLoadingThread,
    TrainPipelineSparseDist,
)
from torchrec_tpu_torch.parallel.types import table_wise_plan
from torchrec_tpu_torch.sparse import (
    KeyedJaggedTensor,
    bucket_ladder,
    bucketed_cap,
)

KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN, MAX_IDS = 1000, 16, 64, 13, 8
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LR = 0.05
DATA = dict(num_dense=DENSE_IN, manual_seed=0, zipf_lengths=1.2,
            zipf_ids=1.0)
# one rung above every key's occupancy in the first three batches (101 to
# 145 ids of 512): one signature, so one interpret-mode compile per JAX run
LADDER = dict(floor=150, growth=2.0, max_programs=8)


# ---------------------------------------------------------------------------
# ladder arithmetic, repack and the dataset
# ---------------------------------------------------------------------------


def test_ladder_and_bucketed_cap_match_jax():
    for cap, floor, growth in itertools.product(
            (0, 1, 3, 100, 512, 262_144), (1, 4, 8), (1.5, 2.0, 4.0)):
        assert bucket_ladder(cap, floor, growth) == jladder(cap, floor,
                                                            growth)
        for occ in sorted({0, 1, 7, cap // 3, cap // 2 + 1, cap}):
            assert bucketed_cap(occ, cap, floor, growth) == jcap(
                occ, cap, floor, growth)
    with pytest.raises(ValueError):
        bucket_ladder(10, growth=1.0)


def test_kjt_occupancy_bucketed_caps_and_repad_match_jax():
    rng = np.random.RandomState(0)
    lengths = rng.randint(0, 4, size=(3 * 8,)).astype(np.int32)
    values = rng.randint(0, 50, size=(int(lengths.sum()),))
    weights = rng.rand(values.shape[0]).astype(np.float32)
    caps = [40, 64, 32]
    port = KeyedJaggedTensor.from_lengths_packed(["a", "b", "c"], values,
                                                 lengths, weights, caps=caps)
    ref = JKJT.from_lengths_packed(["a", "b", "c"], values, lengths, weights,
                                   caps=caps)
    assert port.occupancy_per_key() == ref.occupancy_per_key()
    new = port.bucketed_caps(floor=2, growth=2.0)
    assert new == ref.bucketed_caps(floor=2, growth=2.0)
    for target in (new, [c + 5 for c in caps], max(new)):
        small, want = port.repad(target), ref.repad(target)
        assert small.caps == want.caps
        np.testing.assert_array_equal(small.values().numpy(),
                                      np.asarray(want.values()))
        np.testing.assert_array_equal(small.weights_or_none().numpy(),
                                      np.asarray(want.weights()))
        np.testing.assert_array_equal(small.lengths().numpy(),
                                      np.asarray(want.lengths()))
    with pytest.raises(ValueError, match="drop"):
        port.repad([c - 1 for c in port.occupancy_per_key()])


@pytest.mark.parametrize("zipf", [
    dict(zipf_lengths=1.2), dict(zipf_ids=1.0),
    dict(zipf_lengths=1.2, zipf_ids=1.0, weighted=True)])
def test_zipf_dataset_matches_jax_batch_for_batch(zipf):
    args = (KEYS, 32, [500, 300, 1000, 50], [8, 3, 1, 6])
    kw = dict(num_dense=5, manual_seed=7, min_ids_per_features=[1, 0, 0, 2],
              **zipf)
    port, ref = RandomRecDataset(*args, **kw), JDataset(*args, **kw)
    for a, b in zip(itertools.islice(port, 3), itertools.islice(ref, 3)):
        ka, kb = a.sparse_features, b.sparse_features
        np.testing.assert_array_equal(ka.values().numpy(),
                                      np.asarray(kb.values()))
        np.testing.assert_array_equal(ka.lengths().numpy(),
                                      np.asarray(kb.lengths()))
        if zipf.get("weighted"):
            np.testing.assert_array_equal(ka.weights_or_none().numpy(),
                                          np.asarray(kb.weights()))
        np.testing.assert_array_equal(a.dense_features.numpy(),
                                      np.asarray(b.dense_features))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _tables(cls, **kw):
    return tuple(cls(num_embeddings=ROWS, embedding_dim=D, name=f"t_{k}",
                     feature_names=[k], **kw) for k in KEYS)


def _port_dmp(optim, caps, kernel="dedup"):
    tables = _tables(EmbeddingBagConfig)
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), DENSE_IN, DENSE_ARCH, OVER_ARCH),
        tables,
        table_wise_plan(tables), B, caps,
        fused_config=FusedOptimConfig(optim=optim, learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu", lookup_kernel=kernel,
        update_kernel=kernel,
    )


def _port_dataset():
    return RandomRecDataset(KEYS, B, [ROWS] * len(KEYS), [MAX_IDS] * 4,
                            **DATA)


@pytest.mark.parametrize("optim", ["rowwise_adagrad", "adam"])
def test_bucketed_pipeline_matches_jax(optim):
    """Three bucketed steps from the same carried state over the same
    batches: the JAX pipeline on its Pallas dedup kernels (interpret
    mode), the port's on the plain versions of B4 and B6."""
    ds = JDataset(KEYS, B, [ROWS] * len(KEYS), [MAX_IDS] * 4, **DATA)
    jtables = _tables(JCfg, pooling=JPooling.SUM)
    jdmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=jtables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=DENSE_ARCH,
            over_arch_layer_sizes=OVER_ARCH),
        tables=jtables,
        env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan=EmbeddingShardingPlanner(world_size=1).plan(jtables),
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim(optim), learning_rate=LR),
        dense_optimizer=optax.adagrad(LR),
    )
    jstate = jdmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate)
    jpipe = JBucketed(
        jdmp, jstate, jdmp.env, donate=False,
        bucketing=JBucketing(**LADDER, kernels={
            "pooled": "pallas_dedup", "update": "pallas_dedup",
            "interpret": True, "chunk": 32, "group": 8}))
    dmp = _port_dmp(EmbOptimType(optim), dict(zip(KEYS, ds.caps)))
    pipe = BucketedTrainPipeline(
        dmp, train_state_from_jax(start, device="cpu"),
        BucketingConfig(**LADDER, kernels={"pooled": "dedup",
                                           "update": "dedup"}))
    jit_, it = iter(ds), iter(_port_dataset())
    for _ in range(3):
        jm, m = jpipe.progress(jit_), pipe.progress(it)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
    assert pipe.stats.dispatch_counts == jpipe.stats.dispatch_counts
    # the padding counters, per-key sums and wire ledgers (the port's from
    # each signature's first dispatch, the JAX package's from its trace)
    got_sm = pipe.stats.scalar_metrics()
    assert got_sm.pop("bucketing/dispatch_count") == 3.0
    assert got_sm == jpipe.stats.scalar_metrics()
    assert pipe.stats.wire_ledgers == jpipe.stats.wire_ledgers
    assert pipe.stats.wire_bytes_per_step()["tw_d16:out_dist"] > 0
    assert pipe.stats.padded_bytes_ratio() == pytest.approx(
        jpipe.stats.padded_bytes_ratio(), abs=0)
    assert pipe.stats.padded_bytes_ratio() < 0.6  # bucketing shrank V
    got = train_state_to_jax(pipe.state)
    want = jax.tree.map(np.asarray, jpipe.state)
    g = "tw_d16"
    diff = np.abs(got["tables"][g] - want["tables"][g])
    assert diff.max() <= (2e-6 if optim == "rowwise_adagrad" else 1e-5)
    assert (diff <= 2e-6).mean() >= 0.9999
    assert sorted(got["fused"][g]) == sorted(want["fused"][g])
    for k, v in got["fused"][g].items():
        if k == "step":
            assert v == want["fused"][g][k] == 3
        else:
            np.testing.assert_allclose(v, want["fused"][g][k], rtol=1e-5,
                                       atol=1e-9)
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    moved = got["tables"][g] != start["tables"][g]
    assert moved.any(axis=1).sum() > 100


@pytest.mark.parametrize("optim", ["rowwise_adagrad", "adam"])
def test_bucketed_pipeline_equals_full_caps_bitwise(optim):
    """The port's bucketed pipeline and the full-capacity step over the
    same batches from the same state: every loss and every number of the
    state equal."""
    ds = _port_dataset()
    caps = dict(zip(KEYS, ds.caps))
    dmp = _port_dmp(EmbOptimType(optim), caps)
    state = dmp.init(torch.Generator().manual_seed(1))
    twin = train_state_from_jax(train_state_to_jax(state), device="cpu")
    bucketed = BucketedTrainPipeline(
        dmp, state, BucketingConfig(kernels={"pooled": "dedup",
                                             "update": "dedup"}))
    full = TrainPipelineSparseDist(dmp.train_step, twin, device="cpu")
    it_b, it_f = iter(ds), iter(_port_dataset())
    for _ in range(3):
        mb, mf = bucketed.progress(it_b), full.progress(it_f)
        assert torch.equal(mb["loss"], mf["loss"])
        assert torch.equal(mb["logits"], mf["logits"])
    sigs = list(bucketed.stats.dispatch_counts)
    assert all(sum(s) < sum(ds.caps) for s in sigs)
    assert bucketed.stats.program_count == len(sigs)
    a, b = train_state_to_jax(bucketed.state), train_state_to_jax(full.state)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_step_cache_bounded_admission_and_shared_state():
    ds = _port_dataset()
    caps = dict(zip(KEYS, ds.caps))
    dmp = _port_dmp(EmbOptimType.ROWWISE_ADAGRAD, caps, kernel="tbe")
    cache = BucketedStepCache(dmp, BucketingConfig(max_programs=3))
    full = cache.signature(KEYS, ds.caps)
    assert full == tuple(ds.caps) == cache.full_signature
    small = cache.resolve(KEYS, cache.signature(KEYS, [1, 2, 3, 4]))
    assert small == (8, 8, 8, 8)
    mid = cache.resolve(KEYS, (16, 64, 8, 8))
    # past the bound: round up to a dominating cached signature, else full
    assert cache.resolve(KEYS, (16, 32, 8, 8)) == mid
    assert cache.resolve(KEYS, (512, 8, 8, 8)) == full
    assert cache.stats.fallback_count == 2
    step = cache.train_program(mid)
    clone = step.__self__
    assert clone is not dmp and clone.sharded_ebc is not dmp.sharded_ebc
    assert cache.train_program(full).__self__ is dmp  # no kernels named
    assert clone.tables is dmp.tables and clone.update_kernel == "tbe"
    assert cache.stats.program_count == 2
    with pytest.raises(ValueError):
        cache.resolve(["x"] * 4, full)
    with pytest.raises(ValueError):
        BucketedStepCache(dmp, BucketingConfig(kernels={"quant": "dedup"}))
    # the per-id update kernel takes every optimizer; an unknown kernel
    # raises
    assert _port_dmp(EmbOptimType.ADAM, caps,
                     kernel="tbe").update_kernel == "tbe"
    with pytest.raises(ValueError):
        _port_dmp(EmbOptimType.ADAM, caps, kernel="xla")
    batch = next(iter(ds))
    assert stack_batches([batch]) is batch
    with pytest.raises(NotImplementedError):
        stack_batches([batch, batch])


def test_data_loading_thread_drains_and_reraises():
    loader = DataLoadingThread(iter(range(5)), prefetch=2)
    assert list(loader) == list(range(5))
    assert loader.get() is None

    def broken():
        yield 1
        raise RuntimeError("source failed")

    loader = DataLoadingThread(broken())
    assert loader.get() == 1
    with pytest.raises(RuntimeError, match="source failed"):
        loader.get()
    loader.stop()
