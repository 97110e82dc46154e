"""Port parity for the planner-driven training path of the DLRM
application: the port's DMP with one warmup schedule on the dense
optimizer and the fused sparse lr against the JAX DMP at world 1 (4 steps
across the ramp and the tail), its eval forward ``make_forward``, the
``id_overflow`` count of a train step (at world 1 against the JAX step,
and through the bucketed pipeline's ``scalar_metrics``), the Criteo loader
against the JAX one on the same npy files, and the application itself on
the CPU, synthetic and over tiny Criteo shards.

Tolerances: losses ``atol = 1e-6``, tables ``atol = 2e-6``, momentum
``rtol = 1e-5``, dense ``atol = 1e-6``, as ``tests/test_torch_dlrm_train.py``
states them (the matmul order, the fused update's mean; the jitted JAX
schedule may also be an ulp off the schedule called on a step); logits of
the eval forward ``atol = 1e-5`` (the matmul order, after 4 steps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.criteo import criteo_dataset as j_criteo
from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.ops.embedding_ops import trace_kernels
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.optim import warmup as jwarmup
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.planner.planners import (
    EmbeddingShardingPlanner as JPlanner,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.convert import train_state_from_jax, train_state_to_jax
from torchrec_tpu_torch.datasets.criteo import criteo_dataset
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.examples.dlrm import dlrm_main
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimConfig,
)
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.optim import warmup as twarmup
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
from torchrec_tpu_torch.parallel.train_pipeline import (
    BucketedTrainPipeline,
    BucketingConfig,
    TrainPipelineBase,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN = 1000, 16, 64, 13
IDS = [3, 1, 2, 4]
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LR, WARMUP, STEPS = 0.05, 3, 4


def _tables(cls, **kw):
    return tuple(cls(num_embeddings=ROWS, embedding_dim=D, name=f"t_{k}",
                     feature_names=[k], **kw) for k in KEYS)


def _stages(mod):
    return [mod.WarmupStage(mod.WarmupPolicy.LINEAR, max_iters=WARMUP,
                            value=1.0)]


def test_dmp_with_warmup_schedules_and_forward_match_jax():
    jtables = _tables(JCfg, pooling=JPooling.SUM)
    ds = JDataset(KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN,
                  manual_seed=0)
    jdmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=jtables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=DENSE_ARCH,
            over_arch_layer_sizes=OVER_ARCH),
        tables=jtables,
        env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan=JPlanner(world_size=1, batch_size_per_device=B).plan(jtables),
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=jwarmup.warmup_optimizer(optax.adagrad(LR),
                                                 _stages(jwarmup)),
        sparse_lr_schedule=jwarmup.warmup_schedule(_stages(jwarmup)),
    )
    jstate = jdmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate)
    tables = _tables(EmbeddingBagConfig)
    dmp = DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), DENSE_IN, DENSE_ARCH, OVER_ARCH),
        tables,
        EmbeddingShardingPlanner(world_size=1,
                                 batch_size_per_device=B).plan(tables),
        B, dict(zip(KEYS, ds.caps)),
        fused_config=FusedOptimConfig(learning_rate=LR),
        dense_optimizer=twarmup.warmup_optimizer(adagrad(LR),
                                                 _stages(twarmup)),
        sparse_lr_schedule=twarmup.warmup_schedule(_stages(twarmup)),
        device="cpu")
    state = train_state_from_jax({**start, "dense_opt": start["dense_opt"][0]},
                                 device="cpu")
    state["dense_opt"] = {"base": state["dense_opt"], "count": 0}
    # the scheduled sparse lr the port hands its fused update, step by step
    assert [dmp.sparse_lr(i) for i in range(5)] == [
        float(np.float32(jwarmup.warmup_schedule(_stages(jwarmup))(i))
              * np.float32(LR)) for i in range(5)]
    assert dmp.sparse_lr(0) < LR / 1e6 and dmp.sparse_lr(WARMUP) == \
        float(np.float32(LR))
    jit, tit = iter(ds), iter(RandomRecDataset(
        KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN, manual_seed=0))
    with trace_kernels(pooled="xla", update="xla"):
        step = jdmp.make_train_step(donate=False)
        for _ in range(STEPS):
            jstate, jm = step(jstate, stack_batches([next(jit)]))
            state, m = dmp.train_step(state, next(tit))
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
        jlogits = jdmp.make_forward()(jstate["dense"], jstate["tables"],
                                      stack_batches([next(jit)]))
    logits = dmp.make_forward()(state["dense"], state["tables"], next(tit))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[0],
                               rtol=0, atol=1e-5)
    assert state["dense_opt"]["count"] == STEPS
    got = train_state_to_jax({**state,
                              "dense_opt": state["dense_opt"]["base"]})
    want = jax.tree.map(np.asarray, jstate)
    np.testing.assert_allclose(got["tables"]["tw_d16"],
                               want["tables"]["tw_d16"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["fused"]["tw_d16"]["momentum"],
                               want["fused"]["tw_d16"]["momentum"],
                               rtol=1e-5, atol=0)
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_forward_equals_train_step_logits():
    """The eval forward and the train step see the same state and batch:
    the same logits, bit for bit (both on the plain versions here)."""
    tables = _tables(EmbeddingBagConfig)
    ds = RandomRecDataset(KEYS, B, [ROWS] * len(KEYS), IDS,
                          num_dense=DENSE_IN)
    dmp = DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), DENSE_IN, DENSE_ARCH, OVER_ARCH),
        tables, EmbeddingShardingPlanner(world_size=1).plan(tables), B,
        dict(zip(KEYS, ds.caps)), device="cpu")
    state = dmp.init(torch.Generator().manual_seed(0))
    batch = next(iter(ds))
    logits = dmp.make_forward()(state["dense"], state["tables"], batch)
    _, m = dmp.train_step(state, batch)
    assert torch.equal(logits, m["logits"])


# -- C1: id_overflow ---------------------------------------------------------

OV_KEYS, OV_B, OV_D, OV_DENSE = ["c0", "c1"], 4, 8, 4


def _over_cap(kjt_cls, kjt, lengths_fn):
    """``kjt`` with c0's lengths claiming 11 ids under its cap of 8."""
    lengths = np.asarray(kjt.lengths()).copy()
    lengths[0:OV_B] = [3, 3, 3, 2]
    return kjt_cls(kjt.keys(), kjt.values(), lengths_fn(lengths),
                   stride=OV_B, caps=kjt.caps)


def _jax_overflow():
    tables = tuple(JCfg(num_embeddings=100, embedding_dim=OV_D,
                        name=f"table_{k}", feature_names=[k],
                        pooling=JPooling.SUM) for k in OV_KEYS)
    dmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=OV_DENSE,
            dense_arch_layer_sizes=(8, OV_D), over_arch_layer_sizes=(8, 1)),
        tables=tables,
        env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan=JPlanner(world_size=1).plan(tables), batch_size_per_device=OV_B,
        feature_caps={"c0": 8, "c1": 8}, dense_in_features=OV_DENSE,
        fused_config=JFused(optim=JOptim.SGD, learning_rate=0.1),
        dense_optimizer=optax.sgd(0.1))
    state = dmp.init(jax.random.key(0))
    step = dmp.make_train_step()
    b = next(iter(JDataset(OV_KEYS, OV_B, [100, 100], [2, 2],
                           num_dense=OV_DENSE, manual_seed=3)))
    state, ok = step(state, stack_batches([b]))
    over = dataclasses.replace(b, sparse_features=_over_cap(
        JKJT, b.sparse_features, jnp.asarray))
    _, m = step(state, stack_batches([over]))
    return np.asarray(ok["id_overflow"]), np.asarray(m["id_overflow"])


def _port_dmp_overflow():
    tables = tuple(EmbeddingBagConfig(num_embeddings=100, embedding_dim=OV_D,
                                      name=f"table_{k}", feature_names=[k])
                   for k in OV_KEYS)
    dmp = DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), OV_DENSE, (8, OV_D), (8, 1)),
        tables, EmbeddingShardingPlanner(world_size=1).plan(tables), OV_B,
        {"c0": 8, "c1": 8},
        fused_config=FusedOptimConfig(optim=EmbOptimType.SGD,
                                      learning_rate=0.1),
        dense_optimizer=adagrad(0.1), device="cpu")
    ds = RandomRecDataset(OV_KEYS, OV_B, [100, 100], [2, 2],
                          num_dense=OV_DENSE, manual_seed=3)
    return dmp, next(iter(ds))


def test_train_step_surfaces_id_overflow_metric():
    j_ok, j_over = _jax_overflow()
    dmp, b = _port_dmp_overflow()
    state = dmp.init(torch.Generator().manual_seed(0))
    state, ok = dmp.train_step(state, b)
    over = dataclasses.replace(b, sparse_features=_over_cap(
        KeyedJaggedTensor, b.sparse_features, torch.from_numpy))
    _, m = dmp.train_step(state, over)
    assert ok["id_overflow"].dtype == torch.int32
    np.testing.assert_array_equal(ok["id_overflow"].numpy(), j_ok)
    np.testing.assert_array_equal(m["id_overflow"].numpy(), j_over)
    np.testing.assert_array_equal(j_over, [3, 0])


def test_pipelines_scalar_metrics_carry_id_overflow():
    """The base pipeline hands the over-cap batch to the step as it is
    and publishes its count; the bucketed pipeline publishes its steps'
    count beside the padding counters (its host repack refuses an
    over-cap batch, as the JAX package's does)."""
    dmp, b = _port_dmp_overflow()
    over = dataclasses.replace(b, sparse_features=_over_cap(
        KeyedJaggedTensor, b.sparse_features, torch.from_numpy))
    pipe = TrainPipelineBase(dmp.train_step,
                             dmp.init(torch.Generator().manual_seed(0)),
                             device="cpu")
    assert pipe.scalar_metrics() == {}
    it = iter([b, over])
    pipe.progress(it)
    assert pipe.scalar_metrics() == {"pipeline/id_overflow": 0.0}
    pipe.progress(it)
    assert pipe.scalar_metrics() == {"pipeline/id_overflow": 3.0}
    bucketed = BucketedTrainPipeline(
        dmp, dmp.init(torch.Generator().manual_seed(0)), BucketingConfig())
    bucketed.progress(iter([b]))
    sm = bucketed.scalar_metrics()
    assert sm["bucketing/id_overflow"] == 0.0
    assert any(k.startswith("bucketing/") and k != "bucketing/id_overflow"
               for k in sm)  # the padding counters ride along


# -- the Criteo loader and the application ---------------------------------


def _criteo_shards(path, n=256, seed=0):
    rng = np.random.RandomState(seed)
    np.save(path / "day0_dense.npy",
            rng.randint(0, 100, size=(n, 13)).astype(np.int64))
    np.save(path / "day0_sparse.npy",
            rng.randint(0, 1 << 40, size=(n, 26)).astype(np.int64))
    np.save(path / "day0_labels.npy",
            rng.randint(0, 2, size=(n,)).astype(np.int64))
    return str(path / "day0")


@pytest.mark.parametrize("kw", [
    dict(batch_size=16),
    dict(batch_size=24, drop_last=False, shuffle_batches=True, seed=3),
], ids=["whole", "tail_shuffled"])
def test_criteo_loader_matches_jax_bitwise(tmp_path, kw):
    prefix = _criteo_shards(tmp_path, n=100)
    hashes = [1000 + i for i in range(26)]
    got = list(criteo_dataset(prefix, hashes=hashes, **kw))
    want = list(j_criteo(prefix, hashes=hashes, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dense_features.numpy(),
                                      np.asarray(w.dense_features))
        np.testing.assert_array_equal(g.labels.numpy(),
                                      np.asarray(w.labels))
        gk, wk = g.sparse_features, w.sparse_features
        assert list(gk.keys()) == list(wk.keys())
        assert list(gk.caps) == list(wk.caps)
        np.testing.assert_array_equal(gk.lengths().numpy(),
                                      np.asarray(wk.lengths()))
        np.testing.assert_array_equal(gk.values().numpy(),
                                      np.asarray(wk.values()))
        assert (g.weights is None) == (w.weights is None)
        if g.weights is not None:
            np.testing.assert_array_equal(g.weights.numpy(),
                                          np.asarray(w.weights))
    assert any(b.weights is not None for b in got) == (
        not kw.get("drop_last", True))


def test_criteo_tsv_preprocessing_matches_jax(tmp_path):
    """A TSV with empty fields through both packages' ``tsv_to_npys``:
    the same npy arrays."""
    from torchrec_tpu.datasets.criteo import BinaryCriteoUtils as JUtils
    from torchrec_tpu_torch.datasets.criteo import BinaryCriteoUtils

    rng = np.random.RandomState(0)
    lines = []
    for i in range(7):
        dense = ["" if rng.rand() < 0.2 else str(rng.randint(0, 999))
                 for _ in range(13)]
        cats = ["" if rng.rand() < 0.2 else format(rng.randint(0, 1 << 31),
                                                   "x") for _ in range(26)]
        lines.append("\t".join([str(i % 2)] + dense + cats))
    tsv = tmp_path / "day.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    outs = {}
    for name, utils in (("t", BinaryCriteoUtils), ("j", JUtils)):
        paths = [str(tmp_path / f"{name}_{k}.npy")
                 for k in ("dense", "sparse", "labels")]
        assert utils.tsv_to_npys(str(tsv), *paths, max_rows=6) == 6
        outs[name] = [np.load(p) for p in paths]
    for a, b in zip(outs["t"], outs["j"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_dlrm_main_synthetic(capsys):
    run = dlrm_main.main([
        "--device", "cpu", "--steps", "4", "--eval_steps", "2",
        "--batch_size", "8", "--num_embeddings", "500",
        "--embedding_dim", "16", "--warmup_steps", "2"])
    out = capsys.readouterr().out
    assert "eval over" in out and "lifetime_ne" in out
    assert "torchrec_tpu_torch sharding plan" in out
    assert len(run["losses"]) == 4 and run["evaluated"] == 2
    assert all(np.isfinite(float(x)) for x in run["losses"])
    assert not any(o.any() for o in run["id_overflow"])
    assert np.isfinite(run["report"]["auc-ctr|lifetime_auc"])


def test_dlrm_main_criteo_path(tmp_path, capsys):
    prefix = _criteo_shards(tmp_path)
    dlrm_main.main([
        "--device", "cpu", "--criteo_prefix", prefix, "--steps", "2",
        "--eval_steps", "1", "--batch_size", "4", "--num_embeddings", "200",
        "--embedding_dim", "8", "--warmup_steps", "1"])
    out = capsys.readouterr().out
    assert "eval over 1 batches" in out and "lifetime_ne" in out
