"""Port parity for ``DLRM_DCN`` training: the low-rank cross net and the
DCN dense side against flax, the flax-tree bridge of ``convert.py`` on
DCN params and a whole DCN train state, the fixed multi-hot stream of
``RandomRecDataset``, and the slice as a whole, the port's
``DistributedModelParallel`` on ``DLRM_DCN`` (per-id kernels, plain
versions on the CPU) against the JAX one on its Pallas kernels in
interpret mode.

Tolerances, with their reasons:

* float32 cross net and dense side, ``rtol = 1e-5, atol = 1e-6``: XLA and
  PyTorch sum the matmuls in different orders.  The cross net alone on
  unit-variance input, ``atol = 1e-5``: its outputs reach magnitude 5, so
  an entry that cancels toward zero keeps a few ulp of that magnitude as
  absolute error (measured: 2.6e-6 on one entry of 5,120).
* bfloat16 dense side, ``rtol = atol = 5e-2`` on logits (the port's
  bfloat16 DLRM bound, ``tests/test_torch_dlrm_train.py``): both cast the
  MLPs to bfloat16, but PyTorch's CPU bfloat16 matmul accumulates and
  rounds at other places than XLA's; the cross net is float32 in both.
* The bridge and the dataset: exact.
* The slice (3 steps, float32 tables and dense): losses ``atol = 1e-6``,
  tables ``atol = 2e-6``, optimizer states ``rtol = 1e-5`` (``atol =
  1e-9`` near zero), dense ``atol = 1e-6``: the matmul order above, and
  the per-id kernel's means and norms, which the JAX kernel reduces in an
  order XLA does not pin down.  At most one table element in 10,000 may
  differ by more than ``2e-6``: where a column's gradient is about 1e-9,
  the optimizer's denominator (``sqrt(v)`` for Adam, ``sqrt(m)`` for
  per-element Adagrad, whose ``m`` starts at zero) meets ``eps``, and the
  step turns the dense side's relative differences at that size (up to
  1e-2: measured 1.1e-2 in one such gradient) into differences of up to
  ``lr * 1e-2``.  So the bound is ``lr * 1e-2 = 5e-4`` for Adagrad
  (measured: one element of 64,000 off by 1.03e-4 after 3 steps) and
  ``1e-5`` for Adam, as the bucketed pipeline's test has it (ROADMAP C,
  "Adam magnifies last-bit differences").
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.criteo import MLPERF_DLRM_V2_MULTI_HOT
from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.dlrm import DLRM_DCN as JDCN
from torchrec_tpu.modules.crossnet import LowRankCrossNet as JCross
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.ops.embedding_ops import trace_kernels
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.planner.planners import EmbeddingShardingPlanner
from torchrec_tpu.sparse import KeyedTensor as JKT
from torchrec_tpu_torch.convert import (
    dense_leaves_from_flax_order,
    dense_leaves_to_flax_order,
    dlrm_state_dict_from_flax,
    flax_params_from_dlrm_state_dict,
    train_state_from_jax,
    train_state_to_jax,
)
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import (
    DLRM_DCN,
    dense_state_dict,
    load_dense_state_dict,
)
from torchrec_tpu_torch.modules.crossnet import LowRankCrossNet
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.modules.embedding_configs import PoolingType
from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.sharding.common import FeatureSpec
from torchrec_tpu_torch.parallel.sharding.tw import (
    build_tw_layout,
    tw_regions,
    tw_segments,
    tw_slot_stream,
)
from torchrec_tpu_torch.parallel.types import table_wise_plan
from torchrec_tpu_torch.sparse import KeyedTensor

KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN = 1000, 16, 64, 13
IDS = [3, 1, 2, 4]  # ids per example per feature: duplicates, multi-hot
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LAYERS, RANK = 2, 8
WIDTH = (len(KEYS) + 1) * D
LR = 0.05


def _tables(cls, **kw):
    return tuple(cls(num_embeddings=ROWS, embedding_dim=D, name=f"t_{k}",
                     feature_names=[k], **kw) for k in KEYS)


def _jax_model(dense_dtype=None):
    return JDCN(
        embedding_bag_collection=EmbeddingBagCollection(
            tables=_tables(JCfg, pooling=JPooling.SUM)),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH, dcn_num_layers=LAYERS,
        dcn_low_rank_dim=RANK, dense_dtype=dense_dtype,
    )


def _port_model(dense_dtype=None):
    return DLRM_DCN(TEBC(_tables(EmbeddingBagConfig), device="meta"),
                    DENSE_IN, DENSE_ARCH, OVER_ARCH, LAYERS, RANK,
                    dense_dtype=dense_dtype)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    dense = rng.rand(B, DENSE_IN).astype(np.float32)
    emb = (rng.randn(B, len(KEYS) * D) * 0.1).astype(np.float32)
    return dense, emb


def _flax_params(model, dense, emb):
    kt = JKT(KEYS, [D] * len(KEYS), jnp.asarray(emb))
    return model.init(jax.random.key(2), jnp.asarray(dense), kt,
                      method=JDCN.forward_from_embeddings), kt


def test_low_rank_crossnet_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(B, WIDTH).astype(np.float32)
    jnet = JCross(num_layers=LAYERS, low_rank=RANK)
    params = jnet.init(jax.random.key(1), jnp.asarray(x))
    net = LowRankCrossNet(WIDTH, LAYERS, RANK)
    sd = dlrm_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(net.state_dict())
    assert sd["w_0"].shape == (WIDTH, RANK) and sd["v_0"].shape == (RANK,
                                                                    WIDTH)
    net.load_state_dict(sd)
    got = net(torch.from_numpy(x))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # flax's lecun_normal: variance 1 / fan_in, fan_in = shape[-2]
    fresh = LowRankCrossNet(512, 1, 256)
    assert abs(float(fresh.w_0.detach().std()) - (1 / 512) ** 0.5) < 0.1 * (
        1 / 512) ** 0.5
    assert abs(float(fresh.v_0.detach().std()) - (1 / 256) ** 0.5) < 0.1 * (
        1 / 256) ** 0.5
    assert not fresh.b_0.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dlrm_dcn_forward_from_embeddings_matches_flax(dtype):
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    dense, emb = _inputs(1)
    model = _jax_model(jdt)
    params, kt = _flax_params(model, dense, emb)
    want = model.apply(params, jnp.asarray(dense), kt,
                       method=JDCN.forward_from_embeddings)
    tmodel = _port_model(tdt)
    load_dense_state_dict(tmodel, dlrm_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    tkt = KeyedTensor(KEYS, [D] * len(KEYS), torch.from_numpy(emb))
    got = tmodel.forward_from_embeddings(torch.from_numpy(dense), tkt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (B, 1)
    # the cross net is float32 whatever the MLPs compute in
    inter = tmodel.inter_arch(tmodel.dense_arch(torch.from_numpy(dense)),
                              tkt.values().reshape(B, -1, D))
    assert inter.dtype == torch.float32 and inter.shape == (B, WIDTH)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" else dict(
        rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_dlrm_dcn_params_round_trip_bitwise():
    """flax params -> port state dict -> flax params, and the artifact's
    flatten-order leaves both ways, bit for bit, driven by the tree's own
    paths."""
    dense, emb = _inputs(2)
    params, _ = _flax_params(_jax_model(), dense, emb)
    np_params = jax.tree.map(np.asarray, params)
    sd = dlrm_state_dict_from_flax(np_params)
    tmodel = _port_model()
    assert sorted(sd) == sorted(dense_state_dict(tmodel))
    assert "inter_arch.crossnet.v_1" in sd
    assert "over_arch.mlp.layers.1.linear.weight" in sd
    load_dense_state_dict(tmodel, sd)
    back = flax_params_from_dlrm_state_dict(dense_state_dict(tmodel))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    leaves = jax.tree.leaves(np_params)
    got = dense_leaves_to_flax_order(sd)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)
    sd2 = dense_leaves_from_flax_order(leaves, dense_state_dict(tmodel))
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def _jax_dmp(ds, optim):
    tables = _tables(JCfg, pooling=JPooling.SUM)
    return JDMP(
        model=_jax_model(), tables=tables,
        env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan=EmbeddingShardingPlanner(world_size=1).plan(tables),
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim(optim), learning_rate=LR),
        dense_optimizer=optax.adagrad(LR),
    )


def _port_dmp(caps, optim="adagrad", **kw):
    tables = _tables(EmbeddingBagConfig)
    return DistributedModelParallel(
        _port_model(), tables, table_wise_plan(tables), B, caps,
        fused_config=FusedOptimConfig(optim=EmbOptimType(optim),
                                      learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu", **kw,
    )


def _dataset(cls):
    return cls(KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN,
               manual_seed=0)


@pytest.mark.parametrize("optim", ["adagrad", "adam"])
def test_dmp_dcn_matches_jax(optim):
    """Three train steps of DLRM_DCN from the same carried state on the
    same batches: JAX on its Pallas kernels in interpret mode (B1 and the
    per-id B2), the port on the plain versions of its per-id kernels."""
    jds = _dataset(JDataset)
    jdmp = _jax_dmp(jds, optim)
    jstate = jdmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate)
    dmp = _port_dmp(dict(zip(KEYS, jds.caps)), optim)
    state = train_state_from_jax(start, device="cpu")
    g = "tw_d16"
    if optim == "adagrad":
        assert state["fused"][g]["momentum"].shape == (ROWS * len(KEYS), D)
    jit_, it = iter(jds), iter(_dataset(RandomRecDataset))
    with trace_kernels(pooled="pallas", update="pallas", chunk=64, group=8,
                       interpret=True):
        step = jdmp.make_train_step(donate=False)
        for _ in range(3):
            jstate, jm = step(jstate, stack_batches([next(jit_)]))
            state, m = dmp.train_step(state, next(it))
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
    got = train_state_to_jax(state)
    want = jax.tree.map(np.asarray, jstate)
    diff = np.abs(got["tables"][g] - want["tables"][g])
    assert diff.max() <= (LR * 1e-2 if optim == "adagrad" else 1e-5)
    assert (diff <= 2e-6).mean() >= 0.9999
    assert sorted(got["fused"][g]) == sorted(want["fused"][g])
    for k, v in got["fused"][g].items():
        if k == "step":
            assert v == want["fused"][g][k] == 3
        else:
            np.testing.assert_allclose(v, want["fused"][g][k], rtol=1e-5,
                                       atol=1e-9)
    assert jax.tree.structure(got["dense"]) == jax.tree.structure(
        want["dense"])
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    moved = got["tables"][g] != start["tables"][g]
    assert moved.any(axis=1).sum() > 100


def test_dcn_train_state_round_trip_bitwise():
    """A JAX DLRM_DCN train state (per-element Adagrad: an ``[R, D]``
    momentum) -> the port -> JAX: every leaf equal, the dense Adagrad's
    ``sum_of_squares`` in the params' tree order."""
    jds = _dataset(JDataset)
    jdmp = _jax_dmp(jds, "adagrad")
    start = jax.tree.map(np.asarray, jdmp.init(jax.random.key(3)))
    rng = np.random.RandomState(4)
    start["fused"]["tw_d16"]["momentum"] = rng.rand(
        *start["fused"]["tw_d16"]["momentum"].shape).astype(np.float32)
    state = train_state_from_jax(start, device="cpu")
    load_dense_state_dict(_port_model(), state["dense"])
    assert state["dense_opt"].keys() == state["dense"].keys()
    back = train_state_to_jax(state)
    want_opt = start["dense_opt"][0].sum_of_squares
    assert jax.tree.structure(back["dense_opt"]["sum_of_squares"]) == (
        jax.tree.structure(want_opt))
    for a, b in zip(jax.tree.leaves(back["dense_opt"]["sum_of_squares"]),
                    jax.tree.leaves(want_opt)):
        np.testing.assert_array_equal(a, b)
    for part in ("dense", "tables", "fused"):
        assert jax.tree.structure(back[part]) == jax.tree.structure(
            start[part])
        for a, b in zip(jax.tree.leaves(back[part]),
                        jax.tree.leaves(start[part])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert back["step"] == start["step"]


@pytest.mark.parametrize("optim", [o.value for o in EmbOptimType])
def test_dmp_dcn_trains_every_optimizer_on_cpu(optim):
    """The per-id update kernel takes all eight optimizers on DLRM_DCN:
    three finite steps from a fresh state, the touched rows and their
    states move, the Adam family counts its steps."""
    ds = _dataset(RandomRecDataset)
    dmp = _port_dmp(dict(zip(KEYS, ds.caps)), optim)
    assert dmp.update_kernel == "tbe"
    state = dmp.init(torch.Generator().manual_seed(0))
    t0 = state["tables"]["tw_d16"].clone()
    fused0 = {k: v.clone() for k, v in state["fused"]["tw_d16"].items()
              if k != "step"}
    it = iter(ds)
    for _ in range(3):
        state, m = dmp.train_step(state, next(it))
        assert np.isfinite(float(m["loss"]))
    moved = (state["tables"]["tw_d16"] != t0).any(dim=1)
    assert int(moved.sum()) > 100
    for k, v in fused0.items():
        assert not torch.equal(state["fused"]["tw_d16"][k], v)
    if "step" in state["fused"]["tw_d16"]:
        assert state["fused"]["tw_d16"]["step"] == 3


def test_random_dataset_fixed_multi_hot_matches_jax():
    """The MLPerf DLRM-v2 multi-hot stream (every example takes exactly
    ``MULTI_HOT[f]`` ids, ``ids_per_features == min_ids_per_features``):
    the port draws what the JAX dataset draws, batch for batch."""
    keys = [f"cat_{i}" for i in range(26)]
    hot = list(MLPERF_DLRM_V2_MULTI_HOT)
    rows = [1000 + 7 * i for i in range(26)]
    kw = dict(num_dense=13, manual_seed=0, min_ids_per_features=hot,
              num_batches=2)
    mine = list(RandomRecDataset(keys, 8, rows, hot, **kw))
    theirs = list(JDataset(keys, 8, rows, hot, **kw))
    for a, b in zip(mine, theirs):
        ka, kb = a.sparse_features, b.sparse_features
        np.testing.assert_array_equal(ka.lengths().numpy(),
                                      np.asarray(kb.lengths()))
        assert (ka.lengths().numpy().reshape(26, 8)
                == np.asarray(hot)[:, None]).all()
        np.testing.assert_array_equal(ka.values().numpy(),
                                      np.asarray(kb.values()))
        assert list(ka.cap_offsets()) == list(kb.cap_offsets())
        np.testing.assert_array_equal(a.dense_features.numpy(),
                                      np.asarray(b.dense_features))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_hot_stream_regions_equal_sorted_plain(dtype):
    """The MLPerf DLRM-v2 multi-hot stream in the table-wise layout (26
    regions of the group's cap, 1 to 100 ids an example): the region
    entry's plain version ``torch.equal`` to the sorted plain version over
    the slots' segments, float32 and bfloat16 stacks."""
    keys = [f"cat_{i}" for i in range(26)]
    hot = list(MLPERF_DLRM_V2_MULTI_HOT)
    rows = [50 + i for i in range(26)]
    batch = next(iter(RandomRecDataset(keys, 8, rows, hot,
                                       min_ids_per_features=hot,
                                       manual_seed=0)))
    feats = [FeatureSpec(k, f"t_{k}", r, D, PoolingType.SUM, h * 8)
             for k, r, h in zip(keys, rows, hot)]
    lay = build_tw_layout("tw", feats, {f.table_name: [0] for f in feats},
                          1, 8)
    ids, w, lengths = tw_slot_stream(lay, batch.sparse_features)
    segs, S = tw_segments(lay, lengths)
    stack = torch.from_numpy(np.random.RandomState(1).randn(
        sum(rows), D).astype(np.float32)).to(dtype)
    got = tbe.pooled_lookup_regions_plain(stack, ids,
                                          tw_regions(lay, lengths), w)
    assert lay.cap == 800 and got.shape == (S, D)
    assert torch.equal(got, tbe.pooled_lookup_plain(stack, ids, segs, S, w))
