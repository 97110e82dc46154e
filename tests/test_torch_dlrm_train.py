"""Port parity for the DLRM training step: the one-device table-wise plan,
the optax-equivalent dense Adagrad, the DLRM dense side in float32 and
bfloat16 against flax, the BCE loss, the train state carried between the
packages, and the slice as a whole, the port's ``DistributedModelParallel``
against the JAX one on both JAX kernel arms.

Tolerances, with their reasons:

* float32 dense side, ``rtol = 1e-5, atol = 1e-6``: XLA and PyTorch sum
  the matmuls in different orders.
* bfloat16 dense side, ``rtol = atol = 5e-2`` on logits: both cast to
  bfloat16, but PyTorch's CPU bfloat16 matmul accumulates and rounds at
  other places than XLA's.
* Dense Adagrad, ``rtol = 1e-6, atol = 1e-7``: ``rsqrt`` is not correctly
  rounded on either side.
* The slice (3 steps, float32 tables and dense), losses ``atol = 1e-6``,
  tables ``atol = 2e-6``, momentum ``rtol = 1e-5``, dense ``atol = 1e-6``:
  the matmul order above, and the fused update's mean, which the JAX
  kernel reduces in an order XLA does not pin down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.models.dlrm import bce_with_logits_loss as jbce
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
    dlrm_state_dict_from_flax,
    train_state_from_jax,
    train_state_to_jax,
)
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import (
    DLRM,
    bce_with_logits_loss,
    dense_state_dict,
    load_dense_state_dict,
)
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimConfig,
    SparseSegGrad,
    apply_sparse_update_segments,
)
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    ParameterSharding,
    ShardingType,
    table_wise_plan,
)
from torchrec_tpu_torch.sparse import KeyedTensor

KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN = 1000, 16, 64, 13
IDS = [3, 1, 2, 4]  # ids per example per feature: duplicates, multi-hot
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LR = 0.05


def _tables(cls, **kw):
    return tuple(cls(num_embeddings=ROWS, embedding_dim=D, name=f"t_{k}",
                     feature_names=[k], **kw) for k in KEYS)


def _jax_model(dense_dtype=None):
    return JDLRM(
        embedding_bag_collection=EmbeddingBagCollection(
            tables=_tables(JCfg, pooling=JPooling.SUM)),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH, dense_dtype=dense_dtype,
    )


def test_table_wise_plan_matches_planner_on_bench_tables():
    tables = tuple(
        JCfg(num_embeddings=100_000, embedding_dim=128, name=f"t_cat_{i}",
             feature_names=[f"cat_{i}"], pooling=JPooling.SUM)
        for i in range(26))
    want = EmbeddingShardingPlanner(world_size=1).plan(tables)
    got = table_wise_plan(tuple(
        EmbeddingBagConfig(num_embeddings=100_000, embedding_dim=128,
                           name=f"t_cat_{i}", feature_names=[f"cat_{i}"])
        for i in range(26)))
    assert sorted(got) == sorted(want)
    for name, ps in got.items():
        w = want[name]
        assert (ps.sharding_type.value, ps.compute_kernel.value, ps.ranks,
                ps.num_col_shards) == (w.sharding_type.value,
                                       w.compute_kernel.value, w.ranks,
                                       w.num_col_shards)
    assert ps.sharding_type == ShardingType.TABLE_WISE
    assert ps.compute_kernel == EmbeddingComputeKernel.FUSED


def test_dense_adagrad_matches_optax_over_five_steps():
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (0.1 if i else 0.0)).astype(np.float32)
              for k, s in shapes.items()} for i in range(5)]
    tx = optax.adagrad(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = adagrad(LR)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts[k].numpy(),
                                   np.asarray(js[0].sum_of_squares[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dlrm_dense_side_and_loss_match_flax(dtype):
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    model = _jax_model(jdt)
    rng = np.random.RandomState(1)
    dense = rng.rand(B, DENSE_IN).astype(np.float32)
    emb = (rng.randn(B, len(KEYS) * D) * 0.1).astype(np.float32)
    labels = rng.randint(0, 2, B).astype(np.float32)
    kt = JKT(KEYS, [D] * len(KEYS), jnp.asarray(emb))
    params = model.init(jax.random.key(2), jnp.asarray(dense), kt,
                        method=JDLRM.forward_from_embeddings)
    jlogits = model.apply(params, jnp.asarray(dense), kt,
                          method=JDLRM.forward_from_embeddings)
    tmodel = DLRM(TEBC(_tables(EmbeddingBagConfig), device="meta"),
                  DENSE_IN, DENSE_ARCH, OVER_ARCH, dense_dtype=tdt)
    load_dense_state_dict(tmodel, dlrm_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    tlogits = tmodel.forward_from_embeddings(
        torch.from_numpy(dense),
        KeyedTensor(KEYS, [D] * len(KEYS), torch.from_numpy(emb)))
    # the logit layer runs in float32 either way
    assert tlogits.dtype == torch.float32 and jlogits.dtype == jnp.float32
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" else dict(
        rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **tol)
    inner = tmodel.dense_arch(torch.from_numpy(dense))
    assert inner.dtype == (torch.float32 if tdt is None else tdt)
    for w in (None, rng.rand(B).astype(np.float32)):
        got = bce_with_logits_loss(tlogits, torch.from_numpy(labels),
                                   None if w is None else torch.from_numpy(w))
        want = jbce(jlogits, jnp.asarray(labels),
                    None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(got.detach()), float(want), **tol)


def _jax_dmp(ds):
    tables = _tables(JCfg, pooling=JPooling.SUM)
    return JDMP(
        model=_jax_model(), tables=tables,
        env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan=EmbeddingShardingPlanner(world_size=1).plan(tables),
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR),
    )


def _port_dmp(caps, fused_config=None, **kw):
    tables = _tables(EmbeddingBagConfig)
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), DENSE_IN, DENSE_ARCH, OVER_ARCH),
        tables,
        table_wise_plan(tables), B, caps,
        fused_config=fused_config or FusedOptimConfig(learning_rate=LR),
        dense_optimizer=adagrad(LR), **kw,
    )


@pytest.fixture(scope="module")
def jax_start():
    """The JAX DMP, its initial state (device arrays and numpy) and the
    dataset both packages draw from."""
    ds = JDataset(KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN,
                  manual_seed=0)
    dmp = _jax_dmp(ds)
    state = dmp.init(jax.random.key(0))
    return dmp, state, jax.tree.map(np.asarray, state), ds


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_dmp_slice_matches_jax(jax_start, kernel):
    """Three train steps from the same carried state on the same
    RandomRecDataset batches: JAX on its Pallas kernels in interpret mode
    or on XLA, the port on its plain versions."""
    jdmp, jstate, jnp_state, jds = jax_start
    dmp = _port_dmp(dict(zip(KEYS, jds.caps)), device="cpu")
    state = train_state_from_jax(jnp_state, device="cpu")
    port_batches = iter(RandomRecDataset(KEYS, B, [ROWS] * len(KEYS), IDS,
                                         num_dense=DENSE_IN, manual_seed=0))
    jax_batches = iter(jds)
    with trace_kernels(pooled=kernel, update=kernel, chunk=64, group=8,
                       interpret=True):
        step = jdmp.make_train_step(donate=False)
        for _ in range(3):
            jstate, jm = step(jstate, stack_batches([next(jax_batches)]))
            state, m = dmp.train_step(state, next(port_batches))
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
    assert state["step"] == 3 and int(jstate["step"]) == 3
    got = train_state_to_jax(state)
    want = jax.tree.map(np.asarray, jstate)
    np.testing.assert_allclose(got["tables"]["tw_d16"],
                               want["tables"]["tw_d16"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["fused"]["tw_d16"]["momentum"],
                               want["fused"]["tw_d16"]["momentum"],
                               rtol=1e-5, atol=0)
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    moved = got["tables"]["tw_d16"] != jnp_state["tables"]["tw_d16"]
    assert moved.any(axis=1).sum() > 100  # the steps touched many rows


def test_train_state_round_trip_bitwise(jax_start):
    """JAX state -> port -> JAX: the JAX ``table_weights`` of the carried
    state equal the original's bit for bit, and so do the port's."""
    jdmp, jstate, jnp_state, jds = jax_start
    dmp = _port_dmp(dict(zip(KEYS, jds.caps)), device="cpu")
    state = train_state_from_jax(jnp_state, device="cpu")
    back = train_state_to_jax(state)
    back_state = {
        **jstate,
        "dense": back["dense"],
        "dense_opt": (optax.ScaleByRssState(**back["dense_opt"]),
                      optax.EmptyState()),
        "tables": {g: jnp.asarray(t) for g, t in back["tables"].items()},
        "fused": {g: {k: jnp.asarray(v) for k, v in st.items()}
                  for g, st in back["fused"].items()},
        "step": jnp.asarray(back["step"]),
    }
    want = jdmp.table_weights(jstate)
    for name, w in jdmp.table_weights(back_state).items():
        np.testing.assert_array_equal(w, want[name])
    for name, w in dmp.table_weights(state).items():
        np.testing.assert_array_equal(w, want[name])
    for a, b in zip(jax.tree.leaves(back_state),
                    jax.tree.leaves(jnp_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # load_table_weights is table_weights' inverse
    other = {k: np.zeros_like(v) for k, v in want.items()}
    dmp.load_table_weights(state, other)
    assert not state["tables"]["tw_d16"].any()
    dmp.load_table_weights(state, want)
    assert np.array_equal(train_state_to_jax(state)["tables"]["tw_d16"],
                          jnp_state["tables"]["tw_d16"])


@pytest.mark.parametrize("optim", [o.value for o in JOptim])
def test_fused_states_round_trip_bitwise(jax_start, optim):
    """Every fused optimizer's state crosses both ways bit for bit: the
    JAX layout of ``init_optimizer_state`` filled with random values (and
    the Adam family's ``step``), to the port and back."""
    from torchrec_tpu.ops.fused_update import init_optimizer_state as jinit

    _, _, jnp_state, _ = jax_start
    rng = np.random.RandomState(3)
    fused = {k: (np.int32(5) if k == "step"
                 else rng.randn(*v.shape).astype(np.float32))
             for k, v in jinit(JFused(optim=JOptim(optim)), ROWS * 4,
                               D).items()}
    state = train_state_from_jax({**jnp_state, "fused": {"tw_d16": fused}},
                                 device="cpu")
    got = state["fused"]["tw_d16"]
    want = _port_dmp(dict(zip(KEYS, [B] * 4)), device="cpu",
                     fused_config=FusedOptimConfig(optim=EmbOptimType(optim)),
                     update_kernel="dedup", lookup_kernel="dedup").init(
        torch.Generator().manual_seed(0))["fused"]["tw_d16"]
    assert sorted(got) == sorted(want) == sorted(fused)
    for k, v in got.items():
        if k == "step":
            assert v == 5 and want[k] == 0
        else:
            assert v.dtype == want[k].dtype == torch.float32
            assert v.shape == want[k].shape
    back = train_state_to_jax(state)["fused"]["tw_d16"]
    for k, v in fused.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_bf16_tables_train_with_stochastic_rounding():
    """The bfloat16-table arm on the CPU: init from a generator, three
    finite steps, per-step seeds, momentum float32."""
    ds = RandomRecDataset(KEYS, B, [ROWS] * len(KEYS), IDS,
                          num_dense=DENSE_IN, manual_seed=3)
    dmp = _port_dmp(dict(zip(KEYS, ds.caps)), device="cpu",
                    table_dtype=torch.bfloat16)
    state = dmp.init(torch.Generator().manual_seed(0))
    t0 = state["tables"]["tw_d16"].clone()
    assert t0.dtype == torch.bfloat16
    assert state["fused"]["tw_d16"]["momentum"].dtype == torch.float32
    # uniform in +-sqrt(1/rows), then rounded to bfloat16 (half an ulp)
    assert float(t0.abs().max()) <= (1.0 / ROWS) ** 0.5 * (1 + 2.0**-8)
    seeds = [dmp.sr_seeds(s) for s in range(3)]
    assert len(set(seeds)) == 3 and all(len(s) == 1 for s in seeds)
    step = dmp.make_train_step()
    batch = next(iter(ds))
    for _ in range(3):
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
    assert state["step"] == 3
    assert not torch.equal(state["tables"]["tw_d16"], t0)
    f32 = _port_dmp(dict(zip(KEYS, ds.caps)), device="cpu")
    assert f32.sr_seeds(0) is None


def test_dmp_dense_state_holds_no_table():
    """The DMP's model keeps its collection on meta (moved to the step's
    device, it stays there), and the train state's dense parameters and
    their Adagrad state are the model's without its tables."""
    caps = {k: B * n for k, n in zip(KEYS, IDS)}
    dmp = _port_dmp(caps, device="cpu")
    assert dmp.model.embedding_bag_collection.is_meta
    state = dmp.init(torch.Generator().manual_seed(0))
    want = sorted(dense_state_dict(dmp.model))
    assert sorted(state["dense"]) == sorted(state["dense_opt"]) == want
    assert not any(k.startswith("sparse_arch.") for k in want)


def test_unported_paths_raise():
    caps = {k: B * n for k, n in zip(KEYS, IDS)}
    tables = _tables(EmbeddingBagConfig)
    # a group over two ranks runs its dists on a ShardingEnv
    ebc = ShardedEmbeddingBagCollection.build(
        tables, table_wise_plan(tables), 2, B, caps)
    params = ebc.init_params(torch.Generator().manual_seed(0))
    batch = next(iter(RandomRecDataset(KEYS, B, [ROWS] * len(KEYS), IDS,
                                       num_dense=DENSE_IN)))
    with pytest.raises(ValueError, match="ShardingEnv"):
        ebc.forward_local(params, batch.sparse_features)
    # the dedup'd row-wise dist is ported: the dedup lookup runs on a
    # row-wise group (the same sums as the per-id one) and a dedup plan
    # compiles to a group of its own
    rw = {t.name: ParameterSharding(ShardingType.ROW_WISE, ranks=[0])
          for t in tables}
    rw_ebc = ShardedEmbeddingBagCollection.build(tables, rw, 1, B, caps)
    rw_params = rw_ebc.init_params(torch.Generator().manual_seed(0))
    b4, _ = rw_ebc.forward_local(rw_params, batch.sparse_features,
                                 lookup_kernel="dedup")
    b1, _ = rw_ebc.forward_local(rw_params, batch.sparse_features)
    assert all(torch.equal(b4[f], b1[f]) for f in b1)
    rw[tables[0].name].dedup = True
    dedup_ebc = ShardedEmbeddingBagCollection.build(tables, rw, 1, B, caps)
    assert sorted(dedup_ebc.rw_layouts) == [f"rw_d{D}", f"rw_dedup_d{D}"]
    assert dedup_ebc.rw_layouts[f"rw_dedup_d{D}"].dedup
    # the fused kernels keep float32 optimizer states only (the JAX
    # package's momentum_dtype is not ported): a float64 Adam state raises
    sg = SparseSegGrad(torch.zeros(4, dtype=torch.int64),
                       torch.ones(4, dtype=torch.bool),
                       torch.zeros(4, dtype=torch.int64), None,
                       torch.zeros((1, D)))
    with pytest.raises(TypeError):
        apply_sparse_update_segments(
            torch.zeros((ROWS, D)),
            {"m": torch.zeros((ROWS, D), dtype=torch.float64),
             "v": torch.zeros((ROWS, D)), "step": 0},
            sg, FusedOptimConfig(optim=EmbOptimType.ADAM),
            update_kernel="tbe")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _port_dmp(caps)  # CUDA by default, and there is no card
