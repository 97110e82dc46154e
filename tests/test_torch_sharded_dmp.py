"""The port's DistributedModelParallel across 4 ranks (4 gloo processes on
the CPU) against the JAX DMP on a 4-device mesh of the conftest's virtual
CPU devices: 3 train steps at 4 tables x 1,000 x 16, B=64 per rank, from
the same carried state (each rank its share, ``convert.py``) on the same
``RandomRecDataset`` batches (rank ``r`` takes batch ``step * 4 + r``),
over two plans that between them hold every plan kind of
``tests/test_sharded_ebc.py``: RW + TW + CW + DP, and TWRW + GRID + TWCW +
TW; the first spawn also runs the plan of both packages' planners at
world 4 (the same plan).  After the steps, each rank's eval forward
(``make_forward``) against its row of the JAX forward's ``[N, B]``
logits, and one step with rank 0's batch over capacity: ``id_overflow``
summed over ranks equals the JAX step's.  One spawn a plan; JAX on its XLA
kernels, the port on its plain versions."""

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
from torchrec_tpu.ops.embedding_ops import trace_kernels
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.planner.planners import (
    EmbeddingShardingPlanner as JPlanner,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.convert import flax_params_from_dlrm_state_dict
from torchrec_tpu_torch.ir.serializer import serialize_plan
from torchrec_tpu_torch.parallel.multiprocess import launch
from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner

import torch_sharding_workers as workers

WORLD, STEPS = 4, 3
KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN = 1000, 16, 64, 13
IDS = [3, 1, 2, 4]  # ids per example per feature: duplicates, multi-hot
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LR = 0.05
TABLES = [{"name": f"t_{k}", "rows": ROWS, "dim": D, "features": [k],
           "pooling": "SUM"} for k in KEYS]
ALL = list(range(WORLD))
PLANS = {
    "rw_tw_cw_dp": {"t_f0": ("row_wise", ALL, 1),
                    "t_f1": ("table_wise", [3], 1),
                    "t_f2": ("column_wise", [1, 2], 1),
                    "t_f3": ("data_parallel", None, 1)},
    "twrw_grid_twcw": {"t_f0": ("table_row_wise", [0, 1], 1),
                       "t_f1": ("grid_shard", ALL, 2),
                       "t_f2": ("table_column_wise", [2, 3], 1),
                       "t_f3": ("table_wise", [1], 1)},
}


OVER = (0, 4)  # rank 0's f0 claims 4 ids an example, cap 3 an example


def _planned_spec():
    """The plan both packages' planners give the test tables at world 4
    (asserted equal), as a plan spec."""
    jplan = JPlanner(world_size=WORLD, batch_size_per_device=B).plan(
        tuple(JCfg(num_embeddings=ROWS, embedding_dim=D, name=t["name"],
                   feature_names=t["features"], pooling=JPooling.SUM)
              for t in TABLES))
    tplan = EmbeddingShardingPlanner(
        world_size=WORLD, batch_size_per_device=B).plan(
            workers.make_tables(TABLES))
    assert serialize_plan(tplan) == serialize_plan(jplan)
    return {n: (ps.sharding_type.value, ps.ranks, ps.num_col_shards)
            for n, ps in tplan.items()}


def _over_cap_jax(batch):
    kjt = batch.sparse_features
    lengths = np.asarray(kjt.lengths()).copy()
    k = OVER[0]
    lengths[k * B:(k + 1) * B] = OVER[1]
    return batch.__class__(batch.dense_features, JKJT(
        kjt.keys(), kjt.values(), jax.numpy.asarray(lengths), stride=B,
        caps=kjt.caps), batch.labels, batch.weights)


def _jax_run(plan_spec):
    """The JAX DMP's initial state (numpy), its losses and its state
    after ``STEPS`` steps, the forward's logits of the next batches and
    the ``id_overflow`` of one step with batch 0 over capacity."""
    tables = tuple(JCfg(num_embeddings=ROWS, embedding_dim=D,
                        name=t["name"], feature_names=t["features"],
                        pooling=JPooling.SUM) for t in TABLES)
    ds = JDataset(KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN,
                  manual_seed=0)
    dmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=DENSE_ARCH,
            over_arch_layer_sizes=OVER_ARCH),
        tables=tables,
        env=ShardingEnv.from_mesh(create_mesh((WORLD,), (MODEL_AXIS,))),
        plan={n: JPS(JST(st), ranks=r, num_col_shards=c)
              for n, (st, r, c) in plan_spec.items()},
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR),
    )
    state = dmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, state)
    start_tables = dmp.table_weights(state)
    it = iter(ds)
    losses = []
    with trace_kernels(pooled="xla", update="xla"):
        step = dmp.make_train_step(donate=False)
        for _ in range(STEPS):
            state, m = step(state, stack_batches([next(it)
                                                  for _ in range(WORLD)]))
            losses.append(float(m["loss"]))
        logits = dmp.make_forward()(
            state["dense"], state["tables"],
            stack_batches([next(it) for _ in range(WORLD)]))
        over = [next(it) for _ in range(WORLD)]
        over[0] = _over_cap_jax(over[0])
        _, m = step(state, stack_batches(over))
    return (start, start_tables, dict(zip(KEYS, ds.caps)),
            list(dmp.sharded_ebc.dp_groups), losses, dmp.table_weights(state),
            jax.tree.map(np.asarray, state["dense"]), np.asarray(logits),
            np.asarray(m["id_overflow"]))


def _check(port_job, want):
    """One job's results on every rank against the JAX run's."""
    (_, start_tables, _, _, want_losses, want_tables, want_dense,
     want_logits, want_overflow) = want
    assert want_overflow.tolist() == [B * OVER[1] - B * IDS[0], 0, 0, 0]
    for r, (losses, logits, overflow, _) in enumerate(port_job):
        # every rank reports the loss averaged over the 4 ranks
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(logits, want_logits[r], rtol=0,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_array_equal(overflow, want_overflow)
    tables, dense = port_job[0][3]
    for t, w in want_tables.items():
        np.testing.assert_allclose(tables[t], np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=t)
        moved = (tables[t] != np.asarray(start_tables[t])).any(axis=1)
        assert moved.sum() > 10, t  # the steps touched many rows
    got = flax_params_from_dlrm_state_dict(
        {k: torch.from_numpy(v) for k, v in dense.items()})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_dense)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_sharded_dmp_matches_jax(plan):
    specs = [PLANS[plan]]
    if plan == "rw_tw_cw_dp":
        specs.append(_planned_spec())
    wants = [_jax_run(s) for s in specs]
    jobs = [(s, w[0], w[3]) for s, w in zip(specs, wants)]
    port = launch(workers.dmp_rank, WORLD, args=(
        TABLES, jobs, KEYS, wants[0][2], B, IDS, DENSE_IN, DENSE_ARCH,
        OVER_ARCH, LR, STEPS, OVER), timeout=120)
    for j, want in enumerate(wants):
        _check([rank[j] for rank in port], want)
