"""The port's DistributedModelParallel across 4 ranks (4 gloo processes on
the CPU) against the JAX DMP on a 4-device mesh of the conftest's virtual
CPU devices: 3 train steps at 4 tables x 1,000 x 16, B=64 per rank, from
the same carried state (each rank its share, ``convert.py``) on the same
``RandomRecDataset`` batches (rank ``r`` takes batch ``step * 4 + r``),
over two plans that between them hold every plan kind of
``tests/test_sharded_ebc.py``: RW + TW + CW + DP, and TWRW + GRID + TWCW +
TW.  One spawn a plan; JAX on its XLA kernels, the port on its plain
versions."""

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
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu_torch.convert import flax_params_from_dlrm_state_dict
from torchrec_tpu_torch.parallel.multiprocess import launch

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


def _jax_run(plan_spec):
    """The JAX DMP's initial state (numpy), its losses and its state
    after ``STEPS`` steps."""
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
    return (start, start_tables, dict(zip(KEYS, ds.caps)),
            list(dmp.sharded_ebc.dp_groups), losses, dmp.table_weights(state),
            jax.tree.map(np.asarray, state["dense"]))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_sharded_dmp_matches_jax(plan):
    (start, start_tables, caps, replicated, want_losses, want_tables,
     want_dense) = _jax_run(PLANS[plan])
    port = launch(workers.dmp_rank, WORLD, args=(
        TABLES, PLANS[plan], KEYS, caps, B, IDS, DENSE_IN, DENSE_ARCH,
        OVER_ARCH, LR, start, replicated, STEPS), timeout=120)
    for r, (losses, _) in enumerate(port):
        # every rank reports the loss averaged over the 4 ranks
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r}")
    tables, dense = port[0][1]
    for t, w in want_tables.items():
        np.testing.assert_allclose(tables[t], np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=t)
        moved = (tables[t] != np.asarray(start_tables[t])).any(axis=1)
        assert moved.sum() > 10, t  # the steps touched many rows
    got = flax_params_from_dlrm_state_dict(
        {k: torch.from_numpy(v) for k, v in dense.items()})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_dense)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
