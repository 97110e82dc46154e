"""The port's DMPCollection (2D parallelism) across 4 ranks, 2 replicas of
2 model ranks (4 gloo processes on the CPU, one spawn), against the JAX
``DMPCollection`` on ``create_mesh((2, 2), (REPLICA_AXIS, MODEL_AXIS))``
over 4 of the conftest's virtual CPU devices, both strategies: REPLICATED
(row-wise + table-wise, rowwise Adagrad, ``sync_interval=2``, the
replicas apart after the first step and equal bit for bit after the
sync) and FULLY_SHARDED (data-parallel + row-wise with the stacks padded
to split over the replicas, Adam on the tables, the replicas always
equal).  Each from the same JAX initial state crossed to each rank by
``convert.train_state_from_jax``; after 3 steps (each followed by
``maybe_sync``) the losses, each rank's eval logits and the whole train
state, brought back by ``convert.train_states_to_jax``, against JAX's
within 1e-5 (the sharded DMP test's tolerance; JAX on its XLA kernels,
the port on its plain versions, which sum in another order)."""

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
from torchrec_tpu.parallel.comm import (
    MODEL_AXIS,
    REPLICA_AXIS,
    ShardingEnv,
    create_mesh,
)
from torchrec_tpu.parallel.model_parallel import DMPCollection as JDMPC
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingStrategy as JStrategy
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu_torch.convert import train_states_to_jax
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_sharding_workers as workers

R, M, STEPS, B = 2, 2, 3, 4
KEYS = ["x", "y"]
ROWS = [401, 2001]  # odd: the FULLY_SHARDED stacks pad to split over R
D, DENSE_IN = 8, 4
DENSE_ARCH, OVER_ARCH = (8, D), (8, 1)
LR = 0.1
TABLES = [{"name": f"t{k}", "rows": h, "dim": D, "features": [k],
           "pooling": "SUM"} for k, h in zip(KEYS, ROWS)]
# (strategy, plan, fused optimizer, sync interval)
JOBS = [
    ("replicated", {"tx": ("row_wise", [0, 1], 1),
                    "ty": ("table_wise", [1], 1)}, "rowwise_adagrad", 2),
    ("fully_sharded", {"tx": ("data_parallel", None, 1),
                       "ty": ("row_wise", [0, 1], 1)}, "adam", 1),
]


def _jax_run(strategy, plan_spec, optim, interval):
    tables = tuple(JCfg(num_embeddings=t["rows"], embedding_dim=D,
                        name=t["name"], feature_names=t["features"],
                        pooling=JPooling.SUM) for t in TABLES)
    ds = JDataset(KEYS, B, ROWS, [2, 1], num_dense=DENSE_IN, manual_seed=0)
    mesh = create_mesh((R, M), (REPLICA_AXIS, MODEL_AXIS),
                       devices=jax.devices()[:R * M])
    dmp = JDMPC(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=DENSE_ARCH,
            over_arch_layer_sizes=OVER_ARCH),
        tables=tables, env=ShardingEnv.from_mesh(mesh),
        plan={n: JPS(JST(st), ranks=r, num_col_shards=c)
              for n, (st, r, c) in plan_spec.items()},
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim(optim), learning_rate=LR),
        dense_optimizer=optax.adagrad(LR), sync_interval=interval,
        sharding_strategy=JStrategy(strategy))
    state = dmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, state)
    it = iter(ds)
    losses = []
    with trace_kernels(pooled="xla", update="xla"):
        step = dmp.make_train_step(donate=False)
        for _ in range(STEPS):
            state, m = step(state, stack_batches(
                [next(it) for _ in range(R * M)]))
            state = dmp.maybe_sync(state)
            losses.append(float(m["loss"]))
        logits = dmp.make_forward()(
            state["dense"], state["tables"],
            stack_batches([next(it) for _ in range(R * M)]))
    return (start, dict(zip(KEYS, ds.caps)), list(dmp.sharded_ebc.dp_groups),
            losses, np.asarray(logits), jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def world():
    wants = [_jax_run(*j) for j in JOBS]
    jobs = [(st, plan, w[0], w[2], interval, optim)
            for (st, plan, optim, interval), w in zip(JOBS, wants)]
    port = launch(workers.dmp2d_rank, R * M, args=(
        TABLES, jobs, KEYS, wants[0][1], B, [2, 1], DENSE_IN, DENSE_ARCH,
        OVER_ARCH, LR, STEPS, R), timeout=180)
    return port, wants


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("job", range(len(JOBS)))
def test_dmp_collection_matches_jax(world, job):
    port, wants = world
    strategy = JOBS[job][0]
    start, _, replicated, want_losses, want_logits, want_state = wants[job]
    ranks = [p[job] for p in port]
    for g, (losses, in_step, logits, _) in enumerate(ranks):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0,
                                   err_msg=f"{strategy} rank {g}")
        _close(logits, want_logits[g], f"{strategy} rank {g} logits")
        if strategy == "replicated":
            # apart after step 1 (each replica its own batches), equal bit
            # for bit after the sync of step 2, apart again after step 3
            assert in_step == [False, True, False], in_step
        else:
            assert all(in_step), in_step
    got = train_states_to_jax([_torch_tree(r[3]) for r in ranks], M, R,
                              strategy == "fully_sharded", replicated)
    for g, t in want_state["tables"].items():
        assert got["tables"][g].shape == t.shape, g
        _close(got["tables"][g], t, f"{strategy} {g}")
        assert (t != start["tables"][g]).any(), g  # the steps moved it
        for k, v in want_state["fused"][g].items():
            _close(got["fused"][g][k], v, f"{strategy} {g} {k}")
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want_state["dense"])):
        _close(a, b, f"{strategy} dense")
    assert int(got["step"]) == int(want_state["step"]) == STEPS
