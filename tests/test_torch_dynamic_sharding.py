"""The port's dynamic resharding and elastic restore
(``parallel/dynamic_sharding.py``, ``Checkpointer.restore_elastic``)
against the JAX package's, and the cases of ``tests/test_dynamic_sharding.py``
in the port.

One gloo launch of 4 ranks on the CPU (``torch_reliability_workers.
reshard_rank``) carries the JAX DMP's start state under plan A (RW + TW),
takes a step, then reshards onto plan B (TW + RW + CW) and plan C (TWRW +
GRID + DP): weights and per-table slots ``np.array_equal`` across each
reshard, the forward's logits close to plan A's, and the next step on a
fresh DMP of the new plan loaded with the same weights and slots
``torch.equal``; A -> B -> A gives the first stacks back bit for bit; a
world-4 checkpoint restores through ``restore_elastic`` at world 2 (ranks
0 and 1) and, here, at world 1, bit for bit; a ``DMPCollection`` of 2 x 2
ranks (REPLICATED after a sync, and FULLY_SHARDED) restores its own
share bit for bit, and a table's rows and slots round-trip through the
row-state surface in place.  The JAX DMP on a 4-device
mesh runs the same steps and reshards: the weights and slots after the
reshard and one more step agree within the tolerances of
``tests/test_torch_dlrm_train.py`` (tables ``atol = 2e-6``, momentum
``rtol = 1e-5``), and so do the JAX package's own ``restore_elastic`` of
its world-4 checkpoint at world 2 and the port's.  Logits across a
reshard: ``rtol = 1e-4, atol = 1e-5``, as the JAX test holds them (a
row-wise table's pooled sums add the ranks' parts in another order).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.checkpoint import Checkpointer as JCheckpointer
from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.ops.embedding_ops import trace_kernels
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS
from torchrec_tpu.parallel.comm import ShardingEnv as JEnv
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.dynamic_sharding import _slots_to_tables
from torchrec_tpu.parallel.dynamic_sharding import reshard as jreshard
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu_torch.checkpoint import (
    Checkpointer,
    CheckpointPlanMismatch,
)
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.dynamic_sharding import slots_to_tables
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_reliability_workers as workers

WORLD, STEPS, LR = 4, 1, 0.05
KEYS = ["a", "b", "c"]
ROWS, D, B, IDS = [600, 200, 128], 16, 8, [2, 1, 1]
ALL = list(range(WORLD))
W = {"tables": [{"name": f"t{k}", "rows": r, "dim": D, "features": [k],
                 "pooling": "SUM"} for k, r in zip(KEYS, ROWS)],
     "keys": KEYS, "ids": IDS, "batch": B, "dense_in": 4,
     "dense_arch": (8, D), "over_arch": (8, 1), "lr": LR}
PLANS = {
    "A": {"ta": ("row_wise", ALL, 1), "tb": ("table_wise", [2], 1),
          "tc": ("table_wise", [3], 1)},
    "B": {"ta": ("table_wise", [0], 1), "tb": ("row_wise", ALL, 1),
          "tc": ("column_wise", [1, 3], 2)},
    "C": {"ta": ("table_row_wise", [2, 3], 1),
          "tb": ("grid_shard", ALL, 2), "tc": ("data_parallel", None, 1)},
    "two": {"ta": ("row_wise", [0, 1], 1), "tb": ("table_wise", [1], 1),
            "tc": ("table_wise", [0], 1)},
}
TABLE_ATOL, SLOT_RTOL = 2e-6, 1e-5


def _jplan(name):
    return {n: JPS(JST(st), ranks=r, num_col_shards=c)
            for n, (st, r, c) in PLANS[name].items()}


def _jdmp(plan, world, caps):
    tables = tuple(JCfg(num_embeddings=r, embedding_dim=D, name=f"t{k}",
                        feature_names=[k], pooling=JPooling.SUM)
                   for k, r in zip(KEYS, ROWS))
    return JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=4,
            dense_arch_layer_sizes=(8, D), over_arch_layer_sizes=(8, 1)),
        tables=tables,
        env=JEnv.from_mesh(create_mesh((world,), (MODEL_AXIS,))),
        plan=plan, batch_size_per_device=B, feature_caps=caps,
        dense_in_features=4,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))


def _jax_start():
    """The JAX DMP under plan A, its start state (device and numpy), the
    caps and the global batches of steps 0 .. STEPS."""
    ds = JDataset(KEYS, B, ROWS, IDS, num_dense=4, manual_seed=0)
    caps = dict(zip(KEYS, ds.caps))
    it = iter(ds)
    batches = [stack_batches([next(it) for _ in range(WORLD)])
               for _ in range(STEPS + 1)]
    dmp = _jdmp(_jplan("A"), WORLD, caps)
    state = dmp.init(jax.random.key(0))
    return dmp, state, jax.tree.map(np.asarray, state), caps, batches


def _jax_run(dmp, state, caps, batches, ckpt_dir):
    """The JAX side after the start: a step under A, then each reshard
    and one step; the world-4 checkpoint restored at world 2."""
    out = {}
    with trace_kernels(pooled="xla", update="xla"):
        step = dmp.make_train_step(donate=False)
        for b in batches[:STEPS]:
            state, _ = step(state, b)
        for name in ("B", "C"):
            new_dmp, new_state = jreshard(dmp, state, _jplan(name))
            new_state, _ = new_dmp.make_train_step(donate=False)(
                new_state, batches[STEPS])
            out[name] = (new_dmp.table_weights(new_state),
                         _slots_to_tables(new_dmp, new_state["fused"]))
    JCheckpointer(ckpt_dir).save(dmp, state)
    dmp2 = _jdmp(_jplan("two"), 2, caps)
    s2 = JCheckpointer(ckpt_dir).restore_elastic(dmp2, STEPS)
    out["two"] = (dmp2.table_weights(s2),
                  _slots_to_tables(dmp2, s2["fused"]))
    return out


def _close(port, want):
    weights, slots = port
    jw, js = want
    for t, w in jw.items():
        np.testing.assert_allclose(weights[t], np.asarray(w), rtol=0,
                                   atol=TABLE_ATOL, err_msg=t)
        np.testing.assert_allclose(slots[t]["momentum"],
                                   np.asarray(js[t]["momentum"]),
                                   rtol=SLOT_RTOL, atol=0, err_msg=t)


def test_reshard_and_restore_elastic_match_jax(tmp_path):
    jdmp, jstate, start, caps, batches = _jax_start()
    w = dict(W, caps=caps)
    ckpt = str(tmp_path / "port")
    # the port's ranks (other processes) run while the JAX side does
    with ThreadPoolExecutor(1) as pool:
        port_run = pool.submit(launch, workers.reshard_rank, WORLD,
                               args=(w, PLANS, start, STEPS, ckpt),
                               timeout=240)
        want = _jax_run(jdmp, jstate, caps, batches, str(tmp_path / "jax"))
        ranks = port_run.result()
    for r, out in enumerate(ranks):
        for name in ("B", "C"):
            np.testing.assert_allclose(out["logits"][name],
                                       out["logits"]["A"], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {r}")
            assert out[f"{name}_fresh_equal"], f"{name} rank {r}"
        assert out["chain_equal"], f"rank {r}"
        if r < 2:
            assert out["world2_equal"], f"rank {r}"
        assert out["dmp2d"] == {"replicated": True,
                                "fully_sharded": True}, f"rank {r}"
    port = ranks[0]
    for name in ("B", "C"):
        _close(port[name], want[name])
    # the JAX package's world-2 restore against the port's saved state
    _close((port["weights"], port["slots"]), want["two"])

    # the world-4 checkpoint at world 1 here: the same weights and slots
    dmp1 = workers._dmp(w, {"ta": ("table_wise", [0], 1),
                            "tb": ("table_wise", [0], 1),
                            "tc": ("table_wise", [0], 1)},
                        ShardingEnv.single_device("cpu"))
    s1 = Checkpointer(ckpt).restore_elastic(dmp1, STEPS)
    assert s1["step"] == STEPS
    got = dmp1.table_weights(s1)
    for t, arr in port["weights"].items():
        np.testing.assert_array_equal(got[t], arr)
    slots1 = slots_to_tables(dmp1, s1)
    for t, sl in port["slots"].items():
        if t == "__scalars__":
            continue
        np.testing.assert_array_equal(slots1[t]["momentum"].numpy(),
                                      sl["momentum"])
    # the exact restore under the saving plan's layout refuses world 1
    with pytest.raises(CheckpointPlanMismatch, match="sharding plan"):
        Checkpointer(ckpt).restore(dmp1, STEPS)
    assert os.path.isdir(os.path.join(ckpt, f"step_{STEPS}"))
    # the port's checkpoint holds every table's rows once, plan-free
    assert sorted(got) == ["ta", "tb", "tc"]
    assert all(torch.as_tensor(got[t]).shape[0] == r
               for t, r in zip(["ta", "tb", "tc"], ROWS))
