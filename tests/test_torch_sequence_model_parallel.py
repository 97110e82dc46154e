"""The port's ``SequenceModelParallel`` training BERT4Rec across 4 ranks
(4 gloo processes on the CPU, one launch) against the JAX
``SequenceModelParallel`` on a 4-device mesh of the conftest's virtual
CPU devices, the cases of ``tests/test_sequence_model_parallel.py`` at a
world of 4: a row-wise plan and a table-wise plan (the item table on rank
3).  The JAX state crosses to each rank through ``convert.py``; each
rank's per-id rows before training equal the unsharded
``EmbeddingCollection``'s (``torch.equal``: a row gather has no sum),
and after 3 steps (fused Adam on the item table through B6's plain
version, dense Adam) the losses and tables match JAX's.  The class
refuses a 2D world.

Tolerances: losses ``rtol = 1e-5`` (XLA and PyTorch sum the dense
products in other orders); the tables ``atol = 5e-5`` after 3 Adam steps
at lr 1e-2 (Adam moves every element by about ``lr``; where an element's
gradient is near zero, the dense side's last-bit differences change the
step; ``tests/test_torch_bert4rec.py`` holds the one-rank run alike)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.models.experimental.bert4rec import BERT4Rec as JBERT
from torchrec_tpu.models.experimental.bert4rec import (
    masked_item_loss as j_loss,
)
from torchrec_tpu.modules.embedding_configs import EmbeddingConfig as JCfg
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import ShardingEnv as JEnv
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.sequence_model_parallel import (
    SequenceModelParallel as JSMP,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import JaggedTensor as JJT
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.examples.bert4rec.main import make_session_batch
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_sequence_workers as workers

WORLD, STEPS = 4, 3
SPEC = {"B": 4, "L": 8, "V": 1000, "D": 16, "H": 2, "blocks": 1,
        "lr": 1e-2}
PLANS = {"rw": ("row_wise", list(range(WORLD))), "tw": ("table_wise", [3])}


def _jax_loss(model, dense_params, emb_values, b):
    L = SPEC["L"]
    lengths = b.sparse_features["item"].lengths()
    x = JJT(emb_values["item"], lengths).to_padded_dense(L)
    mask = jnp.arange(L)[None, :] < lengths[:, None]
    logits = model.apply(dense_params, x, mask,
                         method=JBERT.forward_from_embeddings)
    return j_loss(logits, b.dense_features.astype(jnp.int32), b.labels)


def _data(seed):
    """Every step's per-rank session data: ``(values, lengths, targets,
    mask)`` numpy."""
    B, L, V = SPEC["B"], SPEC["L"], SPEC["V"]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        per = []
        for _ in range(WORLD):
            b = make_session_batch(rng, B, L, V)
            kjt = b.sparse_features
            n = int(kjt.lengths().sum())
            per.append((kjt.values().numpy()[:n], kjt.lengths().numpy(),
                        b.dense_features.numpy(), b.labels.numpy()))
        out.append(per)
    return out


def _jax_batch(d):
    values, lengths, targets, mask = d
    kjt = JKJT.from_lengths_packed(["item"], values, lengths,
                                   caps=SPEC["B"] * SPEC["L"])
    return JBatch(jnp.asarray(targets), kjt, jnp.asarray(mask))


def _jax_run(kind, steps, mesh):
    B, L, V, D = SPEC["B"], SPEC["L"], SPEC["V"], SPEC["D"]
    model = JBERT(vocab_size=V, max_len=L, emb_dim=D,
                  num_blocks=SPEC["blocks"], num_heads=SPEC["H"])
    st, ranks = PLANS[kind]
    smp = JSMP(model=model,
               tables=(JCfg(num_embeddings=V, embedding_dim=D,
                            name="t_item", feature_names=["item"]),),
               env=JEnv.from_mesh(mesh),
               plan={"t_item": JPS(JST(st), ranks=ranks)},
               batch_size_per_device=B, feature_caps={"item": B * L},
               loss_fn=_jax_loss,
               fused_config=JFused(optim=JOptim.ADAM,
                                   learning_rate=SPEC["lr"]),
               dense_optimizer=optax.adam(SPEC["lr"]))

    def dense_init(key):
        return model.init(key, jnp.zeros((B, L, D)), jnp.ones((B, L), bool),
                          method=JBERT.forward_from_embeddings)

    state = smp.init(jax.random.key(3), dense_init)
    start = jax.tree.map(np.asarray, state)
    w0 = np.array(smp.table_weights(state)["t_item"])
    step = smp.make_train_step(donate=False)
    losses = []
    for per in steps:
        state, m = step(state, stack_batches([_jax_batch(d) for d in per]))
        losses.append(float(m["loss"]))
    return start, w0, losses, np.asarray(smp.table_weights(state)["t_item"])


@pytest.fixture(scope="module")
def world():
    steps = _data(7)
    mesh = create_mesh((WORLD,), ("model",), devices=jax.devices()[:WORLD])
    want = {k: _jax_run(k, steps, mesh) for k in PLANS}
    ranks = launch(workers.smp_rank, WORLD, args=(
        SPEC, PLANS, {k: w[0] for k, w in want.items()}, steps),
        timeout=300)
    return steps, want, ranks


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_sharded_rows_before_training_equal_unsharded(world, kind):
    steps, want, ranks = world
    w0 = want[kind][1]
    for r, (res, _) in enumerate(ranks):
        rows, ref, _, _ = res[kind]
        np.testing.assert_array_equal(rows, ref, err_msg=f"rank {r}")
        values, lengths = steps[0][r][:2]
        n = int(lengths.sum())
        np.testing.assert_array_equal(rows[:n], w0[values])
        assert not rows[n:].any()


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_losses_and_tables_after_three_steps_match_jax(world, kind):
    _, want, ranks = world
    _, w0, j_losses, j_table = want[kind]
    for r, (res, _) in enumerate(ranks):
        np.testing.assert_allclose(res[kind][2], j_losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
    table = ranks[0][0][kind][3]
    np.testing.assert_allclose(table, j_table, rtol=0, atol=5e-5)
    assert (table != w0).any() and (j_table != w0).any()


def test_refuses_a_2d_world(world):
    assert all(refused for _, refused in world[2])
