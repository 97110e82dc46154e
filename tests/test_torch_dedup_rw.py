"""Port parity for the dedup'd row-wise input dist: the source-side
dispatch (``_rw_dedup_dispatch``) against the JAX package's, output for
output, and the sharded DMP across 4 ranks (4 gloo processes on the CPU,
one launch) against the JAX DMP on a 4-device mesh of the conftest's
virtual CPU devices, 3 train steps at 4 tables x 1,000 x 16, B=64 per
rank, multi-hot, from the same carried state on the same
``RandomRecDataset`` batches (rank ``r`` takes batch ``step * 4 + r``):

* ``rw_dedup``: every table row-wise with ``dedup``;
* ``mixed``: two dedup'd row-wise tables, a table-wise and a
  data-parallel one, guardrails on in both packages (and a corrupt
  rank-0 batch whose ``id_violations`` summed over ranks is the injected
  count);
* ``rw_twrw_dedup_kernels``: plain row-wise and table-row-wise groups on
  the ragged dedup lookup (B4) and update (B6), against the JAX DMP on
  its ``xla_dedup`` lookup.

Each rank's KeyedTensor on the first batch is ``torch.equal`` to the
unsharded EmbeddingBagCollection's over the same weights on the dedup'd
plans (the source pools the same rows in slot order).  The id dist of
the dedup'd plan ships at most the plain row-wise plan's bytes divided by
the measured duplication, and an undersized capacity (``dedup_factor``
64) reports the distinct ids it dropped, the JAX dispatch's count.

In the same launch, ``BucketedTrainPipeline`` and
``BucketedTrainPipelineSemiSync`` run a dedup'd plan at ``dedup_factor``
4 on ranks of unequal traffic (one rank a step sends its whole batch,
the others a few examples): every rank dispatches the signature that
the maximum over ranks of the occupancy and the dedup demand gives, and
counts the same downgrades, on steps where one rank alone passes the
capacity.

Tolerances: the dispatch is exact; losses ``rtol = 1e-5``, logits and
tables ``atol = 1e-5`` against JAX, as ``tests/test_torch_sharded_dmp.py``
holds the plain dists: XLA and PyTorch sum the dense matmuls in other
orders, and the port's per-id update (B2's plain version) reduces
rowwise Adagrad's mean in another order than XLA.
"""

import types

import jax
import numpy as np
import optax
import pytest

from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.ops.embedding_ops import trace_kernels
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection as JSEBC,
)
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.sharding.common import (
    feature_specs_for_tables as jspecs,
)
from torchrec_tpu.parallel.sharding.rw import _rw_dedup_dispatch as jdispatch
from torchrec_tpu.parallel.sharding.rw import build_rw_layout as jbuild
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.robustness.policy import GuardrailsConfig as JGuard
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.parallel.multiprocess import launch
from torchrec_tpu_torch.parallel.sharding.common import (
    feature_specs_for_tables,
)
from torchrec_tpu_torch.parallel.sharding.rw import (
    _rw_dedup_dispatch,
    build_rw_layout,
    dedup_cap_for,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.sparse.jagged_tensor import bucketed_cap

import torch_dedup_workers as workers

WORLD, STEPS = 4, 3
KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN = 1000, 16, 64, 13
IDS = [3, 1, 2, 4]
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LR = 0.05
TABLES = [{"name": f"t_{k}", "rows": ROWS, "dim": D, "features": [k],
           "pooling": "SUM"} for k in KEYS]
ALL = list(range(WORLD))
RW, RW_DEDUP = ("row_wise", ALL, 1, False, 1.0), ("row_wise", ALL, 1, True,
                                                  1.0)
PLANS = {
    "rw_dedup": {t["name"]: RW_DEDUP for t in TABLES},
    "mixed": {"t_f0": RW_DEDUP, "t_f1": ("table_wise", [2], 1, False, 1.0),
              "t_f2": RW_DEDUP, "t_f3": ("data_parallel", None, 1, False,
                                         1.0)},
    "rw_twrw_dedup_kernels": {
        "t_f0": RW, "t_f1": ("table_row_wise", [0, 1], 1, False, 1.0),
        "t_f2": RW, "t_f3": ("table_row_wise", [2, 3], 1, False, 1.0)},
}
JOBS = (("rw_dedup", "tbe", False), ("mixed", "tbe", True),
        ("rw_twrw_dedup_kernels", "dedup", False))
SMALL = {t["name"]: ("row_wise", ALL, 1, True, 64.0) for t in TABLES}
# the bucketed pipelines across ranks: rank HEAVY[s] sends its whole batch
# of step s, the others their first KEEP examples
PIPE = {t["name"]: ("row_wise", ALL, 1, True, 4.0) for t in TABLES}
HEAVY, KEEP = (0, 1, 2, 3, None, 0), 8
POISON = (2, [-1, ROWS, ROWS + 5])  # key index, ids (all invalid)


# -- the dispatch -----------------------------------------------------------


def _layouts(N, factor, caps):
    port_t = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                 name=f"t{i}", feature_names=[f"k{i}"],
                                 pooling=PoolingType.SUM)
              for i, r in enumerate((37, 200, 9))]
    jax_t = [JCfg(num_embeddings=c.num_embeddings, embedding_dim=D,
                  name=c.name, feature_names=c.feature_names,
                  pooling=JPooling.SUM) for c in port_t]
    caps = {f"k{i}": c for i, c in enumerate(caps)}
    return (build_rw_layout("g", feature_specs_for_tables(port_t, caps), N,
                            8, dedup=True, dedup_factor=factor),
            jbuild("g", jspecs(jax_t, caps), N, 8, dedup=True,
                   dedup_factor=factor))


@pytest.mark.parametrize("case", ["unweighted", "weighted", "drop_zero",
                                  "undersized"])
def test_dedup_dispatch_matches_jax(case):
    rng = np.random.RandomState(3)
    caps = [24, 40, 16]
    rows = (37, 200, 9)
    lengths = rng.randint(0, 5, size=3 * 8).astype(np.int32)
    lengths[8:16] = rng.randint(0, 6, size=8)
    values, weights = [], []
    for f in range(3):
        n = int(lengths[f * 8:(f + 1) * 8].sum())
        values.append(rng.randint(0, rows[f], size=n))
        weights.append(rng.rand(n).astype(np.float32))
    values = np.concatenate(values).astype(np.int64)
    weights = np.concatenate(weights)
    if case == "drop_zero":
        # the sanitizer's null slots (id 0, weight 0), and a user's weight
        # 0 on another id, which still ships
        values[:3], weights[:3] = 0, 0.0
        weights[5] = 0.0
        values[5] = max(values[5], 1)
    w = None if case == "unweighted" else weights
    port = KeyedJaggedTensor.from_lengths_packed(["k0", "k1", "k2"], values,
                                                 lengths, w, caps=caps)
    ref = JKJT.from_lengths_packed(["k0", "k1", "k2"], values, lengths, w,
                                   caps=caps)
    lay, jlay = _layouts(4, 16.0 if case == "undersized" else 1.0, caps)
    assert lay.dedup_cap == jlay.dedup_cap
    drop = case == "drop_zero"
    got = _rw_dedup_dispatch(lay, port, drop)
    want = jdispatch(jlay, ref, drop)
    for name, g, x in zip(("ids_send", "sidx", "seg_global", "weights",
                           "overflow"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                      err_msg=name)
    assert (int(got[4]) > 0) == (case == "undersized")


# -- the sharded DMP --------------------------------------------------------


def _jplan(spec):
    return {n: JPS(JST(st), ranks=r, num_col_shards=c, dedup=d,
                   dedup_factor=f)
            for n, (st, r, c, d, f) in spec.items()}


def _jtables():
    return tuple(JCfg(num_embeddings=ROWS, embedding_dim=D, name=t["name"],
                      feature_names=t["features"], pooling=JPooling.SUM)
                 for t in TABLES)


def _jax_run(plan, kernel, guarded):
    """The JAX DMP's initial state (numpy), its replicated groups, losses,
    tables after ``STEPS`` steps, the forward's logits of the next
    batches and (guarded) the ``id_violations`` of a poisoned step."""
    tables = _jtables()
    ds = JDataset(KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN,
                  manual_seed=0)
    dmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=DENSE_ARCH,
            over_arch_layer_sizes=OVER_ARCH),
        tables=tables,
        env=ShardingEnv.from_mesh(create_mesh((WORLD,), (MODEL_AXIS,))),
        plan=_jplan(PLANS[plan]), batch_size_per_device=B,
        feature_caps=dict(zip(KEYS, ds.caps)), dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR),
        guardrails=JGuard() if guarded else None)
    state = dmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, state)
    it = iter(ds)
    losses = []
    pooled = "xla_dedup" if kernel == "dedup" else "xla"
    with trace_kernels(pooled=pooled, update="xla"):
        step = dmp.make_train_step(donate=False)
        for _ in range(STEPS):
            state, m = step(state, stack_batches([next(it)
                                                  for _ in range(WORLD)]))
            losses.append(float(m["loss"]))
            assert ("dedup_overflow" in m) == (plan != "rw_twrw_dedup_kernels")
        logits = dmp.make_forward()(
            state["dense"], state["tables"],
            stack_batches([next(it) for _ in range(WORLD)]))
    return (start, list(dmp.sharded_ebc.dp_groups), losses,
            dmp.table_weights(state), np.asarray(logits),
            dict(zip(KEYS, ds.caps)))


def _jax_overflow():
    """The JAX dispatch's dropped distinct ids at ``dedup_factor`` 64 on
    each rank's first batch, summed."""
    tables = _jtables()
    ds = JDataset(KEYS, B, [ROWS] * len(KEYS), IDS, num_dense=DENSE_IN,
                  manual_seed=0)
    ebc = JSEBC.build(tables, _jplan(SMALL), WORLD, B,
                      dict(zip(KEYS, ds.caps)))
    (lay,) = ebc.rw_layouts.values()
    it = iter(ds)
    return sum(int(jdispatch(lay, next(it).sparse_features)[4])
               for _ in range(WORLD))


def test_dedup_rw_dmp_matches_jax():
    wants = {plan: _jax_run(plan, kernel, guarded)
             for plan, kernel, guarded in JOBS}
    jobs = [(PLANS[plan], wants[plan][0], wants[plan][1], kernel, guarded)
            for plan, kernel, guarded in JOBS]
    port = launch(workers.dedup_rank, WORLD, args=(
        TABLES, jobs, KEYS, wants["rw_dedup"][5], B, IDS, DENSE_IN,
        DENSE_ARCH, OVER_ARCH, LR, STEPS, {t["name"]: RW for t in TABLES},
        SMALL, POISON, PIPE, HEAVY, KEEP), timeout=240)
    for j, (plan, kernel, guarded) in enumerate(JOBS):
        _, _, want_losses, want_tables, want_logits, _ = wants[plan]
        for r, rank in enumerate(port):
            kt_equal, losses, overflow, logits, _, violations = rank["jobs"][j]
            if plan != "rw_twrw_dedup_kernels":
                # the dedup'd groups (and TW/DP) pool what one device does
                assert kt_equal, (plan, r)
                assert overflow == [0] * STEPS
            else:
                assert overflow == [None] * STEPS
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5,
                                       atol=0, err_msg=f"{plan} rank {r}")
            np.testing.assert_allclose(logits, want_logits[r], rtol=0,
                                       atol=1e-5, err_msg=f"{plan} rank {r}")
            if guarded:
                assert violations.tolist() == [0, 0, len(POISON[1]), 0]
            else:
                assert violations is None
        tables = port[0]["jobs"][j][4]
        for t, w in want_tables.items():
            np.testing.assert_allclose(tables[t], np.asarray(w), rtol=0,
                                       atol=1e-5, err_msg=f"{plan} {t}")
    for rank in port:
        led = rank["ledgers"]
        assert 0 < led["dedup"] <= led["plain"] / rank["dup"], led
    local = [rank["overflow"][0] for rank in port]
    assert all(rank["overflow"][1] == sum(local) for rank in port)
    assert sum(local) == _jax_overflow() > 0
    _check_bucketed_agreement([rank["pipelines"] for rank in port],
                              wants["rw_dedup"][5])


def _check_bucketed_agreement(pipes, caps):
    """The bucketed pipelines on ranks of unequal traffic: every rank
    dispatched the same signature each step, the one its occupancy and
    dedup demand give at their maximum over ranks (downgraded to full
    capacity where that demand passes the signature's dedup capacity),
    and counted the same downgrades; the stream has steps where one
    rank's local view alone would pick another signature and another
    decision."""
    names, block_size, factor = pipes[0]["layout"]
    feats = [types.SimpleNamespace(name=n, table_name=t) for n, t in names]
    full = [caps[k] for k in KEYS]
    want, downgrades, split = [], 0, 0
    for s in range(len(HEAVY)):
        occ = [p["local_occupancy"][s] for p in pipes]
        joint = [max(o[f] for o in occ) for f in range(len(KEYS))]
        sig = [bucketed_cap(o, c) for o, c in zip(joint, full)]
        cap = dedup_cap_for(feats, dict(zip(KEYS, sig)), block_size, factor)
        demands = [p["local_demand"][s] for p in pipes]
        downgrades += max(demands) > cap
        want.append(full if max(demands) > cap else sig)
        local_sigs = {tuple(bucketed_cap(o, c) for o, c in zip(x, full))
                      for x in occ}
        split += len(local_sigs) > 1 and min(demands) <= cap < max(demands)
    assert split > 0 and 0 < downgrades < len(HEAVY), (want, downgrades)
    for kind in ("sync", "semi_sync"):
        for r, p in enumerate(pipes):
            assert p[kind]["sigs"] == want, (kind, r)
            assert p[kind]["overflow"] == downgrades, (kind, r)
            assert np.isfinite(p[kind]["losses"]).all(), (kind, r)
