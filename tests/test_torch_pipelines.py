"""Port parity for the pipelines of ROADMAP A7 at one device: the
semi-synchronous pipelines (plain and bucketed) against the JAX ones on
the same stream, ``invalidate_prefetch``, the prefetch hooks, the staged
and eval pipelines, ``BucketedTrainPipeline.warmup``, the dedup overflow
guard's decisions against the JAX guard's, and the pipelines'
``scalar_metrics`` and ``KernelStats`` counters against the JAX ones.

Tolerances, with their reasons:

* semi-sync against JAX (3 steps, float32): losses ``atol = 1e-6``,
  tables ``atol = 2e-6``, as ``tests/test_torch_bucketing.py``: XLA and
  PyTorch sum the dense matmuls in other orders, and rowwise Adagrad's
  mean over D reduces in another order in the port.
* Everything else is exact: the port's own pipelines against its own
  steps (``torch.equal``), signatures, counters and metric keys.
"""

import dataclasses

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
from torchrec_tpu.parallel import train_pipeline as jtp
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.robustness.policy import GuardrailsConfig as JGuard
from torchrec_tpu.utils.profiling import KernelStats as JKernelStats
from torchrec_tpu_torch.convert import train_state_from_jax, train_state_to_jax
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel import train_pipeline as tp
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.robustness import GuardrailsConfig
from torchrec_tpu_torch.utils.profiling import EventLog, KernelStats, annotate

KEYS = [f"f{i}" for i in range(4)]
ROWS, D, B, DENSE_IN, MAX_IDS = 1000, 16, 64, 13, 8
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
LR = 0.05
DATA = dict(num_dense=DENSE_IN, manual_seed=0, zipf_lengths=1.2,
            zipf_ids=1.0)
# one rung above every key's occupancy in the first batches: one
# signature, so one compile per JAX program kind
LADDER = dict(floor=150, growth=2.0, max_programs=8)
# (kind value, dedup) per table: two table-wise, two dedup'd row-wise
PLAN = {"t_f0": ("table_wise", False), "t_f1": ("row_wise", True),
        "t_f2": ("table_wise", False), "t_f3": ("row_wise", True)}


def _dataset(cls=RandomRecDataset):
    return cls(KEYS, B, [ROWS] * len(KEYS), [MAX_IDS] * 4, **DATA)


def _port_dmp(caps, guarded=False, factor=1.0, kernel="tbe"):
    tables = tuple(EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=D,
                                      name=f"t_{k}", feature_names=[k])
                   for k in KEYS)
    plan = {n: ParameterSharding(ShardingType(st), ranks=[0], dedup=d,
                                 dedup_factor=factor)
            for n, (st, d) in PLAN.items()}
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), DENSE_IN, DENSE_ARCH, OVER_ARCH),
        tables, plan, B, caps, fused_config=FusedOptimConfig(learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu",
        guardrails=GuardrailsConfig() if guarded else None,
        lookup_kernel=kernel, update_kernel=kernel)


def _jax_dmp(caps, guarded=False, factor=1.0):
    tables = tuple(JCfg(num_embeddings=ROWS, embedding_dim=D, name=f"t_{k}",
                        feature_names=[k], pooling=JPooling.SUM)
                   for k in KEYS)
    return JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=DENSE_ARCH,
            over_arch_layer_sizes=OVER_ARCH),
        tables=tables,
        env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan={n: JPS(JST(st), ranks=[0], dedup=d, dedup_factor=factor)
              for n, (st, d) in PLAN.items()},
        batch_size_per_device=B, feature_caps=caps,
        dense_in_features=DENSE_IN,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR),
        guardrails=JGuard() if guarded else None)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assert_states_equal(a, b):
    for x, y in zip(jax.tree.leaves(train_state_to_jax(a)),
                    jax.tree.leaves(train_state_to_jax(b))):
        np.testing.assert_array_equal(x, y)


# -- the semi-sync pipelines against JAX ------------------------------------


@pytest.mark.parametrize("bucketed", [False, True])
def test_semi_sync_matches_jax(bucketed):
    """Three semi-sync steps from the same carried state over the same
    stream: JAX on its XLA kernels, the port on its plain versions; and
    the port's run against its hand-ordered split steps (bitwise) and
    against the synchronous run (not equal: the staleness is real)."""
    caps = dict(zip(KEYS, _dataset().caps))
    jdmp = _jax_dmp(caps, guarded=True)
    jstate = jdmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate)
    dmp = _port_dmp(caps, guarded=True)
    kernels = {"pooled": "xla", "update": "xla"}
    if bucketed:
        jpipe = jtp.BucketedTrainPipelineSemiSync(
            jdmp, jstate, jdmp.env,
            bucketing=jtp.BucketingConfig(**LADDER, kernels=kernels))
        pipe = tp.BucketedTrainPipelineSemiSync(
            dmp, train_state_from_jax(start, device="cpu"),
            tp.BucketingConfig(**LADDER))
    else:
        jpipe = jtp.TrainPipelineSemiSync(jdmp, jstate, jdmp.env)
        pipe = tp.TrainPipelineSemiSync(
            dmp, train_state_from_jax(start, device="cpu"))
    jit_, it = iter(_dataset(JDataset)), iter(_dataset())
    with trace_kernels(pooled="xla", update="xla"):
        for _ in range(3):
            jm, m = jpipe.progress(jit_), pipe.progress(it)
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
            np.testing.assert_array_equal(m["id_violations"].numpy(),
                                          np.asarray(jm["id_violations"]))
            assert int(m["dedup_overflow"]) == int(jm["dedup_overflow"]) == 0
    got = train_state_to_jax(pipe.state)
    want = jax.tree.map(np.asarray, jpipe.state)
    for g in got["tables"]:
        np.testing.assert_allclose(got["tables"][g], want["tables"][g],
                                   rtol=0, atol=2e-6, err_msg=g)
    prefix = "bucketing" if bucketed else "pipeline"

    def guardrail_scalars(metrics):
        return {k: v for k, v in metrics.items()
                if k.endswith(("overflow", "violations"))
                and not k.endswith("fallback_count")}

    got_s = guardrail_scalars(pipe.scalar_metrics())
    assert got_s == guardrail_scalars(jpipe.scalar_metrics())
    assert f"{prefix}/f0/id_violations" in got_s

    # the hand-ordered split steps: embed i + 1 on the tables before step i
    hand = train_state_from_jax(start, device="cpu")
    batches = [b for _, b in zip(range(3), _dataset())]
    pending = dmp.embed_step(hand["tables"], batches[0])
    for i in range(3):
        nxt = (dmp.embed_step(hand["tables"], batches[i + 1]) if i < 2
               else None)
        hand, _ = dmp.dense_update_step(hand, batches[i], *pending)
        pending = nxt
    _assert_states_equal(hand, pipe.state)
    sync = train_state_from_jax(start, device="cpu")
    for b in batches:
        sync, _ = dmp.train_step(sync, b)
    assert not np.array_equal(train_state_to_jax(sync)["tables"]["tw_d16"],
                              got["tables"]["tw_d16"])


@pytest.mark.parametrize("bucketed", [False, True])
def test_invalidate_prefetch_equals_a_fresh_pipeline(bucketed):
    """After two steps the state is replaced by the clone taken after the
    first; the pending embedding recomputed on it gives what a fresh
    pipeline started from the clone on the same batches gives."""
    batches = [b for _, b in zip(range(6), _dataset())]
    caps = dict(zip(KEYS, _dataset().caps))
    dmp = _port_dmp(caps, kernel="dedup")

    def make(state):
        if bucketed:
            return tp.BucketedTrainPipelineSemiSync(
                dmp, state, tp.BucketingConfig(kernels={"pooled": "dedup",
                                                        "update": "dedup"}))
        return tp.TrainPipelineSemiSync(dmp, state)

    pipe = make(dmp.init(torch.Generator().manual_seed(0)))
    it = iter(batches)
    pipe.progress(it)
    saved = _clone(pipe.state)
    pipe.progress(it)  # batch 2 is now pending on later tables
    pipe.state = _clone(saved)
    pipe.invalidate_prefetch()
    fresh = make(_clone(saved))
    it2 = iter(batches[2:])
    for _ in range(4):  # batches 2 to 5
        m, m2 = pipe.progress(it), fresh.progress(it2)
        assert torch.equal(m["loss"], m2["loss"])
    _assert_states_equal(pipe.state, fresh.state)
    for p, i in ((pipe, it), (fresh, it2)):
        with pytest.raises(StopIteration):
            p.progress(i)


# -- prefetch, staged, eval, warmup -----------------------------------------


def test_prefetch_staged_eval_and_warmup():
    batches = [b for _, b in zip(range(4), _dataset())]
    caps = dict(zip(KEYS, _dataset().caps))
    dmp = _port_dmp(caps)
    # prefetch: each batch's aux reaches the state right before its step
    seen = []

    def preprocess(b):
        return b, int(b.sparse_features.lengths().sum())

    def apply_aux(state, auxes):
        seen.append(auxes)
        return state

    steps = []

    def step(state, b):
        steps.append(int(b.sparse_features.lengths().sum()))
        return dmp.train_step(state, b)

    pipe = tp.PrefetchTrainPipelineSparseDist(
        step, dmp.init(torch.Generator().manual_seed(0)), device="cpu",
        preprocess=preprocess, apply_aux=apply_aux)
    plain = tp.TrainPipelineBase(dmp.train_step,
                                 dmp.init(torch.Generator().manual_seed(0)),
                                 device="cpu")
    it, it2 = iter(batches), iter(batches)
    for _ in range(4):
        assert torch.equal(pipe.progress(it)["loss"],
                           plain.progress(it2)["loss"])
    assert [a for (a,) in seen] == steps
    _assert_states_equal(pipe.state, plain.state)
    # staged: the JAX pipeline's order and items
    stages = [lambda x: x + 1, lambda x: x * 2, lambda x: x - 3]
    for depth in (1, 2):
        got, want = [], []
        for pipe_cls, out in ((tp.StagedTrainPipeline, got),
                              (jtp.StagedTrainPipeline, want)):
            p, src = pipe_cls(stages, depth), iter(range(7))
            while True:
                try:
                    out.append(p.progress(src))
                except StopIteration:
                    break
        assert got == want == [2 * (x + 1) - 3 for x in range(7)]
    # eval: make_forward's logits, the state untouched
    state = plain.state
    before = _clone(state)
    fwd = dmp.make_forward()
    ev = tp.EvalPipelineSparseDist(
        lambda s, b: fwd(s["dense"], s["tables"], b), state, device="cpu")
    it = iter(batches)
    for b in batches:
        assert torch.equal(ev.progress(it),
                           fwd(state["dense"], state["tables"], b))
    _assert_states_equal(ev.state, before)
    # warmup: each profile's clone built, no step run
    bp = tp.BucketedTrainPipeline(dmp, state, tp.BucketingConfig())
    bp.warmup(batches[0], [{k: 10 for k in KEYS}, [100, 3, 40, 9]])
    assert bp.stats.program_count == bp.cache.program_count == 2
    _assert_states_equal(bp.state, before)
    sig = bp.cache.resolve(KEYS, bp.cache.signature(KEYS, [100, 3, 40, 9]))
    assert bp.cache.train_program(sig).__self__.feature_caps == dict(
        zip(KEYS, sig))
    assert bp.stats.program_count == 2


# -- the overflow guard -----------------------------------------------------


def test_overflow_guard_decisions_match_jax():
    """A dedup'd plan at ``dedup_factor`` 8 through both packages'
    ``_bucketize_locals``: the same signatures, the same downgrades to
    full capacity, at least one; at factor 1 none."""
    for factor in (8.0, 1.0):
        caps = dict(zip(KEYS, _dataset().caps))
        cache = tp.BucketedStepCache(_port_dmp(caps, factor=factor),
                                     tp.BucketingConfig())
        jcache = jtp.BucketedStepCache(_jax_dmp(caps, factor=factor),
                                       jtp.BucketingConfig())
        sigs, jsigs = [], []
        for b, jb in zip(_dataset(), _dataset(JDataset)):
            sigs.append(tp._bucketize_locals(cache, [b])[1])
            jsigs.append(jtp._bucketize_locals(jcache, [jb])[1])
            if len(sigs) == 12:
                break
        assert sigs == jsigs
        n = cache.stats.overflow_fallback_count
        assert n == jcache.stats.overflow_fallback_count
        assert (n > 0) == (factor > 1)
        assert cache.stats.scalar_metrics()[
            "bucketing/overflow_fallback_count"] == n


# -- metrics, counters, tracing ---------------------------------------------


def test_scalar_metrics_and_kernel_stats_match_jax(tmp_path):
    caps = dict(zip(KEYS, _dataset().caps))
    jdmp = _jax_dmp(caps, guarded=True)
    jstate = jdmp.init(jax.random.key(0))
    dmp = _port_dmp(caps, guarded=True)
    start = jax.tree.map(np.asarray, jstate)
    with trace_kernels(pooled="xla", update="xla"):
        jpipe = jtp.TrainPipelineSparseDist(
            jdmp.make_train_step(donate=False), jstate, jdmp.env)
    pipe = tp.TrainPipelineSparseDist(
        dmp.train_step, train_state_from_jax(start, device="cpu"),
        device="cpu")
    info = dmp.sharded_ebc.feature_table_info()
    assert info == jdmp.sharded_ebc.feature_table_info()
    ks, jks = KernelStats(), JKernelStats()
    pipe.attach_kernel_stats(ks, info)
    jpipe.attach_kernel_stats(jks, info)
    touched, jtouched = [], []

    class Tracker:
        def __init__(self, out):
            self.out = out

        def record(self, table, ids):
            self.out.append((table, np.asarray(ids).tolist()))

    pipe.attach_touched_rows(Tracker(touched))
    jpipe.attach_touched_rows(Tracker(jtouched))
    batches = [b for _, b in zip(range(3), _dataset())]
    # a corrupt id on key f2 of the last batch
    kjt = batches[2].sparse_features
    values = kjt.values().clone()
    values[kjt.cap_offsets()[2]] = ROWS + 1
    batches[2] = dataclasses.replace(batches[2],
                                     sparse_features=kjt.with_values(values))
    jbatches = [b for _, b in zip(range(3), _dataset(JDataset))]
    jk = jbatches[2].sparse_features
    jbatches[2] = dataclasses.replace(
        jbatches[2], sparse_features=jk.with_values(
            jk.values().at[jk.cap_offsets()[2]].set(ROWS + 1)))
    it, jit_ = iter(batches), iter(jbatches)
    with trace_kernels(pooled="xla", update="xla"):
        for _ in range(3):
            pipe.progress(it)
            jpipe.progress(jit_)
    assert pipe.scalar_metrics() == jpipe.scalar_metrics()
    assert pipe.scalar_metrics()["pipeline/f2/id_violations"] == 1.0
    assert ks.scalar_metrics() == jks.scalar_metrics()
    assert touched == jtouched and len(touched) == 3 * len(KEYS)
    # the event log and the profiler phase
    log = EventLog(str(tmp_path / "events.jsonl"))
    log.emit("step", n=1)
    log.close()
    log.emit("step", n=2)  # reopens, appends
    assert [r["n"] for r in log.read()] == [1, 2]
    with torch.profiler.profile() as prof:
        with annotate("sparse_forward"):
            torch.ones(2).sum()
    assert any(e.key == "sparse_forward" for e in prof.key_averages())


def test_bucketed_semi_sync_refuses_an_aux():
    """A queue entry's aux (the tiered cache's fills) would land after the
    step ahead embedded the batch on the tables before them: the bucketed
    semi-sync pipeline raises on one instead of applying it late."""

    class WithAux(tp.BucketedTrainPipelineSemiSync):
        def _preprocess_locals(self, locals_):
            return locals_, "aux"

    caps = dict(zip(KEYS, _dataset().caps))
    dmp = _port_dmp(caps, kernel="dedup")
    pipe = WithAux(dmp, dmp.init(torch.Generator().manual_seed(0)),
                   tp.BucketingConfig(kernels={"pooled": "dedup",
                                               "update": "dedup"}))
    with pytest.raises(TypeError, match="no aux"):
        pipe.progress(iter([b for _, b in zip(range(3), _dataset())]))
