"""The port's fault-tolerant train loop (``reliability/train_loop.py``)
through the deterministic injectors (``reliability/fault_injection.py``):
the loop cases of ``tests/test_fault_tolerance.py`` in the port, the
undo log of the in-place step, and the port's loop against the JAX
package's on one fault schedule.

* A skipped step leaves every table row, optimizer slot, dense tensor
  and the step counter ``torch.equal`` to what they were before it.
* The JAX and port loops run the same schedule (a NaN step, two
  transient read errors, three bad steps in a row, a SIGTERM) over the
  same batches from the same start state: the same counters (applied,
  skipped, data-fault, rollbacks, retries), the same committed steps,
  and final tables within ``tests/test_torch_dlrm_train.py``'s tolerances
  (tables ``atol = 2e-6``, momentum ``rtol = 1e-5``).
"""

import os
import signal

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
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.train_pipeline import (
    TrainPipelineBase as JPipeline,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.reliability import FaultTolerantTrainLoop as JLoop
from torchrec_tpu.reliability import Preempted as JPreempted
from torchrec_tpu.reliability.fault_injection import (
    FlakyIterator as JFlaky,
)
from torchrec_tpu.reliability.fault_injection import (
    NaNInjectingStep as JNaN,
)
from torchrec_tpu_torch.checkpoint import Checkpointer
from torchrec_tpu_torch.convert import train_state_from_jax
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.train_pipeline import (
    TrainPipelineBase,
    TrainPipelineSemiSync,
)
from torchrec_tpu_torch.parallel.types import table_wise_plan
from torchrec_tpu_torch.reliability import (
    FaultTolerantTrainLoop,
    Preempted,
    RetryingIterator,
)
from torchrec_tpu_torch.reliability.fault_injection import (
    CorruptingIterator,
    FlakyIterator,
    NaNInjectingStep,
)
from torchrec_tpu_torch.reliability.train_loop import StepUndoLog
from torchrec_tpu_torch.robustness import (
    GuardrailPolicy,
    GuardrailsConfig,
    InputGuardrailError,
    InputGuardrails,
)

KEYS, ROWS, D, B, IDS, LR = ["a", "b"], [200, 100], 8, 4, [2, 1], 0.05
TABLE_ATOL, SLOT_RTOL = 2e-6, 1e-5


def _dmp():
    tables = tuple(EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                      name=f"t{k}", feature_names=[k])
                   for k, r in zip(KEYS, ROWS))
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), 4, (8, D), (8, 1)), tables,
        table_wise_plan(tables), B, dict(zip(KEYS, [B * 2, B])),
        fused_config=FusedOptimConfig(learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu")


@pytest.fixture(scope="module")
def ft():
    it = iter(RandomRecDataset(KEYS, B, ROWS, IDS, num_dense=4,
                               manual_seed=3))
    return _dmp(), [next(it) for _ in range(12)]


def _init(dmp, seed):
    return dmp.init(torch.Generator().manual_seed(seed))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _drain(loop, it):
    losses = []
    while True:
        try:
            losses.append(float(loop.progress(it)["loss"]))
        except StopIteration:
            return losses


def test_skipped_step_leaves_state_equal(ft, tmp_path):
    """Every table row, optimizer slot, dense tensor and the step counter
    after a skipped (NaN) step are ``torch.equal`` to before it; the undo
    log copied the step's rows (not the tables)."""
    dmp, batches = ft
    bad = NaNInjectingStep(dmp.train_step, inject_on={1})
    pipe = TrainPipelineBase(bad, _init(dmp, 4), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=None,
                                  max_consecutive_bad_steps=10)
    it = iter(batches[:3])
    loop.progress(it)
    before = _clone(pipe.state)
    m = loop.progress(it)
    assert loop.last_step_skipped and not np.isfinite(float(m["loss"]))
    assert _equal(pipe.state, before)
    table_bytes = sum(t.numel() * 4 for t in before["tables"].values())
    assert 0 < loop.last_undo_bytes < table_bytes
    loop.progress(it)
    assert loop.applied_steps == 2 and pipe.state["step"] == 2


def test_undo_log_restores_rows_written_by_an_update(ft):
    dmp, batches = ft
    state = _init(dmp, 5)
    before = _clone(state)
    undo = StepUndoLog(state)
    with undo.recording():
        dmp.train_step(state, batches[0])
    assert not _equal(state, before)
    undo.restore()
    assert _equal(state, before)


def test_nan_step_skipped_and_converges_like_surviving_batches(ft, tmp_path):
    dmp, batches = ft
    batches = batches[:6]
    ref = _init(dmp, 4)
    for i, b in enumerate(batches):
        if i != 2:
            ref, _ = dmp.train_step(ref, b)
    bad = NaNInjectingStep(dmp.train_step, inject_on={2})
    pipe = TrainPipelineBase(bad, _init(dmp, 4), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=None,
                                  max_consecutive_bad_steps=10)
    losses = _drain(loop, iter(batches))
    assert bad.injected == 1
    assert loop.skipped_steps == 1 and loop.applied_steps == 5
    assert sum(1 for x in losses if not np.isfinite(x)) == 1
    assert pipe.state["step"] == ref["step"] == 5
    assert _equal(pipe.state, ref)


def test_k_consecutive_bad_steps_roll_back_to_checkpoint(ft, tmp_path):
    dmp, batches = ft
    batches = batches[:6]
    ref = _init(dmp, 5)
    for i in (0, 4, 5):
        ref, _ = dmp.train_step(ref, batches[i])
    bad = NaNInjectingStep(dmp.train_step, inject_on={1, 2, 3})
    pipe = TrainPipelineBase(bad, _init(dmp, 5), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=1,
                                  max_consecutive_bad_steps=3)
    _drain(loop, iter(batches))
    assert loop.skipped_steps == 3 and loop.rollbacks == 1
    assert loop.applied_steps == 3 and pipe.state["step"] == 3
    assert _equal(pipe.state, ref)
    m = loop.scalar_metrics()
    assert m["reliability/rollbacks"] == 1.0
    assert m["reliability/skipped_steps"] == 3.0
    assert m["reliability/applied_steps"] == 3.0
    assert m["reliability/checkpoint_restore_count"] == 1.0
    assert m["reliability/checkpoint_save_count"] >= 1.0
    assert m["reliability/checkpoint_save_seconds"] > 0.0
    reg = MetricsRegistry()
    reg.absorb(m)
    assert reg.value("reliability/rollbacks") == 1.0


def test_rollback_invalidates_semi_sync_prefetch(ft, tmp_path):
    """A rollback replaces the state: the semi-sync pipeline's pending
    embedding is recomputed, and the steps after it equal a fresh
    pipeline's from the restored checkpoint over the same batches."""
    dmp, batches = ft
    batches = batches[:8]
    ck = Checkpointer(str(tmp_path / "ck"))
    pipe = TrainPipelineSemiSync(dmp, _init(dmp, 13))
    refreshed = []
    orig = pipe.invalidate_prefetch
    pipe.invalidate_prefetch = lambda: (refreshed.append(1), orig())[0]
    calls = [0]

    def bad_on_1_and_2(metrics):
        calls[0] += 1
        return calls[0] - 1 in (1, 2)

    loop = FaultTolerantTrainLoop(pipe, ck, dmp, checkpoint_interval=1,
                                  max_consecutive_bad_steps=2,
                                  is_bad_fn=bad_on_1_and_2)
    it = iter(batches)
    losses = [float(loop.progress(it)["loss"]) for _ in range(3)]
    assert loop.rollbacks == 1 and refreshed
    assert np.isfinite(losses).all()
    assert pipe.state["step"] == 1  # call 0 applied, calls 1-2 reverted
    # the pending batch is the 4th; a fresh pipeline from the restored
    # step over batches 4.. gives the same states
    pending = next(i for i, b in enumerate(batches) if torch.equal(
        b.dense_features, pipe._pending[0].dense_features))
    fresh = TrainPipelineSemiSync(dmp, ck.restore(dmp, ck.latest_step()))
    fit = iter(batches[pending:])
    assert _equal(fresh.state, pipe.state)
    for _ in range(2):
        loop.progress(it)
        fresh.progress(fit)
        assert _equal(fresh.state, pipe.state)


def test_no_rollback_target_fails_loud(ft, tmp_path):
    dmp, batches = ft
    bad = NaNInjectingStep(dmp.train_step, inject_on={0})
    pipe = TrainPipelineBase(bad, _init(dmp, 6), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=None,
                                  max_consecutive_bad_steps=1,
                                  checkpoint_on_start=False)
    with pytest.raises(RuntimeError, match="no committed checkpoint"):
        loop.progress(iter(batches[:1]))


def test_transient_iterator_errors_retry_and_match_clean_run(ft, tmp_path):
    dmp, batches = ft
    batches = batches[:4]

    def run(source, name):
        pipe = TrainPipelineBase(dmp.train_step, _init(dmp, 7), "cpu")
        loop = FaultTolerantTrainLoop(
            pipe, Checkpointer(str(tmp_path / name)), dmp,
            checkpoint_interval=None, data_retries=3, data_backoff_s=0.001)
        return _drain(loop, iter(source)), loop

    clean, _ = run(list(batches), "clean")
    flaky = FlakyIterator(list(batches), fail_on={0, 2, 3, 6})
    got, loop = run(flaky, "flaky")
    assert flaky.failures == 4
    assert loop.scalar_metrics()["reliability/data_retries"] == 4.0
    assert got == clean
    wrapped = RetryingIterator(FlakyIterator(iter(batches), p=1.0, seed=0),
                               retries=2, backoff_s=0.001)
    with pytest.raises(IOError, match="injected transient"):
        next(wrapped)


def test_sigterm_writes_final_checkpoint_and_exits_cleanly(ft, tmp_path):
    dmp, batches = ft
    batches = batches[:6]
    pipe = TrainPipelineBase(dmp.train_step, _init(dmp, 8), "cpu")
    ck = Checkpointer(str(tmp_path / "ck"))
    loop = FaultTolerantTrainLoop(pipe, ck, dmp, checkpoint_interval=None)
    before = signal.getsignal(signal.SIGTERM)
    loop.install_signal_handlers()
    loop.install_signal_handlers()  # idempotent
    it = iter(batches)
    loop.progress(it)
    loop.progress(it)
    os.kill(os.getpid(), signal.SIGTERM)
    with pytest.raises(Preempted, match="final checkpoint committed"):
        loop.progress(it)
    assert ck.latest_step() == pipe.state["step"] == 2
    assert _equal(ck.restore(dmp, 2), pipe.state)
    assert signal.getsignal(signal.SIGTERM) is before
    pipe2 = TrainPipelineBase(dmp.train_step, _init(dmp, 8), "cpu")
    loop2 = FaultTolerantTrainLoop(pipe2, Checkpointer(str(tmp_path / "ck2")),
                                   dmp, checkpoint_interval=None)
    loop2.install_signal_handlers()
    os.kill(os.getpid(), signal.SIGINT)
    summary = loop2.run(iter(batches))
    assert summary["preempted"] is True
    assert summary["final_step"] is not None


def test_auto_resume_round_trip_through_run(ft, tmp_path):
    dmp, batches = ft
    batches = batches[:6]
    ref = _init(dmp, 10)
    for b in batches:
        ref, _ = dmp.train_step(ref, b)
    pipe1 = TrainPipelineBase(dmp.train_step, _init(dmp, 10), "cpu")
    loop1 = FaultTolerantTrainLoop(pipe1, Checkpointer(str(tmp_path / "ck")),
                                   dmp, checkpoint_interval=1)
    it = iter(batches)
    for _ in range(3):
        loop1.progress(it)
    assert loop1.checkpointer.latest_step() == 3
    pipe2 = TrainPipelineBase(dmp.train_step, _init(dmp, 99), "cpu")
    loop2 = FaultTolerantTrainLoop(pipe2, Checkpointer(str(tmp_path / "ck")),
                                   dmp, checkpoint_interval=None)
    assert loop2.resumed_from == 3
    summary = loop2.run(iter(batches[3:]))
    assert summary["applied_steps"] == 3 and not summary["preempted"]
    assert pipe2.state["step"] == 6 and summary["final_step"] == 6
    assert _equal(pipe2.state, ref)


def test_quarantine_skips_corrupt_batches_and_training_resumes(ft, tmp_path):
    dmp, batches = ft
    batches = batches[:6]
    corrupt_on = {1: "oob_ids", 3: "nan_dense"}
    ref = _init(dmp, 20)
    for i, b in enumerate(batches):
        if i not in corrupt_on:
            ref, _ = dmp.train_step(ref, b)
    guardrails = InputGuardrails(
        GuardrailsConfig(policy=GuardrailPolicy.QUARANTINE,
                         quarantine_dir=str(tmp_path / "quarantine")),
        dict(zip(KEYS, ROWS)))
    pipe = TrainPipelineBase(dmp.train_step, _init(dmp, 20), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=None,
                                  guardrails=guardrails)
    summary = loop.run(CorruptingIterator(iter(batches), corrupt_on))
    assert summary["applied_steps"] == 4
    assert summary["quarantined_batches"] == 2
    assert summary["skipped_steps"] == 0
    store = guardrails.quarantine
    kinds = sorted(store.load(n)[1]["diagnosis"]["kind"]
                   for n in store.entries())
    assert kinds == ["nonfinite_dense", "oob_ids"]
    assert _equal(pipe.state, ref)


def test_strict_policy_raises_through_the_loop(ft, tmp_path):
    dmp, batches = ft
    guardrails = InputGuardrails(
        GuardrailsConfig(policy=GuardrailPolicy.STRICT),
        dict(zip(KEYS, ROWS)))
    pipe = TrainPipelineBase(dmp.train_step, _init(dmp, 21), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=None,
                                  guardrails=guardrails)
    with pytest.raises(InputGuardrailError, match="key a"):
        loop.progress(CorruptingIterator(iter(batches[:1]),
                                         {0: "oob_ids"}))


def test_loop_telemetry_periodic_jsonl_dumps(ft, tmp_path):
    import json

    dmp, batches = ft
    pipe = TrainPipelineBase(dmp.train_step, _init(dmp, 11), "cpu")
    loop = FaultTolerantTrainLoop(pipe, Checkpointer(str(tmp_path / "ck")),
                                  dmp, checkpoint_interval=None)
    registry = MetricsRegistry()
    path = str(tmp_path / "metrics.jsonl")
    loop.attach_telemetry(registry, dump_path=path, interval=2)
    summary = loop.run(iter(batches[:6]))
    assert summary["applied_steps"] == 6
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in rows if "metrics" in r]
    assert [r["step"] for r in rows] == [2, 4, 6, 6]
    assert rows[-1]["metrics"]["reliability/applied_steps"] == 6.0
    assert registry.value("reliability/applied_steps") == 6.0


# -- the JAX and port loops on one fault schedule ---------------------------

NAN_CALLS, FLAKY_CALLS, CALLS_BEFORE_SIGTERM = {1, 4, 5, 6}, {2, 7}, 9


def _schedule(loop, source):
    """Nine progress calls over ``source``, then a SIGTERM and the call
    that raises ``Preempted`` (of the loop's own package)."""
    loop.install_signal_handlers()
    it = iter(source)
    for _ in range(CALLS_BEFORE_SIGTERM):
        loop.progress(it)
    os.kill(os.getpid(), signal.SIGTERM)
    try:
        loop.progress(it)
    except (Preempted, JPreempted):
        return True
    return False


def test_port_and_jax_loops_agree_on_a_fault_schedule(ft, tmp_path):
    dmp, _ = ft
    tables = tuple(JCfg(num_embeddings=r, embedding_dim=D, name=f"t{k}",
                        feature_names=[k], pooling=JPooling.SUM)
                   for k, r in zip(KEYS, ROWS))
    jds = JDataset(KEYS, B, ROWS, IDS, num_dense=4, manual_seed=3)
    jdmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=4, dense_arch_layer_sizes=(8, D),
            over_arch_layer_sizes=(8, 1)),
        tables=tables, env=JEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan={t.name: JPS(JST.TABLE_WISE, ranks=[0]) for t in tables},
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, [B * 2, B])),
        dense_in_features=4,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))
    jstate = jdmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate)
    jit = iter(jds)
    jbatches = [next(jit) for _ in range(12)]
    knobs = dict(checkpoint_interval=4, max_consecutive_bad_steps=3,
                 data_retries=3, data_backoff_s=0.001)
    with trace_kernels(pooled="xla", update="xla"):
        jpipe = JPipeline(JNaN(jdmp.make_train_step(donate=False),
                               NAN_CALLS), jstate, jdmp.env)
        jck = JCheckpointer(str(tmp_path / "jax"))
        jloop = JLoop(jpipe, jck, jdmp, **knobs)
        assert _schedule(jloop, JFlaky(jbatches, fail_on=FLAKY_CALLS))
    it = iter(RandomRecDataset(KEYS, B, ROWS, IDS, num_dense=4,
                               manual_seed=3))
    pbatches = [next(it) for _ in range(12)]
    pipe = TrainPipelineBase(NaNInjectingStep(dmp.train_step, NAN_CALLS),
                             train_state_from_jax(start, device="cpu"), "cpu")
    ck = Checkpointer(str(tmp_path / "port"))
    loop = FaultTolerantTrainLoop(pipe, ck, dmp, **knobs)
    assert _schedule(loop, FlakyIterator(pbatches, fail_on=FLAKY_CALLS))
    for name in ("applied_steps", "skipped_steps", "rollbacks",
                 "data_fault_steps", "data_retries",
                 "checkpoint_restore_count"):
        key = f"reliability/{name}"
        assert loop.scalar_metrics()[key] == jloop.scalar_metrics()[key], key
    assert (loop.applied_steps, loop.skipped_steps, loop.rollbacks) == (
        5, 4, 1)
    # the start's step 0 (the rollback target), step 1 at the fourth
    # applied step, step 2 at the SIGTERM
    assert ck.steps() == jck.steps() == [0, 1, 2]
    got, want = ck._read_payload(2), jck._read_payload(2)
    for t, w in want["tables"].items():
        np.testing.assert_allclose(got["tables"][t].numpy(), w, rtol=0,
                                   atol=TABLE_ATOL, err_msg=t)
        np.testing.assert_allclose(
            got["fused_tables"][t]["momentum"].numpy(),
            want["fused_tables"][t]["momentum"], rtol=SLOT_RTOL, atol=0)
