"""The fault-tolerant training loop (``torchrec_tpu/reliability/
train_loop.py``).

``FaultTolerantTrainLoop`` wraps any pipeline with ``state`` and
``progress(iterator)`` (``parallel/train_pipeline.py``) and adds:

* **the bad-step guard**: a non-finite loss or metric discards the
  step's update, consecutive strikes are counted, and after
  ``max_consecutive_bad_steps`` the state rolls back to the last
  *committed* checkpoint;
* **transient data retry**: the source iterator is wrapped in
  ``RetryingIterator``, so transient ``IOError``-class failures back off
  and retry a bounded number of times before they raise;
* **preemption**: SIGTERM/SIGINT set a flag; the next ``progress`` drains
  the device, writes a final checkpoint, restores the previous signal
  handlers and raises ``Preempted`` (``run()`` catches it);
* **auto-resume**: on construction the pipeline's state is replaced by
  the restore of ``checkpointer.latest_step()`` when a committed
  checkpoint exists.

The port's train step updates the state in place: the tables' rows, the
fused optimizer's slots, the dense parameters and their optimizer state,
and ``state["step"]`` (the JAX step returns new arrays, and the JAX loop
keeps the old state to re-install it).  A step is therefore undone with
an undo log, :class:`StepUndoLog`: before the step it copies the dense
parameters, their optimizer state and the step counter, and before each
fused update (``ops.fused_update.recording_row_writes``) the rows the
update may write, with their optimizer slots (every row of a
data-parallel group, whose update steps every row); a bad step writes
them all back, leaving the state ``torch.equal`` to what it was.  The
copies are gathers on the device and need no host sync; their bytes a
step are ``StepUndoLog.nbytes``.

The undo log is also a tiered pipeline's revert (``tiered/pipeline.py``):
the log recorded the step's rows after the step's cache fills landed, so
its restore keeps the fills and the host maps' claims consistent (the
JAX loop re-applies the fills after putting the old state back).
Every interval, final and preemption checkpoint first runs
:meth:`FaultTolerantTrainLoop._quiesce`, which drains a
pipeline's queued lookahead (``drain()``, where the pipeline has one):
a tiered pipeline's host maps run ahead of the device while remapped
batches are queued, and its collection refuses such a save.

The guard reads the metrics on the host, which waits for each step's
results.  Under a process group the ranks agree on the verdict (a MAX
over ranks of the bad flag), so that no rank skips a step its peers
apply.
"""

from __future__ import annotations

import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Type

import torch
import torch.distributed as dist

from torchrec_tpu_torch.checkpoint import Checkpointer
from torchrec_tpu_torch.obs import flight_recorder as _flight
from torchrec_tpu_torch.obs.spans import span as obs_span
from torchrec_tpu_torch.ops.fused_update import recording_row_writes
from torchrec_tpu_torch.robustness.policy import (
    GuardedIterator,
    InputGuardrails,
)


class Preempted(RuntimeError):
    """Raised by ``progress`` after a signal-triggered final checkpoint;
    catching it (or using ``run()``) is the clean-exit path."""


class RetryingIterator:
    """Bounded retry with backoff around a flaky iterator: a ``next()``
    failure of a ``transient`` class is retried up to ``retries`` times
    after ``backoff_s * 2**attempt``; a call still failing raises its
    last error.  ``StopIteration`` passes at once."""

    def __init__(
        self,
        it: Iterator[Any],
        retries: int = 3,
        backoff_s: float = 0.02,
        transient: Tuple[Type[BaseException], ...] = (IOError,),
    ):
        self._it = iter(it)
        self._retries = retries
        self._backoff_s = backoff_s
        self._transient = transient
        self.retried = 0  # transient failures absorbed

    def __iter__(self) -> "RetryingIterator":
        return self

    def __next__(self) -> Any:
        for attempt in range(self._retries + 1):
            try:
                return next(self._it)
            except StopIteration:
                raise
            except self._transient:
                if attempt >= self._retries:
                    raise
                self.retried += 1
                time.sleep(self._backoff_s * (2 ** attempt))
        raise AssertionError("unreachable")


def _float_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree
    elif isinstance(tree, float):
        yield torch.tensor(tree)


def _has_non_finite(metrics: Any) -> bool:
    """True if any float leaf of the metrics holds a NaN or an Inf: one
    host read of the step's outputs.  Under a process group the verdict
    is the MAX over ranks (a collective), so every rank reaches the same
    one."""
    leaves = list(_float_leaves(metrics))
    bad = torch.zeros((), dtype=torch.float32,
                      device=leaves[0].device if leaves else "cpu")
    for t in leaves:
        bad = torch.maximum(bad, (~torch.isfinite(t)).any().to(bad.device,
                                                               bad.dtype))
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl" and bad.device.type != "cuda":
            bad = bad.cuda()
        flag = bad.reshape(1).clone()
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        bad = flag[0]
    return bool(bad.item())


def _copy_tree(tree: Any) -> Any:
    """The tensors of a nested dict cloned, numbers as they are."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _restore_tree(live: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """Write ``saved`` back into ``live``, tensors in place."""
    for k, v in saved.items():
        if isinstance(v, dict):
            _restore_tree(live[k], v)
        elif isinstance(v, torch.Tensor):
            live[k].copy_(v)
        else:
            live[k] = v


def _nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


class StepUndoLog:
    """What one in-place train step writes, kept so that it can be written
    back (module docstring).  Open it on the state before the step
    (``StepUndoLog(state)``), run the step under ``recording()``, and
    ``restore()`` puts every table row, optimizer slot, dense tensor and
    the step counter back as they were.  ``nbytes`` is what it copied."""

    def __init__(self, state: Dict[str, Any]):
        self.state = state
        self._dense = _copy_tree({k: state[k] for k in ("dense", "dense_opt")})
        self._step = state["step"]
        # (table, optimizer state, row index, old rows, old slots, old
        # scalars), in update order
        self._rows: List[Tuple] = []
        self.nbytes = _nbytes(self._dense)

    def recording(self):
        """The context in which the step's fused updates are logged."""
        return recording_row_writes(self)

    def before_update(self, table: torch.Tensor, state: Dict[str, Any],
                      ids: torch.Tensor, valid: torch.Tensor) -> None:
        """Keep the rows a fused update may write (``ids`` where
        ``valid``; the others point at row 0, whose own old value then
        goes back, too) with their slots: no unique, so no host sync."""
        R = table.shape[0]
        ok = valid & (ids >= 0) & (ids < R)
        rows = torch.where(ok, ids, torch.zeros_like(ids)).to(torch.int64)
        old_rows = table.index_select(0, rows)
        slots = {k: v.index_select(0, rows) for k, v in state.items()
                 if isinstance(v, torch.Tensor) and v.dim()
                 and v.shape[0] == R}
        scalars = {k: v for k, v in state.items()
                   if not isinstance(v, torch.Tensor)}
        self._rows.append((table, state, rows, old_rows, slots, scalars))
        self.nbytes += (rows.numel() * rows.element_size()
                        + _nbytes(old_rows) + _nbytes(slots))

    def restore(self) -> None:
        """Write everything back, the last update first."""
        for table, state, rows, old_rows, slots, scalars in reversed(
                self._rows):
            table.index_copy_(0, rows, old_rows)
            for k, v in slots.items():
                state[k].index_copy_(0, rows, v)
            state.update(scalars)
        _restore_tree(self.state, self._dense)
        self.state["step"] = self._step


class FaultTolerantTrainLoop:
    """Wrap ``pipeline.progress`` with skip, rollback, retry and
    preemption guards and periodic crash-safe checkpoints.

    pipeline: anything with ``state`` and ``progress(iterator)`` whose
        step updates the state in place or replaces it.
    checkpointer / dmp: the save/restore pair; ``dmp`` is the
        ``DistributedModelParallel`` the checkpointer builds states for.
    checkpoint_interval: save every N applied steps (None: only the
        initial, final and preemption checkpoints).
    max_consecutive_bad_steps: strikes before rolling back to the last
        committed checkpoint instead of skipping.
    data_retries / data_backoff_s / transient_errors: the
        ``RetryingIterator`` of the source iterator.
    resume: adopt ``checkpointer.latest_step()`` on construction.
    checkpoint_on_start: write a checkpoint when none exists, so that a
        rollback target always exists.
    is_bad_fn: replaces the non-finite metric predicate.
    guardrails: a ``robustness.InputGuardrails``: the source is
        validated batch by batch (STRICT raise, SANITIZE repair,
        QUARANTINE persist and skip), and a non-finite step the
        guardrails attribute to bad data (the traced ``id_violations``
        above the stream's routine level) is skipped without a rollback
        strike.
    elastic_resume: restore through ``Checkpointer.restore_elastic``, so
        that resume and rollback work after a change of world size.
    """

    def __init__(  # the JAX loop's knobs, one for one
        self,
        pipeline: Any,
        checkpointer: Checkpointer,
        dmp: Any,
        checkpoint_interval: Optional[int] = 50,
        max_consecutive_bad_steps: int = 3,
        data_retries: int = 3,
        data_backoff_s: float = 0.02,
        transient_errors: Tuple[Type[BaseException], ...] = (IOError,),
        resume: bool = True,
        checkpoint_on_start: bool = True,
        is_bad_fn: Optional[Callable[[Any], bool]] = None,
        guardrails: Optional[InputGuardrails] = None,
        elastic_resume: bool = False,
    ):
        self.pipeline = pipeline
        self.checkpointer = checkpointer
        self.dmp = dmp
        self.elastic_resume = elastic_resume
        self.checkpoint_interval = checkpoint_interval
        self.max_consecutive_bad_steps = max_consecutive_bad_steps
        self._data_retries = data_retries
        self._data_backoff_s = data_backoff_s
        self._transient = transient_errors
        self._is_bad = is_bad_fn or _has_non_finite
        self.guardrails = guardrails

        self._strikes = 0
        self._wrapped: Optional[Tuple[Any, Any]] = None
        self._preempt_signal: Optional[int] = None
        self._old_handlers: Dict[int, Any] = {}
        # duck-typed hooks: telemetry (registry, dump path, interval), a
        # drift monitor, a plan migrator and a delta publisher
        self._obs: Optional[Tuple[Any, Optional[str], int]] = None
        self._health: Optional[Any] = None
        self._migrator: Optional[Any] = None
        self._delta: Optional[Tuple[Any, Any, Any]] = None
        self.delta_publish_count = 0
        self.delta_rows_published = 0

        self.applied_steps = 0  # successful steps this process
        self.skipped_steps = 0
        self.rollbacks = 0
        self.data_fault_steps = 0  # bad steps attributed to data
        self.last_step_skipped = False
        self.resumed_from: Optional[int] = None
        self.checkpoint_save_count = 0
        self.checkpoint_save_seconds = 0.0
        self.checkpoint_restore_count = 0
        self.checkpoint_restore_seconds = 0.0
        # the bytes the last step's undo log copied
        self.last_undo_bytes = 0
        # id_violations of recent finite steps: the stream's routine
        # level; a non-finite step counts as the data's fault only above
        # it
        self._routine_violations: deque = deque(maxlen=16)

        if resume:
            latest = checkpointer.latest_step()
            if latest is not None:
                self._checkpoint_restore(latest)
                self.resumed_from = latest
        if checkpoint_on_start and checkpointer.latest_step() is None:
            self._checkpoint_save()
            checkpointer.wait()

    # -- signals / preemption ----------------------------------------------

    def install_signal_handlers(
        self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
    ) -> None:
        """Route SIGTERM/SIGINT into graceful preemption (main thread
        only).  Idempotent."""
        for sig in signals:
            if sig not in self._old_handlers:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)

    def uninstall_signal_handlers(self) -> None:
        """Restore the handlers ``install_signal_handlers`` replaced;
        idempotent."""
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        # async-signal-safe: only record; the loop acts at the next step
        self._preempt_signal = signum

    def _handle_preemption(self) -> None:
        sig = self._preempt_signal
        self.checkpointer.wait()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the dispatched step's device work
        if self._quiesce():
            self._checkpoint_save()
        self.checkpointer.wait()
        self.uninstall_signal_handlers()
        self._preempt_signal = None
        recorder = _flight.current_recorder()
        if recorder is not None:
            recorder.note("preempted", signum=sig)
            recorder.dump("sigterm")
        raise Preempted(f"signal {sig}: final checkpoint committed at step "
                        f"{self.checkpointer.latest_step()}")

    # -- telemetry and the duck-typed hooks --------------------------------

    def attach_telemetry(self, registry: Any, dump_path: Optional[str] = None,
                         interval: int = 50) -> None:
        """Every ``interval`` applied steps (and once more when ``run()``
        exits) absorb the loop's counters and the pipeline's
        ``scalar_metrics()`` into ``registry`` (an ``obs.MetricsRegistry``)
        and, with ``dump_path``, append one JSONL row
        (``registry.dump_jsonl``)."""
        self._obs = (registry, dump_path, max(1, int(interval)))

    def attach_health(self, monitor: Any) -> None:
        """A drift monitor (anything with ``observe(step=)`` and
        ``assumptions.fingerprint()``), ticked at the telemetry cadence;
        the dump rows then carry ``plan_assumptions``."""
        self._health = monitor
        self._health_fp = monitor.assumptions.fingerprint()

    def attach_migrator(self, migrator: Any) -> None:
        """A plan migrator (anything with ``maybe_migrate(loop)``), given
        one chance at each applied step's boundary, after the telemetry."""
        self._migrator = migrator

    def attach_delta_publisher(self, publisher: Any, tracker: Any,
                               vocab: Any = None) -> None:
        """Serving freshness on the checkpoint cadence: after every
        committed checkpoint, ``tracker.drain(dmp, state)`` gives the rows
        touched since the last one and ``publisher.publish(step, deltas,
        vocab_events=...)`` (rank 0) publishes them; ``vocab`` (anything
        with ``drain_events()``) adds its events."""
        self._delta = (publisher, tracker, vocab)

    def _publish_deltas(self) -> None:
        if self._delta is None:
            return
        publisher, tracker, vocab = self._delta
        with obs_span("reliability/delta_publish"):
            deltas = tracker.drain(self.dmp, self.pipeline.state)
            vocab_events = vocab.drain_events() if vocab is not None else None
            if not deltas and not vocab_events:
                return
            if not dist.is_initialized() or dist.get_rank() == 0:
                publisher.publish(self.applied_steps, deltas,
                                  vocab_events=vocab_events)
            self.delta_publish_count += 1
            self.delta_rows_published += sum(
                len(ids) for ids, _rows in deltas.values())

    def adopt_runtime(self, dmp: Any, pipeline: Any) -> None:
        """Install a migrated runtime (a new DMP and a pipeline whose state
        was restored under the new plan); prefetched work of the replaced
        pipeline is recomputed."""
        self.dmp = dmp
        self.pipeline = pipeline
        self._invalidate_prefetch()

    def _collect_metrics(self) -> None:
        if self._obs is None:
            return
        registry, dump_path, _ = self._obs
        registry.absorb(self.scalar_metrics())
        scalars = getattr(self.pipeline, "scalar_metrics", None)
        if scalars is not None:
            registry.absorb(scalars())
        extra = None
        if self._health is not None:
            self._health.observe(step=self.applied_steps)
            extra = {"plan_assumptions": self._health_fp}
        recorder = _flight.current_recorder()
        flat = (registry.flat()
                if dump_path is not None or recorder is not None else None)
        if dump_path is not None:
            registry.dump_jsonl(dump_path, step=self.applied_steps,
                                extra=extra, flat=flat)
        if recorder is not None:
            recorder.record_metrics(flat, step=self.applied_steps)

    # -- checkpoint IO -----------------------------------------------------

    def _checkpoint_save(self) -> None:
        with obs_span("reliability/checkpoint_save"):
            t0 = time.perf_counter()
            self.checkpointer.save(self.dmp, self.pipeline.state)
            self.checkpoint_save_seconds += time.perf_counter() - t0
            self.checkpoint_save_count += 1
        # freshness after the save: a generation never runs ahead of a
        # durable checkpoint
        self._publish_deltas()

    def _checkpoint_restore(self, step: int) -> None:
        with obs_span("reliability/checkpoint_restore", step=step):
            t0 = time.perf_counter()
            restore = (self.checkpointer.restore_elastic
                       if self.elastic_resume else self.checkpointer.restore)
            self.pipeline.state = restore(self.dmp, step)
            self.checkpoint_restore_seconds += time.perf_counter() - t0
            self.checkpoint_restore_count += 1
        self._invalidate_prefetch()

    def scalar_metrics(self, prefix: str = "reliability") -> Dict[str, float]:
        """The loop's counters, flat: applied, skipped and data-fault
        steps, live strikes, rollbacks, transient-data retries, checkpoint
        save and restore counts and seconds, the last step's undo-log
        bytes, published deltas."""
        out = {
            f"{prefix}/applied_steps": float(self.applied_steps),
            f"{prefix}/skipped_steps": float(self.skipped_steps),
            f"{prefix}/data_fault_steps": float(self.data_fault_steps),
            f"{prefix}/rollbacks": float(self.rollbacks),
            f"{prefix}/strikes": float(self._strikes),
            f"{prefix}/checkpoint_save_count": float(
                self.checkpoint_save_count),
            f"{prefix}/checkpoint_save_seconds": self.checkpoint_save_seconds,
            f"{prefix}/checkpoint_restore_count": float(
                self.checkpoint_restore_count),
            f"{prefix}/checkpoint_restore_seconds": (
                self.checkpoint_restore_seconds),
            f"{prefix}/last_undo_bytes": float(self.last_undo_bytes),
            f"{prefix}/delta_publish_count": float(self.delta_publish_count),
            f"{prefix}/delta_rows_published": float(
                self.delta_rows_published),
        }
        if self._wrapped is not None:
            retrying = self._wrapped[1]
            while isinstance(retrying, GuardedIterator):
                retrying = retrying._it
            if isinstance(retrying, RetryingIterator):
                out[f"{prefix}/data_retries"] = float(retrying.retried)
        if self.guardrails is not None:
            out.update(self.guardrails.scalar_metrics())
        return out

    # -- stepping ----------------------------------------------------------

    def _wrap(self, it: Iterator[Any]):
        # one wrapper per source iterator, kept so retry bookkeeping
        # survives across progress() calls; guardrails validate OUTSIDE
        # the transient retry (a schema violation is not a transient
        # error and is never retried away)
        if self._wrapped is None or self._wrapped[0] is not it:
            wrapped: Any = RetryingIterator(
                it, retries=self._data_retries,
                backoff_s=self._data_backoff_s, transient=self._transient)
            if self.guardrails is not None:
                wrapped = GuardedIterator(wrapped, self.guardrails)
            self._wrapped = (it, wrapped)
        return self._wrapped[1]

    def _guarded_progress(self, wrapped) -> Tuple[Any, StepUndoLog]:
        """One pipeline step with its undo log open."""
        undo = StepUndoLog(self.pipeline.state)
        with undo.recording():
            metrics = self.pipeline.progress(wrapped)
        self.last_undo_bytes = undo.nbytes
        return metrics, undo

    def progress(self, it: Iterator[Any]):
        """One guarded step: returns the step's metrics (maybe non-finite:
        see ``last_step_skipped``); raises ``Preempted`` after a signal and
        ``StopIteration`` when the source is exhausted."""
        if self._preempt_signal is not None:
            self._handle_preemption()
        wrapped = self._wrap(it)
        metrics, undo = self._guarded_progress(wrapped)
        if self._is_bad(metrics):
            # discard the bad batch's update outright
            undo.restore()
            self.skipped_steps += 1
            self.last_step_skipped = True
            recorder = _flight.current_recorder()
            if self.guardrails is not None and self.guardrails.attribute_bad_step(
                    metrics,
                    baseline=max(self._routine_violations, default=0)):
                # a data fault, not optimizer divergence: skip and log,
                # no strike toward the rollback
                self.data_fault_steps += 1
                if recorder is not None:
                    recorder.note("quarantine",
                                  applied_steps=self.applied_steps,
                                  data_fault_steps=self.data_fault_steps)
                    recorder.dump("quarantine")
            else:
                self._strikes += 1
                if recorder is not None:
                    recorder.note("bad_step",
                                  applied_steps=self.applied_steps,
                                  strikes=self._strikes)
                    recorder.dump("nan_step")
                if self._strikes >= self.max_consecutive_bad_steps:
                    self._rollback()
        else:
            self._strikes = 0
            self.applied_steps += 1
            self.last_step_skipped = False
            if self.guardrails is not None:
                v = self.guardrails.step_violations(metrics)
                if v is not None:
                    self._routine_violations.append(v)
            if self._obs is not None and (
                    self.applied_steps % self._obs[2] == 0):
                self._collect_metrics()
            if (self.checkpoint_interval
                    and self.applied_steps % self.checkpoint_interval == 0):
                if self._quiesce():
                    self._checkpoint_save()
            if self._migrator is not None:
                self._migrator.maybe_migrate(self)
        return metrics

    def _quiesce(self) -> bool:
        """Run the queued lookahead steps out before a checkpoint
        (``pipeline.drain()``, where the pipeline has one: a tiered
        pipeline's host maps run ahead of the device while batches are
        queued).  False when a drained step went bad: its update is
        applied and cannot be undone alone, so the caller skips this save
        (the last committed checkpoint stays the rollback target) and the
        strikes count toward a rollback."""
        drain = getattr(self.pipeline, "drain", None)
        if drain is None:
            return True
        ok = True
        for m in drain():
            if self._is_bad(m):
                ok = False
                self._strikes += 1
                if self._strikes >= self.max_consecutive_bad_steps:
                    self._rollback()
                    return False
            else:
                self._strikes = 0
                self.applied_steps += 1
        return ok

    def _rollback(self) -> None:
        self.checkpointer.wait()
        latest = self.checkpointer.latest_step()
        if latest is None:
            raise RuntimeError(f"{self._strikes} consecutive bad steps and no "
                               "committed checkpoint to roll back to")
        self._checkpoint_restore(latest)
        self._strikes = 0
        self.rollbacks += 1
        recorder = _flight.current_recorder()
        if recorder is not None:
            recorder.note("rollback", restored_step=latest,
                          rollbacks=self.rollbacks)
            recorder.dump("rollback")

    def _invalidate_prefetch(self) -> None:
        # prefetched work derived from the replaced state (the semi-sync
        # pipeline's pending embedding) is stale now
        invalidate = getattr(self.pipeline, "invalidate_prefetch", None)
        if invalidate is not None:
            invalidate()

    def run(self, it: Iterator[Any],
            max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Drive ``progress`` until the source ends, ``max_steps`` applied
        steps or a preemption; always leaves a final committed checkpoint.
        Returns a summary."""
        preempted = False
        try:
            try:
                while max_steps is None or self.applied_steps < max_steps:
                    try:
                        self.progress(it)
                    except StopIteration:
                        break
            except Preempted:
                preempted = True
            else:
                # preemption wrote its own final checkpoint already
                self.checkpointer.wait()
                if self._quiesce():
                    self._checkpoint_save()
            self.checkpointer.wait()
        finally:
            # run() owns the exit: no signal-recording handler stays on a
            # loop nobody will progress() again
            self.uninstall_signal_handlers()
            self._collect_metrics()
        out = {
            "applied_steps": self.applied_steps,
            "skipped_steps": self.skipped_steps,
            "rollbacks": self.rollbacks,
            "data_fault_steps": self.data_fault_steps,
            "resumed_from": self.resumed_from,
            "preempted": preempted,
            "final_step": self.checkpointer.latest_step(),
        }
        if self.guardrails is not None:
            out["quarantined_batches"] = self.guardrails.quarantined_batches
            out["sanitized_batches"] = self.guardrails.sanitized_batches
        return out
