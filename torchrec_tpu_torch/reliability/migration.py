"""Drift-triggered replan and live plan migration with no lost step
(``torchrec_tpu/reliability/migration.py``).

The health monitor (``obs/health.py``) finds that live telemetry left
the envelope the planner stamped on the plan; a :class:`ReplanTrigger`
turns its alarm onsets into a damped migrate-or-not policy; and a
:class:`PlanMigrator` runs the migration as one fault-tolerant
transaction over existing parts:

* **quiesce**: ``FaultTolerantTrainLoop._quiesce`` runs queued
  lookahead steps out (a tiered pipeline's ``drain()``), so no step
  straddles the plan boundary, then the card is synchronized;
* **commit**: a checkpoint lands through the crash-safe (under a process
  group, two-phase) path; the committed step IS the rollback target;
* **replan**: a fresh ``EmbeddingShardingPlanner`` priced with the LIVE
  values (``EstimatorContext.from_telemetry`` over the monitor's EWMAs)
  proposes a candidate; the gate prices the OLD plan under the SAME live
  context (``price_plan``) and rejects a candidate that does not clear
  ``min_improvement``;
* **reshard**: the candidate runtime is rebuilt
  (``dynamic_sharding.clone_dmp_for_plan``) and its state restored from
  the committed checkpoint (``Checkpointer.restore_elastic``: portable
  weights and rebuilt optimizer slots), so the migrated state equals a
  clean restart from that checkpoint under the new plan;
* **validate**: the rebuilt state must pass ``validate_fn`` (default:
  every float leaf finite, the verdict agreed over ranks) before the
  loop adopts it;
* **rollback**: any failure in the process (a reshard error, a
  validation NaN, a restore error) reinstalls the committed step under
  the OLD plan and training goes on; a process death in the window
  (``kill_mid_reshard`` / ``kill_mid_validate``) is recovered by the
  ``ElasticSupervisor``'s relaunch, which resumes from the same
  committed step.

``reliability/migration_demo.py`` is the deterministic recipe the
drills run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

from torchrec_tpu_torch.obs import flight_recorder as _flight
from torchrec_tpu_torch.obs.spans import span as obs_span

#: Env var the ElasticSupervisor sets when a ``plan_provider`` is
#: configured: an ``ir.serializer.serialize_plan`` payload (inline JSON)
#: or a path to a file holding one — the replanned plan a relaunched
#: generation should resume under instead of planning for itself.
ENV_PLAN = "TORCHREC_ELASTIC_PLAN"


class MigrationError(RuntimeError):
    """An in-transaction failure the migrator must roll back from
    (validation NaN, reshard inconsistency) — never propagated past
    ``migrate``; the rollback path converts it into a
    ``rolled_back`` report."""


def plan_from_env() -> Optional[Dict[str, Any]]:
    """The supervisor-provided plan for this generation, or None when
    launched without one (the worker then plans for itself — the
    pre-migration default).  Accepts the :data:`ENV_PLAN` value as
    inline ``serialize_plan`` JSON or as a path to a file holding it."""
    raw = os.environ.get(ENV_PLAN)
    if not raw:
        return None
    from torchrec_tpu_torch.ir.serializer import deserialize_plan

    if not raw.lstrip().startswith("{"):
        with open(raw, encoding="utf-8") as f:
            raw = f.read()
    return deserialize_plan(raw)


class ReplanTrigger:
    """Damped migrate/don't-migrate policy over HealthMonitor alarm
    edges and elastic world-size changes.

    Arms on an ``on_alarm`` onset (edge-triggered — once per
    persistence-crossing) or an explicit :meth:`note_world_change`;
    :meth:`should_fire` then applies the damping the "never flap"
    contract needs: a **cooldown** of ``cooldown_steps`` applied steps
    after any decision (``reject_cooldown_steps`` after a rejection,
    defaulting to the same), and **hysteresis** — a drift-armed trigger
    re-checks the monitor's LEVEL state and quietly disarms when every
    detector recovered on its own, so a transient that cleared before
    the cooldown elapsed never migrates.  The improvement gate
    (``PlanMigrator.min_improvement``) is the third damper: an armed
    trigger whose replan does not clear it records a rejection and
    waits out the rejection cooldown before re-pricing.

    monitor: the ``obs.HealthMonitor`` to subscribe to (None for a
        world-change-only trigger); cooldown_steps / reject_cooldown_steps
        as above.
    """

    def __init__(
        self,
        monitor: Optional[Any] = None,
        cooldown_steps: int = 50,
        reject_cooldown_steps: Optional[int] = None,
    ):
        self.monitor = monitor
        self.cooldown_steps = int(cooldown_steps)
        self.reject_cooldown_steps = int(
            cooldown_steps
            if reject_cooldown_steps is None
            else reject_cooldown_steps
        )
        self.alarm_onsets = 0
        self.world_changes = 0
        self._armed_reason: Optional[str] = None
        self._cooldown_until = 0
        if monitor is not None:
            monitor.on_alarm(self._on_alarm)

    def _on_alarm(self, alert) -> None:
        self.alarm_onsets += 1
        if self._armed_reason is None or not self._armed_reason.startswith(
            "world_change"
        ):
            self._armed_reason = f"drift:{alert.table}/{alert.signal}"

    def note_world_change(self, old_world: int, new_world: int) -> None:
        """Arm for an elastic world-size change: the running plan was
        priced for ``old_world`` devices — a resumed generation should
        replan, not recycle it."""
        self.world_changes += 1
        self._armed_reason = f"world_change:{old_world}->{new_world}"

    @property
    def armed(self) -> bool:
        return self._armed_reason is not None

    def should_fire(self, step: int) -> Optional[str]:
        """The migration reason when a migration should be attempted at
        applied-step ``step``, else None (not armed / cooling down /
        drift recovered on its own)."""
        if self._armed_reason is None or step < self._cooldown_until:
            return None
        if (
            self._armed_reason.startswith("drift:")
            and self.monitor is not None
            and not self.monitor.alarmed()
        ):
            # hysteresis: the drift cleared before we acted — disarm
            self._armed_reason = None
            return None
        return self._armed_reason

    def record_outcome(self, step: int, outcome: str) -> None:
        """Anchor the cooldown after a decision.  A completed migration
        disarms (the next drift must cross again).  A gate rejection
        (``rejected_same_plan`` / ``rejected_improvement``) keeps a
        DRIFT arming armed — a persisting drift re-prices after the
        rejection cooldown, and hysteresis disarms it if the monitor
        recovers — but DISARMS a world-change arming: the world has no
        level state that can "recover", so a replan that already said
        no-change/no-win would otherwise re-run the whole
        quiesce+commit+replan cycle on every cooldown expiry for the
        rest of the run.  Rollbacks and aborts stay armed so the
        interrupted migration is retried."""
        if outcome == "completed":
            self._armed_reason = None
            self._cooldown_until = step + self.cooldown_steps
            return
        if outcome in (
            "rejected_same_plan",
            "rejected_improvement",
        ) and (self._armed_reason or "").startswith("world_change"):
            self._armed_reason = None
        self._cooldown_until = step + self.reject_cooldown_steps


@dataclasses.dataclass
class MigrationReport:
    """One migration attempt: the triggering ``reason``, the applied
    ``step`` it ran at, the ``outcome`` (``completed`` / ``rolled_back``
    / ``rejected_improvement`` / ``rejected_same_plan`` /
    ``aborted_quiesce``), the live-priced ``old_cost`` / ``new_cost``
    bottleneck seconds and their relative ``improvement``, the
    ``committed_step`` anchoring the transaction, the wall seconds of
    each phase entered (``phase_seconds``: quiesce, commit, replan,
    reshard, validate), wall ``duration_s``
    trigger->resumed, and the ``error`` text of a rollback."""

    reason: str
    step: int
    outcome: str
    old_cost: Optional[float] = None
    new_cost: Optional[float] = None
    improvement: Optional[float] = None
    committed_step: Optional[int] = None
    duration_s: float = 0.0
    error: Optional[str] = None
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def _barrier() -> None:
    """Every rank of the process group, when one is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1):
        dist.barrier()


@contextlib.contextmanager
def _phase(report: MigrationReport, name: str, **attrs):
    """A migration phase: its span, and its wall seconds in the report
    (also when it raises)."""
    t0 = time.perf_counter()
    try:
        with obs_span(f"migration/{name}", **attrs):
            yield
    finally:
        report.phase_seconds[name] = time.perf_counter() - t0


class PlanMigrator:
    """Executes quiesce -> replan-from-live-telemetry -> reshard ->
    validate -> resume as one fault-tolerant transaction against a
    ``FaultTolerantTrainLoop`` (see the module docstring for the
    state machine; docs/fault_tolerance.md, "Online migration").

    trigger: the :class:`ReplanTrigger` (its ``monitor`` supplies live
        signals and the stamped plan assumptions).
    planner_factory: ``ctx -> EmbeddingShardingPlanner`` — builds the
        replanning planner from the live
        ``EstimatorContext.from_telemetry`` context (pass
        ``constraints=ctx.constraints`` through so enumeration sees the
        live numbers too).
    pipeline_factory: ``(dmp, state) -> pipeline`` — rebuilds the train
        pipeline for an adopted runtime.
    tables: the embedding configs the planner plans over.
    base_context: optional plan-time ``EstimatorContext`` whose
        constraints seed the live overrides (defaults to one derived
        from the stamped assumptions).
    min_improvement: minimum relative bottleneck-cost improvement
        (old - new) / old a candidate must clear; below it the replan
        is rejected and nothing is touched.
    validate_fn: ``(dmp, state) -> bool`` post-reshard acceptance
        (default: every state leaf finite); a False return rolls back.
    registry: optional ``obs.MetricsRegistry`` for the ``migration/*``
        counters/histograms (falls back to the loop's attached one).
    phase_hook: ``(phase: str) -> None`` called entering the
        ``"reshard"`` and ``"validate"`` windows — the fault-injection
        seam (``ProcessFaultPlan.migration_kill_phase`` SIGKILLs here;
        in-process tests raise to drive the rollback path).
    """

    # the transaction's collaborators are genuinely this many; a config
    # object would just rename them
    def __init__(  # the transaction's collaborators, one for one
        self,
        trigger: ReplanTrigger,
        planner_factory: Callable[..., Any],
        pipeline_factory: Callable[[Any, Any], Any],
        tables: Any,
        base_context: Optional[Any] = None,
        min_improvement: float = 0.1,
        validate_fn: Optional[Callable[[Any, Any], bool]] = None,
        registry: Optional[Any] = None,
        phase_hook: Optional[Callable[[str], None]] = None,
    ):
        self.trigger = trigger
        self.planner_factory = planner_factory
        self.pipeline_factory = pipeline_factory
        self.tables = tables
        self.base_context = base_context
        self.min_improvement = float(min_improvement)
        self.validate_fn = validate_fn or self._default_validate
        self._registry = registry
        self.phase_hook = phase_hook or (lambda phase: None)
        self.reports: List[MigrationReport] = []

    # -- helpers -------------------------------------------------------

    @staticmethod
    def _default_validate(dmp, state) -> bool:
        """Every float leaf of the rebuilt state finite — the same
        multi-controller-consistent check the loop's bad-step guard
        uses, so every rank reaches the same verdict."""
        from torchrec_tpu_torch.reliability.train_loop import _has_non_finite

        return not _has_non_finite(state)

    def _reg(self, loop):
        if self._registry is not None:
            return self._registry
        obs = getattr(loop, "_obs", None)
        return obs[0] if obs else None

    def _count(self, reg, name: str) -> None:
        if reg is not None:
            reg.counter(f"migration/{name}")

    def _finish(self, loop, report: MigrationReport, t0: float):
        report.duration_s = time.perf_counter() - t0
        self.reports.append(report)
        reg = self._reg(loop)
        self._count(reg, report.outcome)
        if reg is not None:
            if report.outcome == "completed":
                # trigger->resumed: the migration MTTR trend
                reg.observe(
                    "migration/hist/trigger_to_resumed_ms",
                    report.duration_s * 1e3,
                )
                if report.improvement is not None:
                    reg.gauge(
                        "migration/last_improvement", report.improvement
                    )
            elif report.outcome == "rolled_back":
                reg.observe(
                    "migration/hist/rollback_ms", report.duration_s * 1e3
                )
            reg.gauge("migration/last_step", float(report.step))
        self.trigger.record_outcome(report.step, report.outcome)
        return report

    # -- the transaction ----------------------------------------------

    def maybe_migrate(self, loop) -> Optional[MigrationReport]:
        """Called by the loop at applied-step boundaries: runs one
        migration attempt when the trigger says so, else a no-op."""
        reason = self.trigger.should_fire(loop.applied_steps)
        if reason is None:
            return None
        return self.migrate(loop, reason)

    def migrate(self, loop, reason: str) -> MigrationReport:
        """One full migration transaction; returns its report.  Never
        raises for in-process failures (they roll back); process-death
        injections (``SimulatedCrash``/SIGKILL) propagate — that IS the
        crash the supervisor-level recovery covers."""
        import torch

        t0 = time.perf_counter()
        reg = self._reg(loop)
        self._count(reg, "attempts")
        rec = _flight.current_recorder()
        if rec is not None:
            rec.note("migration_start", reason=reason,
                     step=loop.applied_steps)
        report = MigrationReport(
            reason=reason, step=loop.applied_steps, outcome="",
        )

        # 1. quiesce: run queued lookahead out; a bad drained step means
        # the pre-migration state is not committable — do nothing now
        # (the loop's own strike/rollback machinery owns that path)
        with _phase(report, "quiesce"):
            loop.checkpointer.wait()
            if not loop._quiesce():
                report.outcome = "aborted_quiesce"
                return self._finish(loop, report, t0)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()

        # 2. commit the pre-migration generation — the rollback target
        with _phase(report, "commit"):
            loop._checkpoint_save()
            loop.checkpointer.wait()
            # under a process group rank 0 writes: no rank reads the
            # committed step (the anchor every rank must agree on) before
            # that write has landed
            _barrier()
        committed = loop.checkpointer.latest_step()
        report.committed_step = committed
        if committed is None:
            report.outcome = "aborted_quiesce"
            report.error = "no committed checkpoint to anchor on"
            return self._finish(loop, report, t0)

        # 3-6. replan -> gate -> reshard -> validate -> adopt, rolling
        # back on ANY in-process failure — the replan/pricing phase is
        # INSIDE the contract too (an infeasible live constraint or a
        # plan without stamped assumptions must record a rollback, not
        # crash the run); a process death here is the supervisor's
        # recovery, anchored on the same committed generation
        from torchrec_tpu_torch.parallel.dynamic_sharding import (
            clone_dmp_for_plan,
        )
        from torchrec_tpu_torch.parallel.planner.shard_estimators import (
            EstimatorContext,
            price_plan,
        )

        monitor = self.trigger.monitor
        assumptions = monitor.assumptions if monitor is not None else None
        old_plan = loop.dmp.plan
        if assumptions is None:
            assumptions = getattr(old_plan, "assumptions", None)
        live = monitor.live_signals() if monitor is not None else {}
        # set once the reshard window opens: only then can a rollback
        # have anything to reinstall (the replan phase mutates nothing)
        touched = False
        try:
            with _phase(report, "replan"):
                if assumptions is None:
                    raise MigrationError(
                        "no stamped PlanAssumptions to reprice "
                        "against (monitor-less trigger and a running "
                        "plan without .assumptions)"
                    )
                ctx = EstimatorContext.from_telemetry(
                    assumptions, live, base=self.base_context
                )
                planner = self.planner_factory(ctx)
                candidate = planner.plan(list(self.tables))
                topology = planner.topology
                report.old_cost = price_plan(
                    old_plan, self.tables, topology, ctx
                )
                report.new_cost = price_plan(
                    candidate, self.tables, topology, ctx
                )
            if dict(candidate) == dict(old_plan):
                report.outcome = "rejected_same_plan"
                return self._finish(loop, report, t0)
            if report.old_cost > 0:
                report.improvement = (
                    report.old_cost - report.new_cost
                ) / report.old_cost
            else:
                report.improvement = 0.0
            if report.improvement < self.min_improvement:
                report.outcome = "rejected_improvement"
                return self._finish(loop, report, t0)

            with _phase(report, "reshard", step=committed):
                touched = True
                self.phase_hook("reshard")
                new_dmp = clone_dmp_for_plan(loop.dmp, candidate)
                new_state = loop.checkpointer.restore_elastic(
                    new_dmp, committed
                )
                new_pipeline = self.pipeline_factory(new_dmp, new_state)
            with _phase(report, "validate", step=committed):
                self.phase_hook("validate")
                if not self.validate_fn(new_dmp, new_pipeline.state):
                    raise MigrationError(
                        "validation failed: candidate-plan state is "
                        "not finite/consistent"
                    )
        except Exception as e:
            # rollback: reinstall the committed pre-migration
            # generation under the OLD plan and keep training
            if touched:
                loop.pipeline.state = loop.checkpointer.restore_elastic(
                    loop.dmp, committed
                )
                loop._invalidate_prefetch()
            report.outcome = "rolled_back"
            report.error = f"{type(e).__name__}: {e}"
            if rec is not None:
                rec.note(
                    "migration_rollback",
                    committed_step=committed, error=report.error,
                )
                rec.dump("migration_rollback")
            return self._finish(loop, report, t0)

        loop.adopt_runtime(new_dmp, new_pipeline)
        report.outcome = "completed"
        if rec is not None:
            rec.note(
                "migration_committed",
                committed_step=committed,
                improvement=report.improvement,
                reason=reason,
            )
        return self._finish(loop, report, t0)

    # -- summaries -----------------------------------------------------

    def scalar_metrics(self, prefix: str = "migration") -> Dict[str, float]:
        """Flat outcome counters (the scalar_metrics idiom) for
        registries that never saw the live counters."""
        out: Dict[str, float] = {
            f"{prefix}/attempts": float(len(self.reports)),
        }
        for r in self.reports:
            key = f"{prefix}/{r.outcome}"
            out[key] = out.get(key, 0.0) + 1.0
        return out

    def summary(self) -> Dict[str, Any]:
        """Structured per-attempt history for benches/post-mortems."""
        return {
            "attempts": len(self.reports),
            "completed": sum(
                1 for r in self.reports if r.outcome == "completed"
            ),
            "rolled_back": sum(
                1 for r in self.reports if r.outcome == "rolled_back"
            ),
            "reports": [dataclasses.asdict(r) for r in self.reports],
        }


def serialize_plan_for_env(plan) -> str:
    """A plan payload suitable for :data:`ENV_PLAN` (the supervisor's
    ``plan_provider`` return value): inline ``serialize_plan`` JSON."""
    from torchrec_tpu_torch.ir.serializer import serialize_plan

    return serialize_plan(plan)


__all__ = [
    "ENV_PLAN",
    "MigrationError",
    "MigrationReport",
    "PlanMigrator",
    "ReplanTrigger",
    "plan_from_env",
    "serialize_plan_for_env",
]
