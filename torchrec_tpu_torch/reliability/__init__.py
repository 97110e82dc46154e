"""The reliability layer: fault-tolerant training over any pipeline
(``torchrec_tpu/reliability``).

* crash-safe checkpointing: ``torchrec_tpu_torch.checkpoint.Checkpointer``
  (atomic tmp-dir + COMMIT-marker commits, retention, async saves, the
  two-phase distributed commit behind a commit barrier);
* ``FaultTolerantTrainLoop``: the bad-step guard over an undo log of the
  in-place step, transient data-error retry, preemption, auto-resume
  (``train_loop``);
* the elastic runtime: ``ElasticSupervisor`` (supervised launch, failure
  detection, bounded relaunch at a reduced world size),
  ``StepWatchdog`` (the in-worker collective deadman timer) and
  ``TcpKVCommitBarrier`` (``elastic``);
* deterministic fault injectors for every recovery path
  (``fault_injection``);
* online plan migration: ``ReplanTrigger`` and ``PlanMigrator``
  (``migration``), a replan from live telemetry (``obs.HealthMonitor``)
  and a live migration between plans with no committed step lost, rolled
  back on any failure (``migration_demo`` is the drill's recipe).
"""

from torchrec_tpu_torch.reliability.elastic import (
    EXIT_PEER_FAILURE,
    BarrierTimeout,
    ElasticJobFailed,
    ElasticReport,
    ElasticSupervisor,
    ElasticWorkerContext,
    Heartbeat,
    LocalShardPipeline,
    StepWatchdog,
    TcpKVCommitBarrier,
)
from torchrec_tpu_torch.reliability.migration import (
    MigrationError,
    MigrationReport,
    PlanMigrator,
    ReplanTrigger,
)
from torchrec_tpu_torch.reliability.train_loop import (
    FaultTolerantTrainLoop,
    Preempted,
    RetryingIterator,
)

__all__ = [
    "BarrierTimeout",
    "EXIT_PEER_FAILURE",
    "ElasticJobFailed",
    "ElasticReport",
    "ElasticSupervisor",
    "ElasticWorkerContext",
    "FaultTolerantTrainLoop",
    "Heartbeat",
    "LocalShardPipeline",
    "MigrationError",
    "MigrationReport",
    "PlanMigrator",
    "Preempted",
    "ReplanTrigger",
    "RetryingIterator",
    "StepWatchdog",
    "TcpKVCommitBarrier",
]
