"""Elastic multi-process fault tolerance: supervised launch, failure
detection, and a resume that loses no committed step
(``torchrec_tpu/reliability/elastic.py``).

Sharding plans are recomputable on the host (the planner is
deterministic) and checkpoints are plan-independent (``checkpoint.py``
stores per-table weights and per-table optimizer slots), so recovery can
*replan* instead of waiting for a replacement host: detect, tear the
survivors down, relaunch at the reduced world size, replan, restore
through the ``dynamic_sharding`` scatter (``Checkpointer.
restore_elastic``) and resume.

Four pieces, one per failure surface:

* :class:`ElasticSupervisor`: the launcher-side monitor loop: per-worker
  heartbeat files, detection of exits and of hangs (heartbeat
  staleness), teardown of the stragglers (no orphaned processes), and a
  bounded relaunch with seeded-jitter backoff at a (possibly) reduced
  world size.  Each worker is one rank of a ``torch.distributed`` process
  group whose TCP store the supervisor holds for the generation, bound on
  a port the system picks, as ``parallel.multiprocess.launch`` does;
* :class:`StepWatchdog`: the in-worker deadman timer armed around each
  step: a peer's death leaves survivors blocked inside a collective no
  Python ``except`` can interrupt, so expiry hard-exits with
  :data:`EXIT_PEER_FAILURE`, which the supervisor reads as "peer
  failure" (innocent: the slot is NOT removed);
* :class:`TcpKVCommitBarrier`: the all-rank ack channel (over
  ``dynamic.tcp_kv``) behind the two-phase checkpoint commit of
  ``Checkpointer``: COMMIT only after every rank acked the prepared step;
* :class:`ElasticWorkerContext`: worker-side glue built from the
  ``TORCHREC_ELASTIC_*`` environment the supervisor sets: heartbeat
  thread, watchdog, fault-injection plan and the commit-barrier factory.

:class:`LocalShardPipeline` is the minimal multi-process train pipeline
(``state`` + ``progress(iterator)``): each rank passes its own batch
straight to its step, so ``FaultTolerantTrainLoop`` drives the same
recipe at any world size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchrec_tpu_torch.obs import flight_recorder as _flight
from torchrec_tpu_torch.obs.spans import span as obs_span

#: Exit code of a worker whose collective watchdog expired: "a peer
#: stopped participating in my rendezvous" — the supervisor treats the
#: exiting worker as an innocent survivor, not a lost host.
EXIT_PEER_FAILURE = 113

# env names the supervisor sets for workers (beside TORCHREC_MP_*)
_ENV_RUN_DIR = "TORCHREC_ELASTIC_RUN_DIR"
_ENV_GEN = "TORCHREC_ELASTIC_GEN"
_ENV_HB_DIR = "TORCHREC_ELASTIC_HB_DIR"
_ENV_KV = "TORCHREC_ELASTIC_KV"
_ENV_HB_INTERVAL = "TORCHREC_ELASTIC_HB_INTERVAL_S"
_ENV_WATCHDOG = "TORCHREC_ELASTIC_WATCHDOG_S"
# steps between flight-recorder autodumps (0 disables; default 1 —
# right for the seconds-per-step elastic drills, lower the cadence on
# fast-step production runs where a full-ring JSON dump per step would
# be a measurable tax)
_ENV_FLIGHT_INTERVAL = "TORCHREC_ELASTIC_FLIGHT_INTERVAL"
# a generation's serialized sharding plan from ``plan_provider``, read by
# the plan migrator's workers
_ENV_PLAN = "TORCHREC_ELASTIC_PLAN"


class BarrierTimeout(IOError):
    """A commit-barrier wait ran past its deadline — some rank never
    acked (died mid-save) or the COMMIT record never appeared
    (coordinator drop / rank-0 death).  ``IOError`` so the save surfaces
    it like any other failed write: the step is NOT committed."""


# ---------------------------------------------------------------------------
# worker side: heartbeat, watchdog, commit barrier
# ---------------------------------------------------------------------------


class Heartbeat:
    """Background liveness beacon: a daemon thread rewrites ``path``
    (atomic tmp + ``os.replace``) every ``interval_s`` with the latest
    ``beat()`` fields.  The supervisor reads only the file's mtime for
    staleness — a SIGSTOP'd or dead process stops refreshing it — and
    the JSON body for progress (``step`` / ``applied``) telemetry.

    The writer thread deliberately has NO blanket exception guard: if
    writing the beacon fails,
    dying loudly IS the correct signal — an unreported dead heartbeat
    thread would be indistinguishable from a process hang."""

    def __init__(self, path: str, interval_s: float = 0.2):
        self.path = path
        self.interval_s = interval_s
        self._fields: Dict[str, Any] = {"pid": os.getpid()}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def start(self) -> None:
        """Write the first beat synchronously, then beat on a daemon
        thread until ``stop()``."""
        self._write()
        self._thread = threading.Thread(
            target=self._run, name="elastic-heartbeat", daemon=True
        )
        self._thread.start()

    def beat(self, **fields: Any) -> None:
        """Merge ``fields`` (e.g. ``step=``, ``applied=``, ``phase=``)
        into the beacon and write it immediately."""
        with self._lock:
            self._fields.update(fields)
        self._write()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def _write(self) -> None:
        # whole write under the lock: the beat() caller and the beacon
        # thread share one tmp path, and an interleaved write would
        # publish garbled JSON to the supervisor
        with self._lock:
            body = dict(self._fields, time=time.time())
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, self.path)


class StepWatchdog:
    """Deadman timer armed around each dispatched step.

    When a peer dies mid-step, survivors block inside the collective
    rendezvous (all-to-all / psum / the checkpoint allgather) where no
    Python exception can reach them.  ``armed()`` starts a timer before
    the step and cancels it after; expiry writes a diagnostic to stderr
    and hard-exits (``os._exit`` — the process is wedged inside native
    code, so normal teardown would itself hang) with ``exit_code``
    (default :data:`EXIT_PEER_FAILURE`), which the supervisor maps to
    "peer failure": this worker's slot survives the relaunch.

    budget_s: per-step deadline — must cover a step's compile on its
        first arming plus the commit-barrier wait of a checkpointing
        step; ``_exit_fn`` is injectable for tests (defaults to
        ``os._exit``)."""

    def __init__(
        self,
        budget_s: float,
        exit_code: int = EXIT_PEER_FAILURE,
        _exit_fn=os._exit,  # injectable for tests
    ):
        self.budget_s = budget_s
        self.exit_code = exit_code
        self._exit_fn = _exit_fn
        self._timer: Optional[threading.Timer] = None
        self.expired = False

    def _expire(self, label: str) -> None:
        self.expired = True
        recorder = _flight.current_recorder()
        if recorder is not None:
            # last words: the ring buffer is the only structured
            # evidence this process will ever produce — dump BEFORE the
            # hard exit (FlightRecorder.dump never raises)
            recorder.note(
                "watchdog_expired", label=label, budget_s=self.budget_s
            )
            recorder.dump("watchdog")
        sys.stderr.write(
            f"elastic watchdog: step {label!r} exceeded its "
            f"{self.budget_s:.1f}s budget — assuming a peer died inside "
            f"a collective; exiting {self.exit_code}\n"
        )
        sys.stderr.flush()
        self._exit_fn(self.exit_code)

    @contextlib.contextmanager
    def armed(self, label: str = ""):
        """Arm for one step; disarm on exit (including exceptions)."""
        t = threading.Timer(self.budget_s, self._expire, args=(label,))
        t.daemon = True
        self._timer = t
        t.start()
        try:
            yield self
        finally:
            t.cancel()
            self._timer = None


class TcpKVCommitBarrier:
    """All-rank ack channel for the two-phase checkpoint commit,
    speaking the existing ``dynamic.tcp_kv`` wire protocol (dim-1 rows
    as flags).

    Protocol per step N over namespace ``{ns}`` (one namespace per
    generation, so acks from a torn-down generation cannot satisfy the
    next one):

    * ``prepare(N)``    — PUT key ``N*world + rank`` (PREPARED: my view
      of the payload is consistent and durable);
    * ``wait_all_prepared(N)`` — rank 0 polls until every rank's
      PREPARED key exists (deadline: :class:`BarrierTimeout`);
    * ``commit(N)``     — rank 0 PUTs key ``-(N+1)`` AFTER the atomic
      COMMIT rename landed;
    * ``wait_committed(N)`` — other ranks poll for the COMMIT key.

    ``crash_mid_save_step`` is the fault-injection hook
    (reliability/fault_injection.py): SIGKILL this process inside
    ``prepare`` — after its payload write, BEFORE its PREPARED ack —
    the deterministic "crash between a rank's write and COMMIT" window
    the torn-save acceptance test drives."""

    def __init__(
        self,
        addr: str,
        namespace: str,
        rank: int,
        world: int,
        deadline_s: float = 60.0,
        poll_s: float = 0.02,
    ):
        from torchrec_tpu_torch.dynamic.tcp_kv import TcpKV

        self.rank = rank
        self.world = world
        self.deadline_s = deadline_s
        self.poll_s = poll_s
        self.crash_mid_save_step: Optional[int] = None
        # rank-agreed, run-unique token for the Checkpointer's
        # distributed tmp-dir names (namespace = generation, port =
        # fresh per launch): see checkpoint._write_two_phase
        self.save_token = f"{namespace}_{addr.rsplit(':', 1)[-1]}"
        self._kv = TcpKV(f"{addr}/{namespace}", dim=1)

    def _ack_key(self, step: int, rank: int) -> int:
        return step * self.world + rank

    @staticmethod
    def _commit_key(step: int) -> int:
        return -(step + 1)

    def prepare(self, step: int) -> None:
        """Post this rank's PREPARED ack for ``step``."""
        if self.crash_mid_save_step == step:
            # the payload write is done, the ack is NOT posted: dying
            # here is the exact torn-multi-rank-save crash window
            sys.stderr.write(
                f"fault injection: SIGKILL mid-save (before PREPARED "
                f"ack) of step {step} (rank {self.rank})\n"
            )
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        self._kv.put(
            np.asarray([self._ack_key(step, self.rank)], np.int64),
            np.ones((1, 1), np.float32),
        )

    def _poll(self, keys: List[int], what: str, step: int) -> None:
        deadline = time.monotonic() + self.deadline_s
        arr = np.asarray(keys, np.int64)
        while True:
            _, found = self._kv.get(arr)
            if found.all():
                return
            if time.monotonic() > deadline:
                missing = [int(k) for k, f in zip(keys, found) if not f]
                raise BarrierTimeout(
                    f"commit barrier: {what} for step {step} timed out "
                    f"after {self.deadline_s:.1f}s (missing keys "
                    f"{missing}) — a rank died mid-save or the "
                    "coordinator dropped; the step stays uncommitted"
                )
            time.sleep(self.poll_s)

    def wait_all_prepared(self, step: int) -> None:
        """Rank 0: block until every rank acked PREPARED for ``step``."""
        self._poll(
            [self._ack_key(step, r) for r in range(self.world)],
            "all-rank PREPARED ack", step,
        )

    def commit(self, step: int) -> None:
        """Rank 0: publish the COMMIT record (the rename already
        landed — this only releases the other ranks' wait)."""
        self._kv.put(
            np.asarray([self._commit_key(step)], np.int64),
            np.ones((1, 1), np.float32),
        )

    def wait_committed(self, step: int) -> None:
        """Non-zero ranks: block until rank 0 published COMMIT."""
        self._poll([self._commit_key(step)], "COMMIT record", step)

    def close(self) -> None:
        self._kv.close()


class ElasticWorkerContext:
    """Worker-side elastic runtime assembled from the supervisor's
    ``TORCHREC_ELASTIC_*`` env: heartbeat beacon (written to
    ``hb_path`` every ``hb_interval_s``), step watchdog (``watchdog_s``
    budget), the deterministic ``fault_plan``, and the commit-barrier
    factory (``kv_addr``; None disables the barrier).  ``rank`` /
    ``world`` are the process rank and count, ``gen`` the supervisor's
    launch generation.  ``from_env()`` returns None outside a
    supervised run, so recipes can stay launch-agnostic."""

    # ctor mirrors the TORCHREC_ELASTIC_* env surface 1:1; from_env is
    # the real entry point
    def __init__(
        self,
        rank: int,
        world: int,
        gen: int,
        hb_path: str,
        kv_addr: Optional[str],
        watchdog_s: float = 120.0,
        hb_interval_s: float = 0.2,
        fault_plan=None,
        run_dir: Optional[str] = None,
    ):
        self.rank = rank
        self.world = world
        self.gen = gen
        self.kv_addr = kv_addr
        # the supervisor's run directory: where workers may drop
        # per-rank artifacts (profiles, dumps) for post-mortems
        self.run_dir = run_dir
        self.heartbeat = Heartbeat(hb_path, interval_s=hb_interval_s)
        self.watchdog = StepWatchdog(watchdog_s)
        self.fault_plan = fault_plan
        # crash flight recorder (obs/flight_recorder.py): per-step
        # autodump (cadence via TORCHREC_ELASTIC_FLIGHT_INTERVAL) so
        # even a SIGKILL'd worker leaves a ring current to its last
        # beaten step; the supervisor harvests these into the
        # post-mortem bundle (collect_postmortem).  capacity=128 bounds
        # the per-dump serialization cost the autodump pays.
        self.flight: Optional[_flight.FlightRecorder] = None
        if run_dir is not None:
            self.flight = _flight.FlightRecorder(
                os.path.join(
                    run_dir, f"gen_{gen}", "flight", f"rank_{rank}.json"
                ),
                capacity=128,
                meta={"rank": rank, "gen": gen, "world": world},
                autodump_interval=int(
                    os.environ.get(_ENV_FLIGHT_INTERVAL, "1") or 0
                ),
            )

    @classmethod
    def from_env(cls) -> Optional["ElasticWorkerContext"]:
        """Build from the supervisor's env; None when unsupervised."""
        hb_dir = os.environ.get(_ENV_HB_DIR)
        if not hb_dir:
            return None
        from torchrec_tpu_torch.parallel.multiprocess import (
            _ENV_NPROC,
            _ENV_PID,
        )
        from torchrec_tpu_torch.reliability.fault_injection import (
            ProcessFaultPlan,
        )

        rank = int(os.environ.get(_ENV_PID, "0"))
        world = int(os.environ.get(_ENV_NPROC, "1"))
        gen = int(os.environ.get(_ENV_GEN, "0"))
        return cls(
            rank=rank,
            world=world,
            gen=gen,
            hb_path=os.path.join(hb_dir, f"rank_{rank}.json"),
            kv_addr=os.environ.get(_ENV_KV) or None,
            watchdog_s=float(os.environ.get(_ENV_WATCHDOG, "120")),
            hb_interval_s=float(os.environ.get(_ENV_HB_INTERVAL, "0.2")),
            fault_plan=ProcessFaultPlan.from_env(),
            run_dir=os.environ.get(_ENV_RUN_DIR) or None,
        )

    def start(self) -> None:
        self.heartbeat.beat(rank=self.rank, gen=self.gen, step=0, applied=0)
        self.heartbeat.start()
        if self.flight is not None:
            _flight.install_recorder(self.flight)

    def beat(self, step: int, applied: int) -> None:
        self.heartbeat.beat(step=step, applied=applied)
        if self.flight is not None:
            # step summary mirrors the heartbeat, so a harvested dump's
            # last recorded step always matches the final beacon
            self.flight.record_step(step, applied=applied)

    @contextlib.contextmanager
    def step_scope(self, global_step: int):
        """Per-step guard: fire any scheduled process fault for this
        (rank, gen, step), then run the step under the armed watchdog."""
        if self.fault_plan is not None:
            self.fault_plan.maybe_fire(self.rank, self.gen, global_step)
        with self.watchdog.armed(label=f"step_{global_step}"):
            yield

    def commit_barrier(
        self, deadline_s: float = 60.0
    ) -> Optional[TcpKVCommitBarrier]:
        """Commit barrier for this generation (None without a KV
        coordinator); wires the kill-after-prepare fault hook."""
        if self.kv_addr is None:
            return None
        barrier = TcpKVCommitBarrier(
            self.kv_addr,
            namespace=f"ckpt_g{self.gen}",
            rank=self.rank,
            world=self.world,
            deadline_s=deadline_s,
        )
        if self.fault_plan is not None:
            barrier.crash_mid_save_step = (
                self.fault_plan.kill_mid_save_step(self.rank, self.gen)
            )
        return barrier

    def shutdown(self) -> None:
        self.heartbeat.stop()
        if self.flight is not None:
            self.flight.dump("shutdown")
            if _flight.current_recorder() is self.flight:
                _flight.uninstall_recorder()


class LocalShardPipeline:
    """The minimal multi-process pipeline (``state`` +
    ``progress(iterator)``) for ``FaultTolerantTrainLoop``: each rank's
    process pulls its own batch from its iterator and passes it, on the
    rank's device, straight to its step (the JAX package assembles a
    global batch from the processes' local shards instead).

    step_fn: ``(state, batch) -> (state, metrics)``, e.g.
    ``dmp.train_step``; ``state`` the initial train state; ``env`` the
    rank's ``ShardingEnv``, whose device the batch goes to;
    ``on_host_batch``: an optional callback given the list of this
    step's host batches before the transfer (the seam a telemetry shim
    reads per-key occupancy from)."""

    def __init__(self, step_fn, state, env, on_host_batch=None):
        self._step = step_fn
        self.state = state
        self._env = env
        self._on_host_batch = on_host_batch

    def progress(self, it):
        """One step over this rank's batch; returns the step's
        metrics."""
        batch = next(it)
        if self._on_host_batch is not None:
            self._on_host_batch([batch])
        self.state, metrics = self._step(self.state,
                                         batch.to(self._env.device))
        return metrics


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerFailure:
    """One detected failure: which ``rank``, why, the observed
    ``returncode`` (None for hangs), and ``detect_latency_s`` —
    detection time minus the worker's last observed liveness.

    ``cause``: ``crash``/``hang`` = a lost host (the slot is removed
    next generation); ``peer`` (watchdog exit or a collective-error log
    tail), ``infra`` (coordinator-port bind TOCTOU — fresh port next
    generation), and ``coordinator`` (injected KV drop) are innocent —
    those slots survive the relaunch."""

    rank: int
    cause: str  # "crash" | "hang" | "peer" | "infra" | "coordinator"
    returncode: Optional[int]
    detect_latency_s: float  # detection time - last observed liveness


@dataclasses.dataclass
class GenerationReport:
    """Outcome of launch generation ``gen`` at process count ``world``:
    ``ok``, the detected ``failures``, spawned ``pids`` (post-mortem
    orphan checks), and the monotonic ``started_at`` /
    ``detected_at`` / ``teardown_done_at`` probe timestamps."""

    gen: int
    world: int  # process count this generation
    ok: bool
    failures: List[WorkerFailure] = dataclasses.field(default_factory=list)
    pids: List[int] = dataclasses.field(default_factory=list)
    detected_at: Optional[float] = None  # monotonic
    teardown_done_at: Optional[float] = None
    started_at: float = 0.0


@dataclasses.dataclass
class ElasticReport:
    """Supervisor summary: per-generation outcomes (``generations``,
    ``restarts``, ``final_world``, overall ``ok``) plus the MTTR
    decomposition:
    ``detect_latency_s``, ``teardown_s``,
    ``relaunch_to_first_resumed_step_s``, and end-to-end ``mttr_s``
    (failure detection to the first resumed applied step)."""

    generations: List[GenerationReport]
    restarts: int
    final_world: int
    ok: bool
    # MTTR pieces for the FIRST failure (None when no failure/recovery)
    detect_latency_s: Optional[float] = None
    teardown_s: Optional[float] = None
    relaunch_to_first_resumed_step_s: Optional[float] = None
    mttr_s: Optional[float] = None
    # post-mortem bundle (collect_postmortem) written after a run with
    # failures: per-worker flight-recorder dumps + final heartbeats +
    # log tails in one atomic JSON
    postmortem_path: Optional[str] = None

    def scalar_metrics(self, prefix: str = "elastic") -> Dict[str, float]:
        """Flat counters for the obs MetricsRegistry."""
        out = {
            f"{prefix}/generations": float(len(self.generations)),
            f"{prefix}/restarts": float(self.restarts),
            f"{prefix}/failures": float(
                sum(len(g.failures) for g in self.generations)
            ),
            f"{prefix}/final_world": float(self.final_world),
        }
        if self.detect_latency_s is not None:
            out[f"{prefix}/detect_latency_s"] = self.detect_latency_s
        if self.mttr_s is not None:
            out[f"{prefix}/mttr_s"] = self.mttr_s
        return out


class ElasticJobFailed(RuntimeError):
    """The relaunch budget ran out (or a generation died without a
    recoverable cause); carries the report for post-mortems."""

    def __init__(self, message: str, report: ElasticReport):
        super().__init__(message)
        self.report = report


class ElasticSupervisor:
    """Supervised elastic launcher for multi-process training, one rank
    a process (the CPU, or ranks sharing a card over gloo).

    A monitor loop: spawn ``num_processes`` workers (stdout streamed to
    per-worker log files), watch exits AND heartbeat staleness, tear
    down stragglers on any failure (SIGKILL + reap — no orphans), and
    relaunch up to ``max_relaunches`` times with seeded-jitter backoff.
    Ranks that crashed or hung are treated as lost hosts — the next
    generation launches at the reduced process count (floor
    ``min_world``) and workers replan/reshard on resume; ranks that
    exited with :data:`EXIT_PEER_FAILURE` (their watchdog saw a peer
    die) keep their slot.

    Each generation gets a fresh coordinator port, heartbeat dir, and —
    unless ``with_kv=False`` — a fresh :class:`TcpKVServer` whose
    address workers read from ``TORCHREC_ELASTIC_KV`` for the
    checkpoint commit barrier.  ``fault_plan`` (a
    ``reliability.fault_injection.ProcessFaultPlan``) is forwarded to
    workers via env; its ``coordinator_drop`` entries are executed
    supervisor-side (the KV server is stopped once the watched
    generation reaches the scheduled step).

    Knobs: ``script``/``args`` + ``num_processes`` define the job (each
    worker runs ``script`` with ``args``, its rank, the world size and the
    generation's store in its environment, ``multiprocess._worker_env``,
    and joins with ``multiprocess.initialize``); ``run_dir`` holds per-generation
    heartbeat/log dirs; ``env_extra`` adds worker env; relaunch policy
    is ``max_relaunches`` / ``min_world`` / ``backoff_s`` doubling per
    generation with ``backoff_jitter`` seeded by ``seed``; liveness is
    ``poll_interval_s`` polling with ``hang_timeout_s`` heartbeat
    staleness (``startup_grace_s`` before the first beat,
    ``generation_timeout_s`` overall); ``watchdog_s`` and
    ``hb_interval_s`` are forwarded to workers; ``with_kv=False``
    disables the commit-barrier KV server; ``plan_provider(gen, world)``
    optionally hands each generation a serialized replanned sharding
    plan via ``TORCHREC_ELASTIC_PLAN`` (for the plan migrator), so a
    shrunk/grown relaunch resumes under a plan priced for its ACTUAL
    world; None (default) keeps workers planning for themselves.
    """

    # flat supervision knobs mirror torchelastic's launcher surface; a
    # config object would just rename them
    def __init__(
        self,
        script: str,
        num_processes: int,
        args: Sequence[str] = (),
        run_dir: str = "elastic_run",
        env_extra: Optional[Dict[str, str]] = None,
        max_relaunches: int = 2,
        min_world: int = 1,
        backoff_s: float = 0.25,
        backoff_jitter: float = 0.5,
        seed: int = 0,
        poll_interval_s: float = 0.1,
        hang_timeout_s: float = 10.0,
        startup_grace_s: float = 180.0,
        generation_timeout_s: float = 600.0,
        watchdog_s: float = 120.0,
        hb_interval_s: float = 0.2,
        with_kv: bool = True,
        fault_plan=None,
        plan_provider=None,
    ):
        self.script = script
        self.num_processes = num_processes
        self.args = list(args)
        self.run_dir = os.path.abspath(run_dir)
        self.env_extra = dict(env_extra or {})
        self.max_relaunches = max_relaunches
        self.min_world = max(1, min_world)
        self.backoff_s = backoff_s
        self.backoff_jitter = backoff_jitter
        self.poll_interval_s = poll_interval_s
        self.hang_timeout_s = hang_timeout_s
        self.startup_grace_s = startup_grace_s
        self.generation_timeout_s = generation_timeout_s
        self.watchdog_s = watchdog_s
        self.hb_interval_s = hb_interval_s
        self.with_kv = with_kv
        self.fault_plan = fault_plan
        # plan_provider(gen, world) -> Optional[str]: a serialized plan
        # (or a path to one) injected into worker env as
        # TORCHREC_ELASTIC_PLAN, so a
        # relaunched (shrunk/grown) generation resumes under a
        # REPLANNED plan instead of planning for itself.  None (the
        # default) preserves the original behavior: no env var is set
        # and workers replan locally.
        self.plan_provider = plan_provider
        self._rng = np.random.RandomState(seed)
        self._registry = None
        # MTTR probes (monotonic timestamps)
        self._detected_at: Optional[float] = None
        self._first_resumed_at: Optional[float] = None
        os.makedirs(self.run_dir, exist_ok=True)

    def attach_telemetry(self, registry: Any) -> None:
        """Absorb the final report's counters into an
        ``obs.MetricsRegistry`` when ``run()`` returns."""
        self._registry = registry

    # -- paths ---------------------------------------------------------

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.run_dir, f"gen_{gen}")

    def hb_dir(self, gen: int) -> str:
        return os.path.join(self._gen_dir(gen), "hb")

    def log_path(self, gen: int, rank: int) -> str:
        return os.path.join(self._gen_dir(gen), "logs", f"rank_{rank}.log")

    # -- lifecycle -----------------------------------------------------

    def run(self) -> ElasticReport:
        """Supervise until a generation completes cleanly or the
        relaunch budget runs out (:class:`ElasticJobFailed`)."""
        generations: List[GenerationReport] = []
        world = self.num_processes
        gen = 0
        while True:
            rep = self._run_generation(gen, world)
            generations.append(rep)
            if rep.ok:
                return self._final_report(generations, world, ok=True)
            lost = sum(
                1 for f in rep.failures if f.cause in ("crash", "hang")
            )
            if gen >= self.max_relaunches:
                report = self._final_report(generations, world, ok=False)
                raise ElasticJobFailed(
                    f"generation {gen} failed "
                    f"({[f.cause for f in rep.failures]}) and the "
                    f"relaunch budget ({self.max_relaunches}) is spent",
                    report,
                )
            world = max(self.min_world, world - lost)
            delay = self.backoff_s * (2 ** gen) * (
                1.0 + self.backoff_jitter * float(self._rng.rand())
            )
            with obs_span("elastic/relaunch_backoff", gen=gen, world=world):
                time.sleep(delay)
            gen += 1

    def _final_report(
        self, generations: List[GenerationReport], world: int, ok: bool
    ) -> ElasticReport:
        first_fail = next(
            (g for g in generations if g.failures), None
        )
        report = ElasticReport(
            generations=generations,
            restarts=len(generations) - 1,
            final_world=world,
            ok=ok,
        )
        if first_fail is not None:
            report.detect_latency_s = first_fail.failures[0].detect_latency_s
            if first_fail.teardown_done_at and first_fail.detected_at:
                report.teardown_s = (
                    first_fail.teardown_done_at - first_fail.detected_at
                )
            if self._first_resumed_at and first_fail.detected_at:
                report.mttr_s = (
                    self._first_resumed_at - first_fail.detected_at
                )
                if first_fail.teardown_done_at:
                    report.relaunch_to_first_resumed_step_s = (
                        self._first_resumed_at - first_fail.teardown_done_at
                    )
        if any(g.failures for g in generations):
            # harvest per-worker flight dumps while they are fresh —
            # the bundle exists whether or not the job recovered
            report.postmortem_path = self.collect_postmortem(report)
        if self._registry is not None:
            self._registry.absorb(report.scalar_metrics())
            self._observe_recovery_histograms(report)
        return report

    def _observe_recovery_histograms(self, report: ElasticReport) -> None:
        """MTTR probes as registry HISTOGRAMS (``elastic/hist/*``, ms on
        the default latency ladder): scalar_metrics only keeps the first
        failure's numbers, but a long-lived supervisor sees many — the
        histograms give ``obs report --health`` and GET /metrics the
        recovery-time *trend*, not a one-off."""
        reg = self._registry
        for g in report.generations:
            for f in g.failures:
                reg.observe(
                    "elastic/hist/detect_latency_ms",
                    f.detect_latency_s * 1e3,
                )
            if g.detected_at and g.teardown_done_at:
                reg.observe(
                    "elastic/hist/teardown_ms",
                    (g.teardown_done_at - g.detected_at) * 1e3,
                )
        if report.relaunch_to_first_resumed_step_s is not None:
            reg.observe(
                "elastic/hist/relaunch_to_first_resumed_step_ms",
                report.relaunch_to_first_resumed_step_s * 1e3,
            )
        if report.mttr_s is not None:
            reg.observe("elastic/hist/mttr_ms", report.mttr_s * 1e3)

    def collect_postmortem(
        self,
        report: Optional[ElasticReport] = None,
        out_path: Optional[str] = None,
    ) -> str:
        """Harvest every worker's post-mortem evidence into ONE bundle:
        per (generation, rank) the flight-recorder dump (if the worker
        left one), the final heartbeat payload, and the log tail —
        plus the supervisor's own failure report.  Written atomically
        (tmp + rename) to ``<run_dir>/postmortem.json``; returns the
        path.  Layout: ``{"generations": {"0": {"0": {"flight":
        {...}, "heartbeat": {...}, "log_tail": "..."}}}}``."""
        out_path = out_path or os.path.join(self.run_dir, "postmortem.json")
        gens: Dict[str, Dict[str, Any]] = {}
        for entry in sorted(os.listdir(self.run_dir)):
            if not entry.startswith("gen_"):
                continue
            gen = int(entry.split("_", 1)[1])
            ranks: Dict[str, Any] = {}
            flight_dir = os.path.join(self.run_dir, entry, "flight")
            hb_dir = self.hb_dir(gen)
            rank_ids = set()
            for d in (flight_dir, hb_dir):
                if os.path.isdir(d):
                    for name in os.listdir(d):
                        m = re.match(r"rank_(\d+)\.json$", name)
                        if m:
                            rank_ids.add(int(m.group(1)))
            for rank in sorted(rank_ids):
                rec: Dict[str, Any] = {}
                fpath = os.path.join(flight_dir, f"rank_{rank}.json")
                if os.path.exists(fpath):
                    try:
                        rec["flight"] = _flight.FlightRecorder.read_dump(
                            fpath
                        )
                    except (OSError, ValueError) as e:
                        rec["flight_error"] = f"{type(e).__name__}: {e}"
                _, hb_body = self._hb_state(gen, rank)
                if hb_body:
                    rec["heartbeat"] = hb_body
                tail = self._log_tail(gen, rank)
                if tail:
                    rec["log_tail"] = tail
                ranks[str(rank)] = rec
            gens[str(gen)] = ranks
        bundle: Dict[str, Any] = {
            "t": time.time(),
            "run_dir": self.run_dir,
            "generations": gens,
        }
        if report is not None:
            bundle["report"] = dataclasses.asdict(
                dataclasses.replace(report, postmortem_path=None)
            )
        tmp = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f)
        os.replace(tmp, out_path)
        return out_path

    def _spawn(self, gen: int, world: int, port: int, kv_addr: Optional[str]):
        from torchrec_tpu_torch.parallel import multiprocess as mp

        os.makedirs(self.hb_dir(gen), exist_ok=True)
        os.makedirs(os.path.dirname(self.log_path(gen, 0)), exist_ok=True)
        plan_payload = None
        if self.plan_provider is not None:
            # one provider call per generation: every rank of a
            # generation must resume under the SAME plan
            plan_payload = self.plan_provider(gen, world)
        procs: List[Tuple[int, subprocess.Popen, Any]] = []
        try:
            for rank in range(world):
                env = mp._worker_env(world, rank, port, self.env_extra)
                env.update(
                    {
                        _ENV_RUN_DIR: self.run_dir,
                        _ENV_GEN: str(gen),
                        _ENV_HB_DIR: self.hb_dir(gen),
                        _ENV_HB_INTERVAL: str(self.hb_interval_s),
                        _ENV_WATCHDOG: str(self.watchdog_s),
                    }
                )
                if kv_addr:
                    env[_ENV_KV] = kv_addr
                if plan_payload:
                    env[_ENV_PLAN] = plan_payload
                if self.fault_plan is not None:
                    env[self.fault_plan.ENV] = self.fault_plan.to_env()
                log_f = open(self.log_path(gen, rank), "w")
                try:
                    p = subprocess.Popen(
                        [sys.executable, self.script, *self.args],
                        env=env,
                        stdout=log_f,
                        stderr=subprocess.STDOUT,
                        text=True,
                    )
                except BaseException:
                    log_f.close()
                    raise
                procs.append((rank, p, log_f))
        except BaseException:
            # a failed spawn (fd exhaustion, fork failure, missing
            # script) must not orphan the ranks already launched: they
            # would wedge forever in their first collective
            self._teardown({r: p for r, p, _ in procs})
            for _, _, f in procs:
                f.close()
            raise
        return procs

    def _hb_state(self, gen: int, rank: int):
        """(mtime, payload) of a rank's heartbeat file, or (None, {})."""
        path = os.path.join(self.hb_dir(gen), f"rank_{rank}.json")
        try:
            mtime = os.stat(path).st_mtime
            with open(path) as f:
                return mtime, json.load(f)
        except (OSError, ValueError):
            return None, {}

    #: log-tail signatures of a COLLATERAL death: the worker did not
    #: fail, its peer's death surfaced as a collective/connection error
    #: before the watchdog could fire.  Such ranks keep their slot,
    #: exactly like an EXIT_PEER_FAILURE exit.
    _COLLATERAL_RE = re.compile(
        r"connection reset|peer closed|broken pipe|socket closed|"
        r"connection refused|gloo|all-reduce failed|barriertimeout",
        re.IGNORECASE,
    )

    def _log_tail(self, gen: int, rank: int, nbytes: int = 4096) -> str:
        """Last ``nbytes`` of a worker's log — the death-cause evidence
        the exit classifier reads ('' when unreadable)."""
        try:
            with open(self.log_path(gen, rank), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def _probe_first_resumed(
        self,
        gen: int,
        ranks: Optional[List[int]] = None,
        hb: Optional[Dict[int, Any]] = None,
    ) -> None:
        """Record the moment a relaunched generation applied its first
        step (the tail of the MTTR window), from already-read heartbeat
        state (``hb``) or by reading the given ``ranks`` now."""
        if (
            gen == 0
            or self._detected_at is None
            or self._first_resumed_at is not None
        ):
            return
        if hb is None:
            hb = {r: self._hb_state(gen, r) for r in ranks or []}
        if any(body.get("applied", 0) >= 1 for _, body in hb.values()):
            self._first_resumed_at = time.monotonic()

    def _classify_exit(self, gen: int, rank: int, rc: int) -> str:
        from torchrec_tpu_torch.parallel.multiprocess import (
            _BIND_FAILURE_RE,
        )

        if rc == EXIT_PEER_FAILURE:
            return "peer"
        tail = self._log_tail(gen, rank)
        if re.search(_BIND_FAILURE_RE, tail, re.IGNORECASE):
            # the store's port could not be bound: an infra loss, not a
            # host loss; the relaunch gets a fresh port and the slot
            # survives
            return "infra"
        if self._COLLATERAL_RE.search(tail):
            return "peer"
        return "crash"

    def _run_generation(self, gen: int, world: int) -> GenerationReport:
        import datetime

        import torch.distributed as dist

        from torchrec_tpu_torch.parallel.multiprocess import _TIMEOUT_S

        kv_server = None
        kv_addr = None
        if self.with_kv:
            from torchrec_tpu_torch.dynamic.tcp_kv import TcpKVServer

            kv_server = TcpKVServer()
            kv_addr = f"127.0.0.1:{kv_server.port}"
        try:
            # the generation's process-group store, here for its whole
            # life, on a port the system picks (no probe, no race)
            store = dist.TCPStore(
                "127.0.0.1", 0, None, is_master=True,
                timeout=datetime.timedelta(seconds=_TIMEOUT_S),
                wait_for_workers=False)
            procs = self._spawn(gen, world, store.port, kv_addr)
        except BaseException:
            # _spawn reaped its own partial gang; the KV server (not
            # yet owned by the monitor's finally) still needs stopping
            if kv_server is not None:
                kv_server.stop()
            raise
        rep = GenerationReport(
            gen=gen,
            world=world,
            ok=False,
            pids=[p.pid for _, p, _ in procs],
            started_at=time.monotonic(),
        )
        spawn_wall = time.time()
        deadline = rep.started_at + self.generation_timeout_s
        live = dict((rank, p) for rank, p, _ in procs)
        exited_ok: set = set()
        coordinator_dropped = False
        try:
            while True:
                now = time.monotonic()
                # 1. exits
                for rank in sorted(live):
                    rc = live[rank].poll()
                    if rc is None:
                        continue
                    if rc == 0:
                        exited_ok.add(rank)
                        del live[rank]
                        continue
                    cause = self._classify_exit(gen, rank, rc)
                    if coordinator_dropped:
                        # the supervisor itself dropped the coordinator
                        # (fault injection): the host is innocent
                        cause = "coordinator"
                    mtime, _ = self._hb_state(gen, rank)
                    latency = (
                        time.time() - mtime if mtime is not None else 0.0
                    )
                    rep.failures.append(
                        WorkerFailure(rank, cause, rc, max(0.0, latency))
                    )
                    del live[rank]
                if rep.failures:
                    break
                if not live:
                    # final probe sample before returning: a resumed
                    # generation can run to completion between two
                    # polls on a starved box, and exited workers'
                    # heartbeat files still carry their last state
                    self._probe_first_resumed(gen, sorted(exited_ok))
                    rep.ok = len(exited_ok) == world
                    return rep
                # one heartbeat read per rank per tick, shared by the
                # hang scan, the drop trigger, and the MTTR probe —
                # the supervisor must not out-churn the workers it times
                hb = {
                    r: self._hb_state(gen, r)
                    for r in list(live) + sorted(exited_ok)
                }
                # 2. hangs (heartbeat staleness)
                wall_now = time.time()
                for rank in sorted(live):
                    mtime, _ = hb[rank]
                    if mtime is None:
                        stale = wall_now - spawn_wall
                        limit = self.startup_grace_s
                    else:
                        stale = wall_now - mtime
                        limit = self.hang_timeout_s
                    if stale > limit:
                        rep.failures.append(
                            WorkerFailure(rank, "hang", None, stale)
                        )
                if rep.failures:
                    break
                # 3. scheduled coordinator drop (supervisor-side fault)
                if (
                    kv_server is not None
                    and not coordinator_dropped
                    and self.fault_plan is not None
                ):
                    drop_at = self.fault_plan.coordinator_drop_step(gen)
                    if drop_at is not None and any(
                        hb[r][1].get("step", 0) >= drop_at for r in live
                    ):
                        kv_server.stop(drop_connections=True)
                        coordinator_dropped = True
                # 4. MTTR probe: first applied step of a resumed gen
                self._probe_first_resumed(gen, hb=hb)
                if now > deadline:
                    for rank in sorted(live):
                        rep.failures.append(
                            WorkerFailure(
                                rank, "hang", None,
                                self.generation_timeout_s,
                            )
                        )
                    break
                time.sleep(self.poll_interval_s)
            # failure path: tear down stragglers so nothing is orphaned
            rep.detected_at = time.monotonic()
            if self._detected_at is None:
                self._detected_at = rep.detected_at
            with obs_span("elastic/teardown", gen=gen):
                self._teardown(live)
            rep.teardown_done_at = time.monotonic()
            return rep
        finally:
            self._teardown(live)
            for _, p, log_f in procs:
                log_f.close()
            if kv_server is not None and not coordinator_dropped:
                kv_server.stop()
            del store

    @staticmethod
    def _teardown(live: Dict[int, subprocess.Popen]) -> None:
        """SIGKILL + reap every still-running worker (SIGKILL also
        collects SIGSTOP'd processes); idempotent."""
        for p in live.values():
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in live.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        live.clear()
