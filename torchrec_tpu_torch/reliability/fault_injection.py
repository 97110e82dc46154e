"""Deterministic, seedable fault injectors for reliability testing
(``torchrec_tpu/reliability/fault_injection.py``).

Every injector is schedule-driven (explicit call indices) or seeded
(``np.random.RandomState``), so a failing drill replays bit for bit:

* ``FlakyIterator``: a transient ``IOError`` on scheduled ``next()``
  calls without consuming an item (a retry succeeds);
* ``NaNInjectingStep``: on scheduled calls the step runs on a batch whose
  dense features are NaN, so it writes NaN into every row and dense
  parameter it updates, in place, as a batch whose gradients blow up
  does, and its float metrics are NaN;
* ``CrashMidSaveCheckpointer``: the payload is written, then the process
  "dies" (``SimulatedCrash``) before the atomic commit rename;
* ``FlakyWriteCheckpointer``: the first N write attempts raise a
  transient ``IOError``;
* ``GatedWriteCheckpointer``: the background write waits on an event the
  caller controls, so a drill shows an async save overlapping steps;
* ``corrupt_batch`` / ``CorruptingIterator``: deterministic data
  corruption (out-of-range and negative ids, NaN dense features, lengths
  past the values buffer, unseen ids) for the input guardrails;
* ``simulate_replica_kill``: SIGKILL semantics for an in-process serving
  replica (``inference.serving.InferenceServer`` behind ``inference.
  mesh.ReplicaRouter``): the batching queue stops answering at once;
* ``ProcessFaultPlan``: process-level faults for the elastic runtime
  (``reliability/elastic.py``): ``kill`` (SIGKILL at step N), ``stop``
  (SIGSTOP: a hang only heartbeat staleness shows), ``kill_mid_save``
  (death between the payload write and the PREPARED ack) and
  ``coordinator_drop`` (the supervisor stops the commit-barrier server),
  scheduled per (rank, generation, step) and carried into worker
  processes by one environment variable.  The two migration kinds parse
  and are looked up, and fire once the plan migrator is ported;
* ``CrashMidPublishPublisher``: a delta publisher
  (``inference/freshness.py``) whose scheduled ``publish`` dies inside one
  window of the chunks -> manifest -> CURRENT protocol, or corrupts a
  chunk after publishing (``PUBLISH_CRASH_POINTS``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
from typing import Any, Callable, Iterable, List, Optional, Set

import numpy as np
import torch

from torchrec_tpu_torch.checkpoint import Checkpointer


class SimulatedCrash(BaseException):
    """Stand-in for process death.  Deliberately NOT an ``Exception`` so
    retry loops (which a real crash would also bypass) never absorb it."""


class FlakyIterator:
    """Raise a transient error on scheduled (or seeded-random) ``next()``
    calls without consuming the underlying item.

    fail_on: call indices (0-based, counting every ``next()`` attempt)
        that raise; p/seed: fail each call with probability ``p`` from a
        seeded RNG besides.  ``exc_factory`` builds the raised error from
        the call index.
    """

    def __init__(
        self,
        it: Iterable[Any],
        fail_on: Iterable[int] = (),
        p: float = 0.0,
        seed: int = 0,
        exc_factory: Callable[[int], BaseException] = lambda i: IOError(
            f"injected transient read failure at call {i}"
        ),
    ):
        self._it = iter(it)
        self._fail_on: Set[int] = set(fail_on)
        self._p = p
        self._rng = np.random.RandomState(seed)
        self._exc_factory = exc_factory
        self.calls = 0
        self.failures = 0

    def __iter__(self) -> "FlakyIterator":
        return self

    def __next__(self) -> Any:
        i = self.calls
        self.calls += 1
        if i in self._fail_on or (self._p and self._rng.rand() < self._p):
            self.failures += 1
            raise self._exc_factory(i)
        return next(self._it)


def _poison_metrics(tree: Any) -> Any:
    """NaN every float tensor of the metrics (ints pass, as real
    exploding gradients would leave them)."""
    if isinstance(tree, dict):
        return {k: _poison_metrics(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree * float("nan")
    return tree


class NaNInjectingStep:
    """Wrap a ``(state, batch) -> (state, metrics)`` step so that on
    scheduled calls it runs on the batch with NaN dense features: the
    loss and every gradient are NaN, and the step writes NaN into the
    rows and dense parameters it updates, in place, as a genuinely bad
    batch does; its float metrics come back NaN.  The bad-step guard
    must discard all of it.  (The JAX step returns new arrays, so the
    JAX injector poisons its whole output state instead.)"""

    def __init__(self, step_fn: Callable, inject_on: Iterable[int]):
        self._step = step_fn
        self._inject: Set[int] = set(inject_on)
        self.calls = 0
        self.injected = 0

    def __call__(self, state, batch):
        """Run the wrapped step; poison the batch on scheduled calls."""
        i = self.calls
        self.calls += 1
        if i not in self._inject:
            return self._step(state, batch)
        self.injected += 1
        bad = dataclasses.replace(
            batch, dense_features=batch.dense_features * float("nan"))
        state, metrics = self._step(state, bad)
        return state, _poison_metrics(metrics)


class CrashMidSaveCheckpointer(Checkpointer):
    """Crash (``SimulatedCrash``) after the payload is on disk but before
    the COMMIT-marker rename, on the ``crash_on_save``-th ``save`` call."""

    def __init__(self, directory: str, crash_on_save: int = 0, **kwargs):
        super().__init__(directory, **kwargs)
        self._crash_on_save = crash_on_save
        self._save_calls = 0
        self._crash_next = False

    def save(self, dmp, state, step=None):
        """Count save calls; the scheduled one dies mid-write."""
        self._crash_next = self._save_calls == self._crash_on_save
        self._save_calls += 1
        return super().save(dmp, state, step)

    def _commit(self, tmp, final, step):
        if self._crash_next:
            self._crash_next = False
            raise SimulatedCrash(
                f"simulated crash before committing step {step}")
        super()._commit(tmp, final, step)


class FlakyWriteCheckpointer(Checkpointer):
    """The first ``fail_first_n`` payload writes raise a transient
    ``IOError``: the save's retry with backoff, end to end."""

    def __init__(self, directory: str, fail_first_n: int = 1, **kwargs):
        super().__init__(directory, **kwargs)
        self._remaining_failures = fail_first_n
        self.failed_attempts = 0

    def _write_payload(self, tmp, payload):
        if self._remaining_failures > 0:
            self._remaining_failures -= 1
            self.failed_attempts += 1
            raise IOError("injected transient checkpoint write failure")
        super()._write_payload(tmp, payload)


class GatedWriteCheckpointer(Checkpointer):
    """Every payload write waits until ``gate`` is set (30 s safety
    timeout), so a drill can show steps running while an async save is
    still in flight."""

    def __init__(
        self,
        directory: str,
        gate: Optional[threading.Event] = None,
        **kwargs,
    ):
        super().__init__(directory, **kwargs)
        self.gate = gate if gate is not None else threading.Event()
        self.writes_started = 0

    def _write_payload(self, tmp, payload):
        self.writes_started += 1
        if not self.gate.wait(timeout=30):
            raise IOError("gated checkpoint write timed out")
        super()._write_payload(tmp, payload)


# ---------------------------------------------------------------------------
# Serving-mesh fault injection (replica death, torn delta publishes).
# ---------------------------------------------------------------------------

PUBLISH_CRASH_POINTS = (
    # die after every chunk landed, before the manifest: chunks alone are
    # invisible to subscribers
    "before_manifest",
    # die after the manifest, before the CURRENT adoption signal: a
    # complete generation nobody adopts
    "before_current",
    # publish everything, then flip bytes inside one published chunk: the
    # subscriber's CRC pass must refuse the generation
    "corrupt_chunk",
)


class CrashMidPublishPublisher:
    """A ``DeltaPublisher`` whose ``crash_on``-th ``publish`` dies
    (``SimulatedCrash``) inside the ``crash_point`` window of the chunks ->
    manifest -> CURRENT protocol (``PUBLISH_CRASH_POINTS``).  Built by
    composition, so the inner publisher's protocol methods stay the one
    implementation under test."""

    def __init__(self, inner, crash_point: str, crash_on: int = 0):
        if crash_point not in PUBLISH_CRASH_POINTS:
            raise ValueError(
                f"unknown publish crash point {crash_point!r}; expected "
                f"one of {PUBLISH_CRASH_POINTS}")
        self.inner = inner
        self.crash_point = crash_point
        self.crash_on = int(crash_on)
        self.publish_calls = 0

    @property
    def generation(self) -> int:
        """The inner publisher's adoptable generation."""
        return self.inner.generation

    def publish(self, step, deltas, vocab_events=None):
        """Publish through the inner protocol, dying (or corrupting) in the
        scheduled call's crash window."""
        crash_now = self.publish_calls == self.crash_on
        self.publish_calls += 1
        if not crash_now:
            return self.inner.publish(step, deltas, vocab_events)
        inner = self.inner
        orig_manifest = inner._write_manifest
        orig_current = inner._publish_current

        def die(*a, **k):
            raise SimulatedCrash(
                f"simulated publisher crash {self.crash_point} "
                f"(generation {inner.generation + 1})")

        try:
            if self.crash_point == "before_manifest":
                inner._write_manifest = die
            elif self.crash_point == "before_current":
                inner._publish_current = die
            if self.crash_point == "corrupt_chunk":
                gen = inner.publish(step, deltas, vocab_events)
                self._corrupt_one_chunk(gen)
                return gen
            return inner.publish(step, deltas, vocab_events)
        finally:
            inner._write_manifest = orig_manifest
            inner._publish_current = orig_current

    def _corrupt_one_chunk(self, gen: int) -> None:
        """Flip bytes in the middle of the generation's first chunk: a
        published-then-damaged file whose manifest CRC no longer
        matches."""
        names = sorted(n for n in os.listdir(self.inner.directory)
                       if n.startswith(f"delta.g{gen}."))
        assert names, f"generation {gen} published no chunks to corrupt"
        path = os.path.join(self.inner.directory, names[0])
        with open(path, "r+b") as f:
            f.seek(max(0, os.path.getsize(path) // 2))
            f.write(b"\xde\xad\xbe\xef")



def simulate_replica_kill(server) -> None:
    """SIGKILL semantics for an in-process serving replica: the batching
    queue shuts down at once (in-flight requests are never answered, their
    waiters get ``QueueStopped``; new enqueues are refused), with no drain
    and no executor join, which is what a killed process looks like from
    the router's side.  The executor threads end at their next dequeue."""
    server._running = False
    server._queue.shutdown()


# ---------------------------------------------------------------------------
# Process-level fault injection (the elastic runtime).
# ---------------------------------------------------------------------------

PROCESS_FAULT_KINDS = (
    "kill",               # SIGKILL at a step boundary: a lost host
    "stop",               # SIGSTOP: a hang (heartbeats go stale)
    "kill_mid_save",      # SIGKILL after the payload write, before the ack
    "coordinator_drop",   # the supervisor stops the commit-barrier server
    # SIGKILL inside an online plan migration's windows (mid-reshard,
    # mid-validation); ``step`` is ignored, the phase is the window.  They
    # parse now; they fire once the plan migrator is ported.
    "kill_mid_reshard",
    "kill_mid_validate",
)


@dataclasses.dataclass(frozen=True)
class ProcessFault:
    """One scheduled process fault: fires for ``rank`` in launch
    generation ``gen`` when the worker reaches global step ``step``
    (``rank`` is ignored for ``coordinator_drop``, which the supervisor
    executes)."""

    rank: int
    step: int
    kind: str
    gen: int = 0

    def __post_init__(self):
        if self.kind not in PROCESS_FAULT_KINDS:
            raise ValueError(
                f"unknown process fault kind {self.kind!r}; "
                f"expected one of {PROCESS_FAULT_KINDS}")


class ProcessFaultPlan:
    """A deterministic schedule of process faults, carried into worker
    processes by the environment (``ENV``) so that the
    ``ElasticSupervisor``'s workers replay it.

    Workers call ``maybe_fire(rank, gen, step)`` at each step boundary
    (``ElasticWorkerContext.step_scope``); ``kill_mid_save`` is wired
    into the commit barrier instead (the kill must land inside the save's
    crash window); ``coordinator_drop`` runs in the supervisor's monitor
    loop.  ``seeded()`` draws a reproducible plan for chaos sweeps."""

    ENV = "TORCHREC_ELASTIC_FAULTS"

    def __init__(self, faults: Iterable[ProcessFault] = ()):
        self.faults: List[ProcessFault] = list(faults)
        self.fired: List[ProcessFault] = []

    def to_env(self) -> str:
        return json.dumps([dataclasses.asdict(f) for f in self.faults])

    @classmethod
    def from_env(cls, env_var: Optional[str] = None) -> "ProcessFaultPlan":
        raw = os.environ.get(env_var or cls.ENV, "")
        if not raw:
            return cls()
        return cls(ProcessFault(**d) for d in json.loads(raw))

    @classmethod
    def seeded(
        cls,
        seed: int,
        world: int,
        max_step: int,
        kinds: Iterable[str] = ("kill",),
        n_faults: int = 1,
    ) -> "ProcessFaultPlan":
        """``n_faults`` faults drawn over (rank, step < max_step, kind),
        all in generation 0, from a seeded RNG."""
        rng = np.random.RandomState(seed)
        kinds = list(kinds)
        return cls(
            ProcessFault(
                rank=int(rng.randint(world)),
                step=int(rng.randint(1, max(2, max_step))),
                kind=kinds[int(rng.randint(len(kinds)))],
            )
            for _ in range(n_faults)
        )

    def maybe_fire(self, rank: int, gen: int, step: int) -> None:
        """Fire any boundary fault scheduled for (rank, gen, step):
        ``kill`` never returns; ``stop`` freezes this process until a
        SIGCONT or SIGKILL (the supervisor's teardown)."""
        for f in self.faults:
            if (f.kind in ("kill", "stop") and f.rank == rank
                    and f.gen == gen and f.step == step):
                self.fired.append(f)
                sys.stderr.write(f"fault injection: {f.kind} rank {rank} at "
                                 f"step {step} (gen {gen})\n")
                sys.stderr.flush()
                os.kill(os.getpid(), signal.SIGKILL if f.kind == "kill"
                        else signal.SIGSTOP)

    def kill_mid_save_step(self, rank: int, gen: int) -> Optional[int]:
        """The step whose PREPARED ack this rank dies before, if any
        (read by ``TcpKVCommitBarrier``)."""
        for f in self.faults:
            if f.kind == "kill_mid_save" and f.rank == rank and f.gen == gen:
                return f.step
        return None

    def migration_kill_phase(self, rank: int, gen: int) -> Optional[str]:
        """The migration phase ("reshard" / "validate") this rank is to
        die inside, if scheduled."""
        for f in self.faults:
            if (f.kind in ("kill_mid_reshard", "kill_mid_validate")
                    and f.rank == rank and f.gen == gen):
                return f.kind[len("kill_mid_"):]
        return None

    def coordinator_drop_step(self, gen: int) -> Optional[int]:
        """The step at which the supervisor stops the KV server in
        generation ``gen``, if scheduled."""
        for f in self.faults:
            if f.kind == "coordinator_drop" and f.gen == gen:
                return f.step
        return None


# ---------------------------------------------------------------------------
# Data corruption (the input guardrails).  Host-side copies of a Batch,
# deterministic per (mode, seed).
# ---------------------------------------------------------------------------

CORRUPTION_MODES = (
    "oob_ids",          # a real id pushed past its table's num_embeddings
    "negative_ids",     # a real id made negative
    "nan_dense",        # NaNs scattered into the dense features
    "truncated_values", # lengths claim more ids than the buffer holds
    "unseen_ids",       # vocab drift: valid-range ids beyond the admitted set
)


def corrupt_batch(batch, mode: str, seed: int = 0,
                  id_bound: Optional[int] = None):
    """A data-corrupted copy of a host batch (deterministic).

    ``mode`` is one of ``CORRUPTION_MODES``; the corruption hits the first
    key with a real id (so a diagnosis can name it).  ``oob_ids`` adds a
    large offset to one real id; ``negative_ids`` negates one;
    ``nan_dense`` poisons about 10% of the dense entries;
    ``truncated_values`` makes the first key's first length exceed the
    key's capacity; ``unseen_ids`` rewrites about 25% of the key's ids to
    ids never admitted: drawn in range from ``[id_bound // 2, id_bound)``
    when ``id_bound`` (the table's rows) is given, else offset out of
    range like ``oob_ids``."""
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}")
    rng = np.random.RandomState(seed)
    kjt = batch.sparse_features
    values = kjt.values().cpu().numpy().copy()
    lengths = kjt.lengths().cpu().numpy().copy()
    dense = batch.dense_features.cpu().numpy().copy()
    lo = kjt._length_offsets()
    co = kjt.cap_offsets()

    def first_occupied_key():
        for f in range(kjt.num_keys):
            occ = int(lengths[lo[f]: lo[f + 1]].sum())
            if occ > 0:
                return f, occ
        raise ValueError("corrupt_batch needs at least one real id")

    if mode == "oob_ids":
        f, occ = first_occupied_key()
        slot = co[f] + rng.randint(occ)
        values[slot] = values[slot] + 1_000_000_000
    elif mode == "negative_ids":
        f, occ = first_occupied_key()
        slot = co[f] + rng.randint(occ)
        values[slot] = -1 - int(values[slot])
    elif mode == "unseen_ids":
        f, occ = first_occupied_key()
        k = max(1, occ // 4)
        sel = co[f] + rng.choice(occ, size=k, replace=False)
        if id_bound is not None:
            values[sel] = rng.randint(max(1, id_bound // 2), id_bound, size=k)
        else:
            values[sel] = values[sel] + 1_000_000_000
    elif mode == "nan_dense":
        mask = rng.rand(*dense.shape) < 0.1
        mask.flat[rng.randint(dense.size)] = True  # at least one
        dense[mask] = np.nan
    else:  # truncated_values
        lengths[lo[0]] = kjt.caps[0] + 1 + lengths[lo[0]]
    new_kjt = type(kjt)(
        kjt.keys(), torch.from_numpy(values), torch.from_numpy(lengths),
        kjt.weights_or_none(), stride=kjt.stride(), caps=kjt.caps,
        # a VBE batch stays one: its layout is what the guardrails read
        stride_per_key=kjt._stride_per_key,
        inverse_indices=kjt.inverse_indices_or_none(),
    )
    return dataclasses.replace(batch, dense_features=torch.from_numpy(dense),
                               sparse_features=new_kjt)


class CorruptingIterator:
    """Corrupt scheduled items of a batch stream.

    corrupt_on: item index -> corruption mode (0-based, counting every
        yielded item); other items pass untouched.  Each corruption is
        seeded with ``seed + index``."""

    def __init__(self, it: Iterable[Any], corrupt_on, seed: int = 0):
        self._it = iter(it)
        self._corrupt_on = dict(corrupt_on)
        self._seed = seed
        self.calls = 0
        self.corrupted = 0

    def __iter__(self) -> "CorruptingIterator":
        return self

    def __next__(self) -> Any:
        i = self.calls
        self.calls += 1
        item = next(self._it)
        mode = self._corrupt_on.get(i)
        if mode is None:
            return item
        self.corrupted += 1
        return corrupt_batch(item, mode, seed=self._seed + i)
