"""Fault-tolerant serving mesh: health-checked replica routing
(``torchrec_tpu/inference/mesh.py``, host code ported as it is).

:class:`ReplicaRouter` fronts N ``InferenceServer`` /
``BucketedInferenceServer`` replicas (anything with the ``predict_ex``
contract) with four stacked defenses:

* **health probes** — a background prober samples per-replica liveness +
  batching-queue depth every ``probe_interval_s`` and exports
  ``mesh/<replica>/healthy`` / ``queue_depth`` gauges; routing only
  considers live replicas and prefers the shallowest queue
  (join-the-shortest-queue, round-robin on ties);
* **deadline + retry-with-backoff** — each request carries one overall
  deadline; a failed attempt (timeout, executor NaN, dead queue) retries
  on a DIFFERENT replica after an exponential backoff clipped to the
  remaining budget.  A :class:`~.serving.QueueStopped` attempt skips the
  backoff entirely: a stopped queue is a dead replica, not a slow one;
* **hedging** — optionally, a second copy of a still-unanswered request
  fires on another replica once the first has been in flight for the
  router's LIVE p99 (read from the ``mesh/request_latency_ms`` registry
  histogram); first answer wins, the loser is abandoned;
* **circuit breaker** — ``failure_threshold`` CONSECUTIVE failures eject
  a replica from routing; reinstatement is probe-gated: only after
  ``cooldown_s`` AND a successful liveness probe does the breaker close
  again.

When NO replica is routable, the router degrades through the same
contract ``predict_ex`` uses for bad input: a ``(fallback_score,
degraded=True, reason)`` answer instead of an exception.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from torchrec_tpu_torch.inference.serving import QueueStopped
from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.utils.profiling import counter_key

__all__ = [
    "CircuitBreaker",
    "ReplicaRouter",
    "AllReplicasDown",
]


class AllReplicasDown(RuntimeError):
    """Raised by :meth:`ReplicaRouter.predict` (strict mode) when no
    replica is routable; the default ``predict_ex`` path degrades to a
    fallback answer instead."""


class CircuitBreaker:
    """Per-replica ejection state: ``failure_threshold`` CONSECUTIVE
    failures open the breaker (the replica leaves routing); after
    ``cooldown_s`` the breaker is probe-eligible and a successful
    liveness probe closes it again.  Not a half-open request trickle —
    reinstatement is gated on the PROBE, so a request is never spent
    discovering a still-dead replica."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 0.5):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        # request threads fold failures while the probe thread
        # reinstates: without the lock two racing record_failure calls
        # can both observe the threshold crossing (double-counted
        # ejection) or lose an increment and never open the breaker
        self._mu = threading.Lock()
        self._consecutive = 0
        self._open = False
        self._opened_at = 0.0

    @property
    def open(self) -> bool:
        """True while the replica is ejected from routing."""
        return self._open

    def record_success(self) -> None:
        """A completed request resets the consecutive-failure run."""
        with self._mu:
            self._consecutive = 0

    def record_failure(self) -> bool:
        """Fold one failed attempt; returns True when THIS failure
        crossed the threshold and opened the breaker (the ejection
        edge, so callers count ejections, not failures)."""
        with self._mu:
            self._consecutive += 1
            if (
                not self._open
                and self._consecutive >= self.failure_threshold
            ):
                self._open = True
                self._opened_at = time.monotonic()
                return True
            return False

    def probe_eligible(self) -> bool:
        """Open AND past the cooldown — the prober may now reinstate."""
        return self._open and (
            time.monotonic() - self._opened_at >= self.cooldown_s
        )

    def reinstate(self) -> None:
        """Close the breaker (a cooldown-gated probe succeeded)."""
        with self._mu:
            self._open = False
            self._consecutive = 0


def _default_probe(server) -> Tuple[bool, int]:
    """Liveness + queue depth of an in-process replica: alive means the
    executor loop is running and the batching queue still accepts work;
    depth is the queue's outstanding-request count (the native queue
    reports only un-formed requests — close enough for shortest-queue
    routing)."""
    alive = bool(getattr(server, "_running", False))
    q = getattr(server, "_queue", None)
    depth = 0
    if q is not None:
        if getattr(q, "_shutdown", False):
            alive = False
        if hasattr(q, "outstanding"):
            try:
                depth = int(q.outstanding())
            except Exception:
                alive, depth = False, 0
    return alive, depth


class _Attempt:
    """One in-flight try of a request on one replica (runs on its own
    daemon thread; an abandoned attempt finishes in the background and
    its late answer is simply never consumed).  ``is_hedge`` marks the
    p99-timer duplicate, so win accounting can tell a hedge win from a
    retry win."""

    __slots__ = ("replica", "kind", "payload", "t0", "elapsed_s",
                 "is_hedge")

    def __init__(self, replica: str, is_hedge: bool = False):
        self.replica = replica
        self.kind = ""  # "ok" | "err", set exactly once
        self.payload = None
        self.t0 = time.monotonic()
        self.elapsed_s = 0.0
        self.is_hedge = is_hedge


class ReplicaRouter:
    """Health-checked router over named replica servers — see the
    module docstring for the defense stack.

    ``replicas`` maps name -> server (``predict_ex`` contract);
    ``deadline_us`` is the default per-request budget;
    ``max_attempts`` bounds tries per request (1 primary +
    retries/hedges); ``backoff_s`` seeds the exponential retry backoff;
    ``hedge`` enables the p99 hedged second request and
    ``hedge_min_s`` floors its delay until the latency histogram has
    ``hedge_warmup`` samples; ``failure_threshold``/``cooldown_s``
    parameterize each replica's :class:`CircuitBreaker`;
    ``probe_interval_s`` paces the health prober; ``fallback_score``
    is the degraded all-replicas-down answer; ``probe_fn`` overrides
    the liveness probe (tests inject partitions); ``metrics`` is the
    shared registry the ``mesh/*`` families land in."""

    # the knob surface IS the routing policy (deadline/retry/hedge/
    # breaker/probe); a config dataclass would rename the same knobs
    def __init__(  # graft-check: disable=ctor-too-wide
        self,
        replicas: Mapping[str, object],
        metrics: Optional[MetricsRegistry] = None,
        deadline_us: int = 5_000_000,
        max_attempts: int = 3,
        backoff_s: float = 0.01,
        hedge: bool = True,
        hedge_min_s: float = 0.01,
        hedge_warmup: int = 32,
        failure_threshold: int = 3,
        cooldown_s: float = 0.5,
        probe_interval_s: float = 0.05,
        fallback_score: float = 0.0,
        probe_fn: Optional[Callable] = None,
    ):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas: Dict[str, object] = dict(replicas)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.deadline_us = int(deadline_us)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.hedge = bool(hedge)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_warmup = int(hedge_warmup)
        self.fallback_score = float(fallback_score)
        self.probe_interval_s = float(probe_interval_s)
        self._probe = probe_fn if probe_fn is not None else (
            lambda name, srv: _default_probe(srv)
        )
        self._breakers: Dict[str, CircuitBreaker] = {
            name: CircuitBreaker(failure_threshold, cooldown_s)
            for name in self.replicas
        }
        # probe-published liveness + queue depth; routing reads these
        # instead of probing inline (a dead replica must not cost every
        # request a probe, and an injected probe_fn's view — e.g. a
        # simulated partition — must be the one routing believes)
        self._alive: Dict[str, bool] = {n: True for n in self.replicas}
        self._depth: Dict[str, int] = {n: 0 for n in self.replicas}
        self._lock = threading.Lock()
        self._rr = 0  # round-robin tiebreak cursor
        self._latency_count = 0
        self._hedge_delay_s = self.hedge_min_s
        self._prober: Optional[threading.Thread] = None
        self._probing = False
        self._pool = None  # lazily-built shared attempt-worker pool

    def _attempt_pool(self):
        """Shared daemon worker pool for request attempts — a thread
        spawn per attempt would put ~100us of creation plus teardown
        churn on every routed request.  Sized generously (64 + 8 per
        replica): an abandoned attempt parks a worker until its budget
        expires, and a too-small pool would silently queue hedges
        behind blocked primaries."""
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=64 + 8 * len(self.replicas),
                    thread_name_prefix="mesh-attempt",
                )
            return self._pool

    # -- health probing ------------------------------------------------------

    def probe_once(self) -> Dict[str, bool]:
        """One probe sweep over every replica: refresh the liveness map
        and the ``mesh/<replica>/healthy``/``queue_depth`` gauges, and
        reinstate cooled-down breakers whose probe succeeded.  Returns
        the liveness map (tests drive this directly; ``start_probes``
        runs it on the background thread)."""
        for name, srv in self.replicas.items():
            try:
                alive, depth = self._probe(name, srv)
            except Exception:
                alive, depth = False, 0
            with self._lock:
                was_alive = self._alive[name]
                self._alive[name] = alive
                self._depth[name] = depth
                br = self._breakers[name]
                if alive and br.probe_eligible():
                    br.reinstate()
                    self.metrics.counter("mesh/reinstated_count")
            if was_alive and not alive:
                # liveness-loss edge: the probe pulled the replica out
                # of routing before (or without) the breaker tripping —
                # both paths count as an ejection-from-routing event
                self.metrics.counter("mesh/probe_dead_count")
            self.metrics.gauge(
                counter_key("mesh", name, "healthy"), 1.0 if alive else 0.0
            )
            self.metrics.gauge(
                counter_key("mesh", name, "queue_depth"), float(depth)
            )
            self.metrics.gauge(
                counter_key("mesh", name, "ejected"),
                1.0 if self._breakers[name].open else 0.0,
            )
        with self._lock:
            return dict(self._alive)

    def _probe_loop(self) -> None:
        while self._probing:
            try:
                self.probe_once()
            except Exception:
                # a broken probe sweep must be visible, not fatal: the
                # router keeps serving on the last-known liveness map
                self.metrics.counter("mesh/probe_error_count")
            time.sleep(self.probe_interval_s)

    def start_probes(self) -> None:
        """Start the background health prober (idempotent)."""
        if self._probing:
            return
        self._probing = True
        self._prober = threading.Thread(
            target=self._probe_loop, name="mesh-prober", daemon=True
        )
        self._prober.start()

    def stop(self) -> None:
        """Stop the prober and release the attempt pool; the replicas
        are not touched (they are owned by whoever built them — a
        router restart must not take the fleet down with it)."""
        self._probing = False
        if self._prober is not None:
            self._prober.join(timeout=2)
            self._prober = None
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- routing -------------------------------------------------------------

    def routable(self) -> List[str]:
        """Replicas currently eligible for traffic: probed alive and
        breaker closed."""
        with self._lock:
            return [
                n
                for n in self.replicas
                if self._alive[n] and not self._breakers[n].open
            ]

    def _pick(self, exclude: Sequence[str]) -> Optional[str]:
        """Join-the-shortest-queue among routable replicas not in
        ``exclude`` (round-robin on depth ties); None when no candidate
        remains.  Falls back to an excluded-but-routable replica only
        when nothing else exists — retrying the same replica beats
        degrading when it is the last one standing."""
        cands = [n for n in self.routable() if n not in exclude]
        if not cands:
            cands = self.routable()
        if not cands:
            return None
        with self._lock:
            # the probe's published depth map IS the routing input —
            # one depth-reading implementation, and an injected
            # probe_fn's view (a simulated partition) stays
            # authoritative
            depths = [self._depth.get(n, 0) for n in cands]
            best = min(depths)
            tied = [n for n, d in zip(cands, depths) if d == best]
            self._rr += 1
            return tied[self._rr % len(tied)]

    def _hedge_delay(self) -> float:
        """The live p99 of ``mesh/request_latency_ms`` (floored by
        ``hedge_min_s``) — recomputed every 32 successes so the
        histogram clone/interpolate cost stays off the per-request
        path."""
        with self._lock:
            if (
                self._latency_count < self.hedge_warmup
                or self._latency_count % 32
            ):
                return self._hedge_delay_s
        try:
            (p99,) = self.metrics.quantiles(
                "mesh/request_latency_ms", (0.99,)
            )
        except KeyError:
            # a success incremented the count but its observe() hasn't
            # landed yet (warmup ~0 race): keep the cached delay
            return self._hedge_delay_s
        delay = max(self.hedge_min_s, float(p99) * 1e-3)
        with self._lock:
            self._hedge_delay_s = delay
        return delay

    # -- the request path ----------------------------------------------------

    def _launch(
        self,
        name: str,
        dense: np.ndarray,
        ids_per_feature: Sequence[np.ndarray],
        budget_us: int,
        done: threading.Event,
        sink: List[_Attempt],
        sink_lock: threading.Lock,
        is_hedge: bool = False,
    ) -> None:
        att = _Attempt(name, is_hedge=is_hedge)
        srv = self.replicas[name]

        def run():
            try:
                out = srv.predict_ex(
                    dense, ids_per_feature, timeout_us=budget_us
                )
            except ValueError as e:
                # the REQUEST is malformed (wire-schema validation),
                # not the replica: retrying elsewhere reproduces it, so
                # it must neither trip the breaker nor burn attempts —
                # it propagates to the caller as-is.  AssertionError is
                # deliberately NOT here: a replica-internal invariant
                # blowing up on a well-formed request is a replica
                # failure and must fail over, not crash the caller
                att.kind, att.payload = "client_err", e
            except Exception as e:  # timeout / QueueStopped / executor
                att.kind, att.payload = "err", e
            else:
                if not np.isfinite(out[0]):
                    # an executor crash NaN-fails its batch; to the
                    # mesh that is a failed attempt, not an answer
                    att.kind = "err"
                    att.payload = RuntimeError(
                        f"replica {name} answered non-finite {out[0]!r}"
                    )
                else:
                    att.kind, att.payload = "ok", out
            att.elapsed_s = time.monotonic() - att.t0
            with sink_lock:
                sink.append(att)
            done.set()

        self._attempt_pool().submit(run)

    def _fail_attempt(self, att: _Attempt) -> None:
        """Book one failed attempt against its replica's breaker."""
        self.metrics.counter("mesh/attempt_failure_count")
        self.metrics.counter(
            counter_key("mesh", att.replica, "failure_count")
        )
        with self._lock:
            newly_open = self._breakers[att.replica].record_failure()
        if newly_open:
            self.metrics.counter("mesh/ejected_count")
            self.metrics.gauge(
                counter_key("mesh", att.replica, "ejected"), 1.0
            )

    def _degraded_fallback(self, reason: str):
        self.metrics.counter("mesh/degraded_fallback_count")
        return self.fallback_score, True, reason

    def predict_ex(
        self,
        dense: np.ndarray,
        ids_per_feature: Sequence[np.ndarray],
        timeout_us: Optional[int] = None,
    ):
        """Route one request; returns ``(score, degraded, reason)``
        exactly like ``InferenceServer.predict_ex`` — with the mesh's
        own degradation added on top: when no replica is routable (or
        every attempt failed and none remain), the answer is
        ``(fallback_score, True, "mesh: ...")`` instead of an
        exception.  Raises ``TimeoutError`` only when the deadline
        expired while replicas were still available (the caller's SLO
        problem, not an availability one)."""
        t_start = time.monotonic()
        deadline = t_start + (
            timeout_us if timeout_us is not None else self.deadline_us
        ) * 1e-6
        self.metrics.counter("mesh/request_count")
        sink: List[_Attempt] = []
        sink_lock = threading.Lock()
        done = threading.Event()
        tried: List[str] = []
        consumed = 0
        inflight = 0
        failures = 0
        hedged = False

        last_launch_t = time.monotonic()

        def launch_on(name: str, is_hedge: bool = False) -> None:
            nonlocal inflight, last_launch_t
            tried.append(name)
            budget = max(1000, int((deadline - time.monotonic()) * 1e6))
            self._launch(
                name, dense, ids_per_feature, budget, done, sink,
                sink_lock, is_hedge=is_hedge,
            )
            inflight += 1
            last_launch_t = time.monotonic()

        first = self._pick(exclude=())
        if first is None:
            return self._degraded_fallback(
                "mesh: no routable replica (all dead or ejected); "
                "served fallback score"
            )
        launch_on(first)

        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            wait = deadline - now
            if (
                self.hedge
                and not hedged
                and inflight == 1
                and len(tried) < self.max_attempts
            ):
                # anchored to the CURRENT attempt's launch, not the
                # request start: a retry after a slow failure must earn
                # its own p99 in flight before being duplicated, or a
                # failure storm doubles backend load exactly when
                # capacity is lost
                hedge_at = last_launch_t + self._hedge_delay()
                if now >= hedge_at:
                    cand = self._pick(exclude=tried)
                    if cand is not None and cand not in tried:
                        self.metrics.counter("mesh/hedge_count")
                        launch_on(cand, is_hedge=True)
                    hedged = True
                else:
                    wait = min(wait, hedge_at - now)
            if not done.wait(timeout=wait):
                continue
            done.clear()
            with sink_lock:
                new, consumed = sink[consumed:], len(sink)
            for att in new:
                inflight -= 1
                if att.kind == "client_err":
                    raise att.payload
                if att.kind == "ok":
                    return self._settle_success(att, t_start, tried)
                self._fail_attempt(att)
                failures += 1
                if isinstance(att.payload, QueueStopped):
                    # dead replica, not a slow one: no backoff
                    self.metrics.counter("mesh/failover_count")
                elif failures < self.max_attempts and inflight == 0:
                    # interruptible backoff: a sibling attempt's answer
                    # arriving mid-sleep sets `done`, ending the wait
                    # so the answer is consumed instead of sleeping
                    # past the deadline on top of it
                    done.wait(
                        min(
                            self.backoff_s * (2 ** (failures - 1)),
                            max(0.0, deadline - time.monotonic()),
                        )
                    )
                if (
                    inflight == 0
                    and len(tried) < self.max_attempts
                ):
                    # retry only when nothing is still in flight: a
                    # surviving sibling may be about to answer, and
                    # stacking a third attempt on top of it doubles
                    # backend load exactly when capacity is short
                    cand = self._pick(exclude=tried)
                    if cand is not None:
                        self.metrics.counter("mesh/retry_count")
                        launch_on(cand)
            if inflight == 0 and len(tried) >= self.max_attempts:
                # out of attempt budget with only failures: degraded
                # answer, not an exception — the flag says what happened
                return self._degraded_fallback(
                    f"mesh: all {len(tried)} attempts failed; served "
                    "fallback score"
                )
            if inflight == 0 and self._pick(exclude=tried) is None:
                return self._degraded_fallback(
                    "mesh: every routable replica failed this request; "
                    "served fallback score"
                )
        # deadline reached: an answer may have landed in the sink after
        # the last consume (e.g. during a backoff wait) — it must win
        # over a timeout
        with sink_lock:
            late = sink[consumed:]
        for att in late:
            if att.kind == "ok":
                return self._settle_success(att, t_start, tried)
        if inflight == 0 and not self.routable():
            return self._degraded_fallback(
                "mesh: no routable replica remained; served fallback "
                "score"
            )
        self.metrics.counter("mesh/request_timeout_count")
        raise TimeoutError(
            f"mesh predict exhausted its deadline after {len(tried)} "
            f"attempt(s) across {sorted(set(tried))}"
        )

    def _settle_success(self, att: _Attempt, t_start: float, tried):
        """Book a winning attempt (breaker, latency histogram, win
        attribution) and hand back its payload."""
        with self._lock:
            self._breakers[att.replica].record_success()
            self._latency_count += 1
        self.metrics.observe(
            "mesh/request_latency_ms",
            (time.monotonic() - t_start) * 1e3,
        )
        if len(tried) > 1 and att.replica == tried[-1]:
            # a later attempt beat (or outlived) the primary: hedges
            # and retries both count here
            self.metrics.counter("mesh/secondary_win_count")
        if att.is_hedge:
            # ONLY the p99-timer duplicate itself winning counts — a
            # retry winning after a failed hedge must not inflate
            # hedging effectiveness
            self.metrics.counter("mesh/hedge_win_count")
        return att.payload

    def predict(
        self,
        dense: np.ndarray,
        ids_per_feature: Sequence[np.ndarray],
        timeout_us: Optional[int] = None,
        strict: bool = False,
    ) -> float:
        """Score-only routing.  ``strict=True`` turns the mesh's
        degraded fallback into :class:`AllReplicasDown` for callers
        that must not consume a fabricated score."""
        score, degraded, reason = self.predict_ex(
            dense, ids_per_feature, timeout_us
        )
        if strict and degraded and reason and reason.startswith("mesh:"):
            raise AllReplicasDown(reason)
        return score
