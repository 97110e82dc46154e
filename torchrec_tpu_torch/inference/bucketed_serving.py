"""Bucketed serving programs and request dedup
(``torchrec_tpu/inference/bucketed_serving.py``, less the hot-row cache).

The base ``InferenceServer`` runs every formed batch at the full
``max_batch`` shapes, so a 3-request batch pays the lookups, the dense
layers and the host-to-card copies of a 64-request one.  Here:

* **Bucketed serving programs** — a bounded family of programs keyed by
  ``(batch-size rung, per-feature id-capacity rung)`` from the geometric
  ``bucket_ladder``.  A formed batch dispatches to the smallest
  dominating signature; once ``max_programs`` is reached, new signatures
  round UP to an admitted dominating signature (or the reserved
  full-capacity one).  Padding contributes exactly +0.0 under SUM
  pooling, so the pooled embeddings are bitwise those of the full-pad
  program.  A program is the serving module bound to one signature's
  padded shapes; ``warmup`` runs it once at those shapes.  It runs
  eagerly (no capture per signature), so a program holds no state: the
  cache keeps the signatures run, for the program bound and counters.

* **Request dedup** — ``dedup=True`` (or ``"xla_dedup"`` /
  ``"pallas_dedup"``, the JAX package's kernel kinds) serves through the
  port's dedup lookup kernels (B5 for int8/int4/int2 tables, B4 for
  FP16/BF16), so an id repeated across coalesced requests is deduplicated
  before its row is read.  The kernel is picked per program through
  ``ServingModule.with_lookup_kernel`` (the same tables, shared): there
  is no process-wide kernel switch.  The dedup kernels are bitwise the
  full-pad ones.

The hot-row serving cache (``HotRowServingCache``) is built on the tiered
storage and dynamic vocabularies, which are not ported yet: ``hot_rows=``
raises.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.inference.serving import (
    _BATCH_SIZE_BUCKETS,
    InferenceServer,
)
from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, bucketed_cap

__all__ = [
    "ServingBucketConfig",
    "BucketedServingCache",
    "BucketedInferenceServer",
]

# the JAX package's dedup kernel kinds; each maps to the port's dedup
# lookup kernels
DEDUP_KINDS = ("xla_dedup", "pallas_dedup")

Signature = Tuple[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class ServingBucketConfig:
    """Serving-side capacity-bucketing policy.

    ``batch_floor``/``batch_growth`` ladder the BATCH-SIZE axis;
    ``id_floor``/``id_growth`` ladder each feature's TOTAL id capacity
    within the chosen batch rung.  ``max_programs`` bounds the distinct
    programs: the full-capacity signature owns a reserved slot, and
    beyond the bound new signatures round UP to an admitted dominating
    signature."""

    batch_floor: int = 1
    batch_growth: float = 2.0
    id_floor: int = 8
    id_growth: float = 2.0
    max_programs: int = 16

    @staticmethod
    def full_pad() -> "ServingBucketConfig":
        """The degenerate single-rung policy: every batch rounds up to
        ``max_batch`` and full per-feature capacity (the full-pad
        program, in the same machinery)."""
        return ServingBucketConfig(
            batch_floor=1 << 30, id_floor=1 << 30, max_programs=1
        )


def _dedup_kernel(dedup) -> Optional[str]:
    """The JAX ``dedup`` argument (a bool or a dedup kernel kind) as the
    port's lookup kernel: ``"dedup"``, or None (the serving module's
    own)."""
    if isinstance(dedup, str):
        if dedup not in DEDUP_KINDS:
            raise ValueError(
                f"dedup={dedup!r} is not a dedup kernel kind (expected "
                f"one of {DEDUP_KINDS}, or a bool)")
        return "dedup"
    return "dedup" if dedup else None


class BucketedServingCache:
    """Shape-keyed serving-program cache.

    Keys are signatures ``(batch_rung, (idcap_f0, idcap_f1, ...))``: the
    formed batch's request count rounded up the batch ladder, and each
    feature's observed total id count rounded up the id ladder (clipped
    to ``per_request_cap * batch_rung``).  ``resolve`` is the admission
    control: the full-capacity signature is always servable, at most
    ``config.max_programs - 1`` bucketed signatures are admitted, and
    everything else rounds up to the smallest admitted dominating
    signature (falling back to full capacity).  Thread-safe."""

    def __init__(  # graft-check: disable=ctor-too-wide
        self,
        serving_fn: Callable,
        feature_names: Sequence[str],
        feature_caps: Sequence[int],
        num_dense: int,
        max_batch: int,
        config: Optional[ServingBucketConfig] = None,
        dedup=False,  # bool, or a dedup kernel kind str
        extra_example=None,
        metrics: Optional[MetricsRegistry] = None,
        dedup_opts: Optional[Mapping[str, object]] = None,
    ):
        """``serving_fn(dense [Br, num_dense], kjt) -> scores [Br]`` (a
        ``ServingModule``: ``dedup`` takes its ``with_lookup_kernel``
        view); ``feature_caps`` are PER-REQUEST id capacities, ``max_batch``
        the queue's forming bound.  ``extra_example`` (the hot-row cache's
        trailing argument) and ``dedup_opts`` (the Pallas kernels' tiling
        knobs) have no counterpart in the port and raise when given."""
        if extra_example is not None:
            raise NotImplementedError(
                "serving programs with a trailing argument (the hot-row "
                "cache) wait for the tiered storage and dynamic "
                "vocabularies (ROADMAP A10)")
        if dedup_opts:
            raise ValueError(
                f"dedup_opts {sorted(dedup_opts)} have no counterpart in "
                "the port: they tile the JAX package's Pallas kernels, and "
                "the CUDA dedup kernels take no such knobs")
        self.keys = tuple(feature_names)
        self.caps = [int(c) for c in feature_caps]
        self.num_dense = int(num_dense)
        self.max_batch = int(max_batch)
        self.config = config or ServingBucketConfig()
        kernel = _dedup_kernel(dedup)
        self.dedup = kernel is not None
        self.dedup_kernel = dedup if isinstance(dedup, str) else (
            "xla_dedup" if self.dedup else None)
        if kernel is not None:
            if not hasattr(serving_fn, "with_lookup_kernel"):
                raise TypeError(
                    "dedup serving needs a serving module with "
                    "with_lookup_kernel (inference.modules.ServingModule)")
            serving_fn = serving_fn.with_lookup_kernel(kernel)
        self._fn = serving_fn
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._full_sig: Signature = (
            self.max_batch,
            tuple(c * self.max_batch for c in self.caps),
        )
        self._admitted: set = set()
        # the signatures run so far: the programs (eager, so a program
        # holds no state beyond its padded shapes)
        self._programs: set = set()
        self._lock = threading.Lock()

    @property
    def full_signature(self) -> Signature:
        """The reserved escape-hatch signature (max batch, full caps)."""
        return self._full_sig

    @property
    def program_count(self) -> int:
        """Number of distinct serving programs (bounded by
        ``config.max_programs``)."""
        with self._lock:
            return len(self._programs)

    def signature(self, n: int, occupancy: Sequence[int]) -> Signature:
        """Round a formed batch's request count and per-feature id
        occupancy up their ladders to the smallest covering signature."""
        cfg = self.config
        br = bucketed_cap(
            n, self.max_batch, cfg.batch_floor, cfg.batch_growth
        )
        idcaps = tuple(
            bucketed_cap(int(occ), cap * br, cfg.id_floor, cfg.id_growth)
            for occ, cap in zip(occupancy, self.caps)
        )
        return (br, idcaps)

    def resolve(self, sig: Signature) -> Signature:
        """Admit a signature or round it up to an admitted dominating one
        (the program-count bound; see the class docstring)."""
        with self._lock:
            if sig == self._full_sig or sig in self._admitted:
                return sig
            if len(self._admitted) < self.config.max_programs - 1:
                self._admitted.add(sig)
                return sig
            dominating = [
                s
                for s in self._admitted
                if s[0] >= sig[0]
                and all(a >= b for a, b in zip(s[1], sig[1]))
            ]
        self.metrics.counter("serving/program_fallback_count")
        if dominating:
            return min(dominating, key=lambda s: s[0] + sum(s[1]))
        return self._full_sig

    @property
    def fn(self) -> Callable:
        """The serving module every program runs (the dedup kernels' view
        when ``dedup``)."""
        return self._fn

    def run(self, sig: Signature, dense: torch.Tensor,
            kjt: KeyedJaggedTensor) -> torch.Tensor:
        """Run the program of an admitted signature: the serving module on
        inputs padded to ``sig``'s shapes.  A signature's first run
        counts a program (``serving/program_compile_count`` and the
        ``serving/program_count`` gauge, the JAX package's counters)."""
        br, caps = sig
        if dense.shape[0] != br or kjt.caps != caps:
            raise ValueError(f"program {sig} called with batch "
                             f"{dense.shape[0]} and caps {kjt.caps}")
        with self._lock:
            if sig not in self._programs:
                self._programs.add(sig)
                self.metrics.counter("serving/program_compile_count")
                self.metrics.gauge("serving/program_count",
                                   float(len(self._programs)))
        return self._fn(dense, kjt)

    def example_inputs(self, sig: Signature):
        """Zero inputs at a signature's shapes on the serving device:
        (dense [batch_rung, num_dense], an empty KJT with the signature's
        capacities)."""
        br, idcaps = sig
        dev = torch.device(self._fn.device)
        kjt = KeyedJaggedTensor.from_lengths_packed(
            self.keys,
            np.zeros((0,), np.int64),
            np.zeros((len(self.keys) * br,), np.int32),
            caps=list(idcaps),
        )
        dense = torch.zeros((br, self.num_dense), dtype=torch.float32,
                            device=dev)
        return dense, kjt.to(dev)

    def warmup(self, signatures: Sequence[Signature] = ()) -> None:
        """Run the reserved full-capacity program plus any given
        signatures once on zero inputs (the kernels' first launch, the
        library handles), so first requests pay neither on the serving
        path.  ``signatures`` are admitted through ``resolve`` (they count
        against the program bound)."""
        sigs = [self._full_sig] + [
            self.resolve((sig[0], tuple(sig[1]))) for sig in signatures]
        for sig in sigs:
            self.run(sig, *self.example_inputs(sig))


class BucketedInferenceServer(InferenceServer):
    """``InferenceServer`` dispatching formed batches to bucketed serving
    programs instead of the single full-pad program, with request dedup
    (the default, as in the JAX package).

    A formed batch of ``n`` requests with per-feature id occupancy
    ``occ`` runs the program for the smallest admitted ``(batch rung >=
    n, id rungs >= occ)`` signature; the pooled embeddings are bitwise
    the full-pad path's.  Per-batch serving metrics (program count,
    dispatch/fallback counters) land in ``self.metrics`` and the HTTP
    front end's ``/metrics`` endpoint."""

    def __init__(  # graft-check: disable=ctor-too-wide
        self,
        serving_fn: Callable,
        feature_names: Sequence[str],
        feature_caps: Sequence[int],
        num_dense: int,
        max_batch_size: int = 64,
        max_latency_us: int = 2000,
        feature_rows: Optional[Sequence[int]] = None,
        degrade_on_bad_input: bool = False,
        metrics: Optional[MetricsRegistry] = None,
        queue: str = "native",
        bucket_config: Optional[ServingBucketConfig] = None,
        dedup=True,  # bool, or a dedup kernel kind str
        hot_rows=None,
        dedup_opts: Optional[Mapping[str, object]] = None,
    ):
        """Base-server arguments exactly as in :class:`InferenceServer`;
        on top, ``bucket_config`` shapes the program ladder and ``dedup``
        serves through the dedup lookup kernels.  ``hot_rows`` raises
        ``NotImplementedError``: the hot-row cache waits for ROADMAP A10."""
        if hot_rows is not None:
            raise NotImplementedError(
                "HotRowServingCache is not ported: it is built on the "
                "tiered storage and dynamic vocabularies (ROADMAP A10)")
        super().__init__(
            serving_fn,
            feature_names,
            feature_caps,
            num_dense,
            max_batch_size=max_batch_size,
            max_latency_us=max_latency_us,
            feature_rows=feature_rows,
            degrade_on_bad_input=degrade_on_bad_input,
            metrics=metrics,
            queue=queue,
        )
        self.cache = BucketedServingCache(
            serving_fn,
            self.features,
            self.caps,
            num_dense,
            self.max_batch,
            config=bucket_config,
            dedup=dedup,
            metrics=self.metrics,
            dedup_opts=dedup_opts,
        )

    def warmup(self, signatures=()) -> None:
        """Build the full-capacity program (+ optional extra signatures)
        before taking traffic."""
        self.cache.warmup(signatures)

    def _run_batch(self, n, dense, ids, lengths):
        """Sanitize, then dispatch the formed batch to the smallest
        dominating bucketed program; returns (scores [n], {request index
        -> degradation reason})."""
        self.metrics.observe(
            "serving/batch_size", float(n), buckets=_BATCH_SIZE_BUCKETS
        )
        dense, ids, lengths, reasons = self._sanitize_requests(
            n, dense, ids, lengths
        )
        occ = np.asarray(lengths[:n], np.int64).sum(axis=0)
        sig = self.cache.resolve(self.cache.signature(n, occ))
        br, idcaps = sig
        args = self._device_inputs(n, dense, ids, lengths, br, list(idcaps))
        self.metrics.counter("serving/bucketed_dispatch_count")
        with span("serving/run_batch", n=n, batch_rung=br):
            scores = self.cache.run(sig, *args).float().cpu().numpy()
        return scores[:n], reasons
