"""Benchmark harness (``torchrec_tpu/utils/benchmark.py``; reference
``distributed/benchmark/base.py``): warm-up and timed iterations, runtime
percentiles, the peak device memory, and a profiler trace.

Each iteration ends in ``torch.cuda.synchronize()`` (every visible card),
so the host clock covers the device work the call queued; the peak is
``torch.cuda.max_memory_allocated`` of each card, after its counter was
reset before the warm-ups.  ``trace_dir`` writes a ``torch.profiler``
Chrome trace of the timed iterations.  On a machine with no card there is
nothing to fence, and no peak is recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class BenchmarkResult:
    """Wall runtimes and peak device memory, with percentile accessors
    (reference BenchmarkResult)."""

    name: str
    runtimes_ms: np.ndarray  # [iters]
    peak_hbm_bytes: Dict[int, int]  # card index -> bytes
    trace_dir: Optional[str] = None

    def runtime_percentile(self, p: float) -> float:
        return float(np.percentile(self.runtimes_ms, p))

    @property
    def mean_ms(self) -> float:
        return float(self.runtimes_ms.mean())

    @property
    def p50_ms(self) -> float:
        return self.runtime_percentile(50)

    @property
    def p90_ms(self) -> float:
        return self.runtime_percentile(90)

    def __str__(self) -> str:
        mem = ""
        if self.peak_hbm_bytes:
            mx = max(self.peak_hbm_bytes.values())
            mem = f" peak_hbm={mx / (1 << 30):.2f}GiB"
        return (f"{self.name}: mean={self.mean_ms:.3f}ms "
                f"p50={self.p50_ms:.3f}ms p90={self.p90_ms:.3f}ms{mem}")


def _cards() -> range:
    return range(torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)


def _fence() -> None:
    for i in _cards():
        torch.cuda.synchronize(i)


def undonated_train_step(dmp):
    """The train step a benchmark drives: the JAX package forces buffer
    donation off here; the port's eager step donates nothing, so this is
    ``dmp.make_train_step()``."""
    return dmp.make_train_step()


def benchmark_func(
    name: str,
    fn: Callable[[], object],
    warmup: int = 3,
    iters: int = 20,
    trace_dir: Optional[str] = None,
) -> BenchmarkResult:
    """Time ``fn`` (a call that queues device work): ``warmup`` calls,
    then ``iters`` timed calls, each fenced by a synchronize so that the
    device time is in it.  ``trace_dir``: a Chrome trace
    (``trace.json``) of the timed calls, from ``torch.profiler``."""
    for i in _cards():
        torch.cuda.reset_peak_memory_stats(i)
    for _ in range(warmup):
        fn()
        _fence()
    prof = None
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    times: List[float] = []
    with prof if prof is not None else contextlib.nullcontext():
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            _fence()
            times.append((time.perf_counter() - t0) * 1e3)
    if prof is not None:
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return BenchmarkResult(
        name=name,
        runtimes_ms=np.asarray(times),
        peak_hbm_bytes={i: int(torch.cuda.max_memory_allocated(i))
                        for i in _cards()},
        trace_dir=trace_dir,
    )


def benchmark_grid(
    cases: Sequence,  # (name, fn) pairs
    warmup: int = 3,
    iters: int = 20,
) -> List[BenchmarkResult]:
    """A list of (name, call) cases, each through :func:`benchmark_func`
    (the reference's benchmark-module sweep)."""
    return [benchmark_func(name, fn, warmup=warmup, iters=iters)
            for name, fn in cases]
