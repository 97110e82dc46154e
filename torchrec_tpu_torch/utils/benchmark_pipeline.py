"""Train-pipeline benchmark (``torchrec_tpu/utils/benchmark_pipeline.py``;
reference ``distributed/benchmark/benchmark_train_pipeline.py``): each
pipeline variant over one model and batch stream, a step time each.

The variants differ in host scheduling (the background loader, the
queue's depth, the semi-sync split) over the same device work, so their
difference is the overlap each one buys.  ``host_delay_s`` adds a host
cost before each batch (a preprocessing stand-in): the ``naive`` loop
pays host + device every step, the pipelined ones about the larger of
the two.  Timing is :func:`~torchrec_tpu_torch.utils.benchmark.benchmark_func`'s.

The port's steps update the state in place, so each variant's pipeline
starts from the state the previous variant left (the JAX package gives
each the same initial state): throughput, not convergence, is measured.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, Sequence

from torchrec_tpu_torch.utils.benchmark import BenchmarkResult, benchmark_func

PIPELINE_VARIANTS = ("naive", "base", "sparse_dist", "semi_sync")


class _NaiveLoop:
    """The unpipelined loop: pull, stack, copy, step, nothing in flight
    across steps, on ``TrainPipelineBase``'s own pull and copy."""

    def __init__(self, step_fn, state, device):
        from torchrec_tpu_torch.parallel.train_pipeline import (
            TrainPipelineBase,
        )

        self._inner = TrainPipelineBase(step_fn, state, device)

    @property
    def state(self):
        return self._inner.state

    def progress(self, it: Iterator):
        # pulled on this thread: the naive loop has no background loader
        batch = self._inner._stack_and_put([next(it)])
        self._inner.state, metrics = self._inner._step(self._inner.state,
                                                       batch)
        return metrics


def _make_pipeline(variant: str, dmp, state):
    from torchrec_tpu_torch.parallel.train_pipeline import (
        TrainPipelineBase,
        TrainPipelineSemiSync,
        TrainPipelineSparseDist,
    )

    if variant == "naive":
        return _NaiveLoop(dmp.make_train_step(), state, dmp.device)
    if variant == "base":
        return TrainPipelineBase(dmp.make_train_step(), state, dmp.device)
    if variant == "sparse_dist":
        return TrainPipelineSparseDist(dmp.make_train_step(), state,
                                       dmp.device)
    if variant == "semi_sync":
        return TrainPipelineSemiSync(dmp, state)
    raise ValueError(f"unknown pipeline variant {variant!r}")


def benchmark_train_pipelines(
    dmp,
    state,
    batches: Sequence,
    variants: Iterable[str] = ("base", "sparse_dist", "semi_sync"),
    warmup: int = 2,
    iters: int = 10,
    host_delay_s: float = 0.0,
) -> Dict[str, BenchmarkResult]:
    """Time ``progress()`` of each variant over the batches, repeated
    without end; ``host_delay_s`` sleeps before each batch is handed
    over."""
    if not batches:
        raise ValueError("benchmark_train_pipelines needs a batch")
    out: Dict[str, BenchmarkResult] = {}
    for variant in variants:
        pipe = _make_pipeline(variant, dmp, state)

        def infinite() -> Iterator:
            i = 0
            while True:
                if host_delay_s:
                    time.sleep(host_delay_s)
                yield batches[i % len(batches)]
                i += 1

        it = infinite()
        # one iterator a variant: a pipeline keeps its loader on it
        out[variant] = benchmark_func(
            f"pipeline[{variant}]", lambda p=pipe, s=it: p.progress(s),
            warmup=warmup, iters=iters)
        state = pipe.state
    return out


def measure_overlap_win(
    dmp,
    state,
    batches,
    host_delay_s: float = None,
    iters: int = 8,
) -> Dict[str, float]:
    """Each variant's mean step ms under a slow host stage, and each
    pipelined variant's ratio to the naive loop (below 1.0: overlap
    happened).  ``host_delay_s=None`` sizes the host cost from a naive
    probe to one device step (one local batch a step here), the worst
    case for the serial loop."""
    if host_delay_s is None:
        probe = benchmark_train_pipelines(dmp, state, batches,
                                          variants=("naive",), warmup=2,
                                          iters=4)
        host_delay_s = probe["naive"].mean_ms / 1000.0
    results = benchmark_train_pipelines(
        dmp, state, batches, variants=PIPELINE_VARIANTS, warmup=2,
        iters=iters, host_delay_s=host_delay_s)
    naive = results["naive"].mean_ms
    out = {f"{k}_ms": v.mean_ms for k, v in results.items()}
    for k in PIPELINE_VARIANTS[1:]:
        out[f"{k}_vs_naive"] = results[k].mean_ms / naive
    out["host_delay_ms"] = host_delay_s * 1e3
    return out
