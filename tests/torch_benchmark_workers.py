"""The ranks of ``tests/test_torch_benchmark_utils.py``'s gloo launch: the
port's collective benchmarks and the two-level A/B worker on the CPU.
Imports torch, numpy and the port only, and returns plain data."""

from __future__ import annotations

import torch

from torchrec_tpu_torch.parallel import hier_bench_worker, multiprocess
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.utils.benchmark_comms import (
    benchmark_collectives,
    benchmark_qcomm_sweep,
)

ROWS, DIM = 8, 16


def _summary(results):
    return [(r.result.name, r.payload_bytes_per_rank, r.ledger_bytes,
             len(r.result.runtimes_ms), r.effective_gbps > 0)
            for r in results]


def comms_rank():
    """``benchmark_collectives``, the qcomm sweep, then
    ``hier_bench_worker``'s smoke A/B with each rank its own slice."""
    torch.set_num_threads(1)
    multiprocess.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device="cpu")
    flat = _summary(benchmark_collectives(env, rows_per_rank=ROWS, dim=DIM,
                                          warmup=1, iters=3))
    sweep = {k: _summary(v) for k, v in benchmark_qcomm_sweep(
        env, rows_per_rank=ROWS, dim=DIM, warmup=1, iters=3).items()}
    two_level = ShardingEnv.from_process_group("gloo", device="cpu",
                                               num_slices=env.world_size)
    return flat, sweep, hier_bench_worker.run(two_level, smoke=True)
