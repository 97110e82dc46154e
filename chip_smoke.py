#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: the DLRM training step of
``bench.py main()``, the unsharded authoring path of the same model
(``EmbeddingBagCollection`` -> ``DLRM`` -> ``DLRMTrain``), the bucketed
training pipeline on the dedup kernels, MLPerf DLRM-v2 (``DLRM_DCN``)
training on the per-id kernels, the planner-driven DLRM application
(``examples/dlrm/dlrm_main.py``), quantized DLRM serving, and the
multi-rank sharded train step (4 gloo ranks on the card, 1 NCCL rank).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and fails (non-zero exit, no result line)
without one, or when the ``torchrec_tpu_torch`` package is not beside it.
``python3 chip_smoke.py --one-device-gap`` runs only the study of
:func:`one_device_gap` (why a sharded run's tables part from the plain
one-device step's).

Phases, one JSON line each on stdout; any failure raises:

1. device — the card, its power limit, and the nvcc builds of the
   kernels (``torchrec_tpu_torch/csrc/{tbe_float,tbe_backward,tbe_quant,
   tbe_dedup,tbe_dedup_backward}.cu``, one nvcc per source, started
   together) from source, and the registers of every B1, B2 and B6
   instantiation (``registers``: at most 128 for D <= 128 for B2/B6);
2. kernel — each quantized lookup kernel against its plain PyTorch version
   on the card (``torch.equal``) at D=128, S=4096 segments with the MLPerf
   DLRM-v2 multi-hot lengths, a 1M-row table, uniform and Zipf ids; with
   its time, its plain version's, ``F.embedding_bag`` over the
   pre-dequantized float32 table as a yardstick, and the memory bound;
   the kernel's and the yardstick's times both with the host's launch
   work in (``kernel_ms``, ``library_ms``) and of the card alone
   (``kernel_device_ms``, ``library_device_ms``);
   Then the ``planner`` records: the port's sharding planner with its
   H100 profile over the bench tables at world 1 and 4 and over the
   MLPerf DLRM-v2 tables at world 1 (no run);
3. train — the training main path: ``DistributedModelParallel`` at the
   configuration of ``bench.py main()`` (26 tables of 100,000 x 128, SUM,
   float32, one table-wise group, the planner's plan at world 1; B=4096 from ``RandomRecDataset`` with
   one id per feature at most; DLRM 13 -> 512-256-128, over arch
   1024-1024-512-256-1 in bfloat16 with a float32 logit layer; BCE;
   rowwise Adagrad lr 0.05 and optax-style dense Adagrad 0.05).  First
   ``train_kernel``: the float pooled lookup (B1) and the fused backward +
   rowwise Adagrad (B2) against their plain versions at the path's shapes
   (every B1 row through both entries: the slot regions the main paths
   pass, checked for host syncs and held to its output plus the lengths'
   running ends in memory, and the sorted stream)
   (the ``[2,600,000, 128]`` stack, V = S = 106,496 slots of a bench
   batch), float32 and bfloat16 stacks, the batch's uniform ids and
   Zipf(1.1) ids, with the same times and bounds as above (B2 in place,
   its touched rows restored after every call, bfloat16 with stochastic
   rounding); then a path check on the first batch (B1's output, and B2's
   updated stack and momentum from the step's real gradient,
   ``torch.equal`` to the plain versions on the touched rows, nothing
   written elsewhere); then 1 warm-up and 20 timed
   steps over 4 batches (samples/s, every loss finite, one B1 and one B2
   launch per step), three steps under ``torch.profiler``, and 3 steps of
   the bfloat16-table arm with stochastic rounding (its path check also
   holds the rounded stack apart from round-to-nearest);
4. ebc — the unsharded authoring path at the same width: an
   ``EmbeddingBagCollection`` of the 26 float32 tables on the card (drawn
   from a seeded generator), ``DLRM(embedding_bag_collection=...)`` in
   bfloat16 as in phase 3, ``DLRMTrain``, the same ``RandomRecDataset``
   batches.  First ``ebc_kernel``: B1 and B4 against their plain versions
   at the path's shapes (one table's lookup, V = S = 4,096); then
   ``ebc_check``: one forward launches 26 B1s and no other pooled kernel
   (the wrappers' counts and a profile), and with ``kernel="dedup"`` 26
   B4s with the same KeyedTensor (``torch.equal``); the KeyedTensor
   ``torch.equal`` to the one-device DMP's sharded one from a stack filled
   with the EBC's weights; two backward calls on one weighted batch give
   ``torch.equal`` table and weight gradients; ``EmbeddingCollection``
   over the same rows equal to a row gather; ``DLRM_DCN`` (3 layers,
   rank 512) and ``DLRM_Projection`` (both branches 512-256) through the
   same collection give finite logits.  Then 1 warm-up and 20 timed
   ``DLRMTrain`` steps with autograd and the port's dense Adagrad over
   every parameter, tables included (samples/s, losses finite, 26 B1
   launches a step and nothing else, the looked-up rows changed and the
   rows no batch looked up unchanged, peak memory) and three profiled
   steps;
5. train_dedup — the bucketed training pipeline on the dedup kernels:
   the DLRM of phase 3 through ``BucketedTrainPipeline`` (ladder floor 8,
   growth 2, at most 8 signatures; ``kernels`` dedup for the lookup and
   the update) over a stream of up to 64 ids per feature per example
   with Zipf(1.2) lengths from 1 and Zipf(1.0) ids (full caps 262,144
   ids per feature).  First ``dedup_kernel``: the ragged dedup lookup
   (B4) over the float32 stack and its bfloat16 cast (with its card-alone
   time, its wrapper's peak memory, a check that the wrapper makes no host
   sync, and B1 on the same slots), and the dedup fused
   update (B6) for each of its eight optimizers on float32 and rowwise
   Adagrad on bfloat16 with stochastic rounding, each against its plain
   version (``torch.equal``) on the first bucketed batch's slots, with
   times (B4 and B6 also of the card alone), bounds, registers and grid, and
   B6's runs arm (one run each of 1 to 10,000 slots, then the sentinel,
   ``runs_slots``); then the path check on that batch (B4's output
   equal to B1's, B6's update from the step's real gradient equal to its
   plain version's, and the state after one bucketed step equal to the
   state after the same step at full caps); then 1 warm-up and 20 timed
   rowwise-Adagrad steps (samples/s, every loss finite, one B4 and one
   B6 launch per step and nothing else, the signatures dispatched and
   the padding ratios), three profiled steps, and 3 steps of each other
   optimizer and of the bfloat16-table arm;
6. train_dcn — MLPerf DLRM-v2 training (mlcommons/training
   ``recommendation_v2/torchrec_dlrm``) on the per-id kernels:
   ``DistributedModelParallel(DLRM_DCN, table_wise_plan,
   lookup_kernel="tbe", update_kernel="tbe")`` over 26 tables of D=128,
   SUM, float32, at ``min(MLPerf DLRM-v2 rows, 5,000,000)`` rows (one
   table-wise group ``[29,184,588, 128]``: a 14.9 GB stack and a 14.9 GB
   per-element Adagrad state); ``RandomRecDataset`` with the fixed
   multi-hot lengths (214 ids per example; min = max), uniform ids, seed
   0; B=8192 per card (the recipe's 65,536 over 8 GPUs), so the slot
   stream holds 1,753,088 ids in 21,299,200 slots (the table-wise
   layout's uniform per-slot capacity) over S = 212,992 segments; dense
   arch 13 -> 512-256-128 and over arch 1024-1024-512-256-1 in bfloat16
   with a float32 logit layer, ``LowRankCrossNet`` 3 layers at rank 512
   over the 3,456-wide concat in float32 (TF32 off); BCE; per-element
   Adagrad (``EmbOptimType.ADAGRAD``, lr 0.004, eps 1e-8) on the tables
   and optax-style dense Adagrad 0.004.  First ``dcn_kernel``: B1 and B2
   (Adagrad) against their plain versions at the path's shapes (the
   stack, the first batch's slots, its uniform ids and Zipf(1.1) ids per
   table) and B2's runs arm (``runs_slots``), then B2 for the other seven
   optimizers on float32 and all eight on bfloat16 with stochastic
   rounding at the same batch shapes over a stack of ``min(MLPerf rows,
   1,000,000)`` rows (7,116,632 rows); each with kernel (also of the card
   alone), wrapper and plain times, bound, registers and grid, the stack
   and states restored on the touched rows only between calls;
   then the path check on the first batch (B1's output and B2's updated
   stack and momentum from the step's real gradient ``torch.equal`` to
   the plain versions, touched rows past 2^31 bytes); then 1 warm-up and
   20 timed steps over 4 cycled batches (samples/s, every loss finite,
   one B1 and one B2 launch per step and nothing else), the cross net's
   forward and backward alone, three profiled steps with the cross net's
   GEMMs named, and 3 steps of each other optimizer and of a
   bfloat16-table arm at the 1,000,000-row cap;
7. serving — quantized serving: DLRM at the widths of ``bench.py`` (26 sparse
   features, D=128, 13 dense, dense arch 512-256-128, over arch
   1024-1024-512-256-1, float32) over int8 tables at the MLPerf DLRM-v2
   row counts (204,184,588 rows); first each kernel against its plain
   version (``torch.equal``) on every feature of one formed batch (B=256)
   over those tables, uniform and Zipf ids, int8 and the int4/int2 views
   of the same codes, with row offsets past 2^31 bytes; the collection's
   forward on one formed batch under ``torch.cuda.set_sync_debug_mode(
   "error")`` (no host sync); then behind ``InferenceServer`` with eight
   client threads, once with the int8 TBE kernel and once with the dedup
   kernel on Zipf ids (one grouped launch per batch and nothing else);
   then ``serving_fn`` alone at B=4096, a ``torch.profiler`` breakdown of
   one served batch (B=256): wall time, device busy time and idle share,
   the kernels that take the time; and last the grouped launches (all 26
   features of a batch in one launch) against their plain versions at
   the served B=256 and the B=4096 batch, int8 and the int4/int2 views,
   uniform and Zipf ids, with times and bounds;
8. app (before serving) — the DLRM application through its ``main`` at
   ``--num_embeddings 100000 --embedding_dim 128 --batch_size 4096
   --steps 40 --eval_steps 10 --warmup_steps 20`` (8 features x 10 ids,
   DLRM 13 -> 512-256-128, over arch 512-512-256-1, float32; rowwise
   Adagrad and dense Adagrad 0.05, one linear warmup schedule on both;
   the planner's plan at world 1): one B1 per train step and eval batch
   and one B2 per train step and nothing else (counts and a profile),
   finite losses, ``id_overflow`` zero, ``make_forward`` ``torch.equal``
   to ``train_step``'s logits, a ramp step ``torch.equal`` to the plain
   B1/B2 at the scheduled float32 lr, NE / AUC / calibration finite and
   the card's ``RecMetricModule`` within 1e-6 of a CPU module's; ms a
   step, samples/s, eval ms a batch, peak memory, and the planner's
   per-rank HBM and step estimates beside them;
   roundtrip — ``package_model`` at 10k rows per table, loaded on the
   card and on the CPU, scores compared.
9. sharded — the multi-rank train step (``parallel/comm.py``,
   ``multiprocess.py``, ``sharding/{tw,rw,twrw}.py``, the sharded
   ``EmbeddingBagCollection`` and ``DistributedModelParallel(env=...)``)
   at the width of phase 3, B=4096 per rank.  Four ranks on the one card
   over gloo (``multiprocess.launch``: spawned after the parent built
   every kernel), each on ``cuda:0``, for six plans: table-wise
   round-robin, column-wise in 2 shards, row-wise, table-row-wise over
   nodes of 2 ranks, row-wise + table-wise + column-wise + 2
   data-parallel tables, and the port's planner's plan at world 4
   (``planned``, which adds each rank's ``make_forward`` ``torch.equal``
   to the one-device forward of its batch, and one step with rank 0's
   batch over capacity whose ``id_overflow``, summed over ranks, equals
   the one-device counts).  Per plan and rank: the KT of its one-id batch
   ``torch.equal`` to the unsharded ``EmbeddingBagCollection``'s (same
   seeded tables) and of a weighted multi-hot batch (Zipf(1.2) lengths of
   1 to 64, Zipf(1.0) ids, repacked to the ranks' largest bucketed caps)
   ``torch.equal`` on table-wise, column-wise and data-parallel features
   and within 1e-5 on row-wise and table-row-wise ones (partial sums
   added in rank order); on the table-wise plan the dedup kernels' KT
   (B4) ``torch.equal`` to B1's; B1 (over the rank's received regions)
   and B2 (from the step's real gradient) ``torch.equal`` to their plain
   versions and their card-alone times, ranks in turns; 1 warm-up and 5
   timed steps (ms a step, each rank's B1 and B2 launches at least one a
   step and nothing else, the wire bytes a step from the ledger); the
   trained tables, gathered by ``table_weights``, ``np.array_equal`` to a
   one-device DMP's after the same 6 steps on the global batches, its
   dense part run over the ranks' micro-batches (``one_device_run``), and
   the losses within ``PLAIN_LOSS_RTOL`` of the plain one-device
   ``train_step``'s on the global batches (its tables part from the
   sharded ones by more than a tolerance could hold: see
   ``--one-device-gap``); and one step on every rank at once under
   ``torch.profiler`` with B1 and B2 in it.  Then one rank over NCCL: the
   row-wise plan's
   KT and its tables after one step ``torch.equal`` to the one-device
   DMP's.  The times of this phase are of 4 processes sharing one card:
   not multi-GPU figures.

Then the ``kernels`` summary line, the ``nvidia-smi`` name/power line,
and the result line ``{"ok": true, "device": {...}}`` last.

Cut for the smoke run: the training weights are random from a seed and
the step count is the bench's; for ``train_dcn``, the five 40M-row
tables are capped at 5,000,000 rows each (no other table exceeds 5M;
104 GB of float32 tables and Adagrad state cannot fit one card), the
weights are random from a seed and 4 batches are cycled; the serving
tables' codes, scales and
biases are drawn on the device from a seeded generator instead of
quantizing trained weights through ``package_model`` (26 GB of float
tables would not fit the run); the dense weights are random from a seed.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bandwidth and float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNEL_SOURCES = {
    "pooled_lookup": "torchrec_tpu_torch/csrc/tbe_float.cu",
    "fused_sparse_update": "torchrec_tpu_torch/csrc/tbe_backward.cu",
    "quant_pooled_lookup_int8": "torchrec_tpu_torch/csrc/tbe_quant.cu",
    "dedup_quant_pooled_lookup": "torchrec_tpu_torch/csrc/tbe_quant.cu",
    "dedup_pooled_lookup": "torchrec_tpu_torch/csrc/tbe_dedup.cu",
    "dedup_fused_sparse_update":
        "torchrec_tpu_torch/csrc/tbe_dedup_backward.cu",
}
# the main paths that launch each kernel (chip_smoke's phases)
KERNEL_PATHS = {
    "pooled_lookup": ["train", "ebc", "train_dcn", "app", "sharded"],
    "fused_sparse_update": ["train", "train_dcn", "app", "sharded"],
    "quant_pooled_lookup_int8": ["serving"],
    "dedup_quant_pooled_lookup": ["serving"],
    "dedup_pooled_lookup": ["train_dedup", "ebc"],
    "dedup_fused_sparse_update": ["train_dedup"],
}
REPLACES = {
    "pooled_lookup": "torchrec_tpu/ops/pallas_tbe.py:287",
    "fused_sparse_update": "torchrec_tpu/ops/pallas_tbe_backward.py:920",
    "quant_pooled_lookup_int8":
        "torchrec_tpu/ops/pallas_tbe.py:383",
    "dedup_quant_pooled_lookup":
        "torchrec_tpu/ops/pallas_tbe.py:888",
    "dedup_pooled_lookup": "torchrec_tpu/ops/pallas_tbe.py:811",
    "dedup_fused_sparse_update":
        "torchrec_tpu/ops/pallas_tbe_backward.py:1127",
}

KERNEL_ROWS = 1_000_000
# cuda_ms(device_only=True): the spin that hides the host's launch time
# (about 1.1 ms at the H100's 1.755 GHz boost clock)
SPIN_CYCLES = 2_000_000
KERNEL_SEGMENTS = 4096
DIM = 128
NUM_DENSE = 13
DENSE_ARCH = (512, 256, DIM)
OVER_ARCH = (1024, 1024, 512, 256, 1)
NUM_REQUESTS = 512
NUM_CLIENTS = 8
SERVING_BATCH = 256
BENCH_BATCH = 4096
ROUNDTRIP_ROWS = 10_000
ZIPF_A = 1.1
# the training step of bench.py main()
TRAIN_FEATURES = 26
TRAIN_ROWS = 100_000
TRAIN_BATCH = 4096
TRAIN_LR = 0.05
TRAIN_BATCHES = 4
TRAIN_STEPS = 20
BF16_STEPS = 3
SR_SEED = 12345
# the bucketed training pipeline on the dedup kernels: the same DLRM, a
# stream with Zipf(1.2) lengths of 1..64 ids per feature (bench.py's
# bucketing bench) and Zipf(1.0) ids (its dedup bench's headline exponent)
DEDUP_MAX_IDS = 64
DEDUP_ZIPF_LENGTHS = 1.2
DEDUP_ZIPF_IDS = 1.0
BUCKETING = {"floor": 8, "growth": 2.0, "max_programs": 8}
ARM_STEPS = 3
# the plain versions of the fused updates walk a Zipf-hot row slot by slot
PLAIN_RUNS = 3
# MLPerf DLRM-v2 training (DLRM_DCN, train_dcn): the row cap of the main
# path and of the kernel rows and arms of the other optimizers, the
# recipe's per-card batch, cross net and learning rate
DCN_ROW_CAP = 5_000_000
DCN_ARM_ROW_CAP = 1_000_000
DCN_BATCH = 8192
DCN_LAYERS = 3
DCN_RANK = 512
DCN_LR = 0.004
EPS = 1e-8  # the fused optimizers' eps (the JAX default)
# row offsets past this many bytes need the kernels' 64-bit addressing
FAR_BYTES = 2**31
# the runs arm of B2 and B6: one run of each length on its own row (the
# table's last among them), then RUN_PADDING invalid slots (the sentinel)
RUN_LENGTHS = (1, 2, 31, 32, 33, 63, 64, 65, 100, 1000, 2731, 3000, 10000)
RUN_PADDING = 4096
# multiplies, adds, divisions and roots per column of one row's update
# (after the gradient sum), for the operations bound of the fused updates
UPDATE_OPS_PER_COLUMN = {
    "sgd": 2, "lars_sgd": 6, "adagrad": 6, "rowwise_adagrad": 5,
    "adam": 13, "partial_rowwise_adam": 9, "lamb": 17,
    "partial_rowwise_lamb": 13,
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, flush, runs: int = 20, warmup: int = 3, setup=None,
            device_only: bool = False) -> float:
    """Median time of ``fn`` over ``runs`` calls after ``warmup``, by CUDA
    events; ``flush`` (a 128 MB buffer) is rewritten before each timed
    call, outside the events, so no call finds the previous call's rows in
    the 50 MB L2.  ``setup`` (if given) runs before each call, outside the
    events too: it restores what an in-place ``fn`` wrote.  By default the
    events also take in the host's time to launch ``fn``'s work whenever
    the card waits for it; ``device_only`` first queues a ~1 ms spin on
    the card, so the host has queued ``fn``'s work before the start event
    and the events time the card alone."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        flush.zero_()
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def memory_of(fn):
    """(peak, held): the card memory one call of ``fn`` allocates at its
    peak, and what it still holds when it returns (its output), both above
    what was allocated before it.  The allocator's cache is emptied first,
    so the same calls get the same blocks every time."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kept = fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del kept
    return torch.cuda.max_memory_allocated() - before, held


def meta_ebc(tables):
    """The model's ``EmbeddingBagCollection`` on ``torch.device("meta")``:
    a placeholder where the sharded collection or the quantized one holds
    the tables (no table is allocated twice)."""
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )

    return EmbeddingBagCollection(tables, device="meta")


def zipf_ids(rng: np.random.RandomState, size: int, rows: int) -> np.ndarray:
    """Zipf-distributed ids as ``bench.py`` draws them."""
    return np.minimum(rng.zipf(ZIPF_A, size=size) - 1, rows - 1)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(dev, flush):
    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.datasets.criteo import MLPERF_DLRM_V2_MULTI_HOT
    from torchrec_tpu_torch.ops import tbe

    R, D, S = KERNEL_ROWS, DIM, KERNEL_SEGMENTS
    lengths = torch.tensor(
        [MLPERF_DLRM_V2_MULTI_HOT[s % len(MLPERF_DLRM_V2_MULTI_HOT)]
         for s in range(S)], dtype=torch.int64,
    )
    V = int(lengths.sum())
    segs = torch.repeat_interleave(torch.arange(S), lengths).to(dev)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(lengths, 0)[:-1]]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = torch.rand(V, generator=gen, device=dev)
    scale = (torch.rand(R, generator=gen, device=dev) + 0.5) * (0.1 / 255)
    bias = torch.rand(R, generator=gen, device=dev) * 0.01 - 0.05
    rng = np.random.RandomState(0)
    id_sets = {
        "uniform": torch.randint(0, R, (V,), generator=gen, device=dev),
        "zipf": torch.from_numpy(zipf_ids(rng, V, R)).to(dev),
    }
    rows = []
    for bits in (8, 4, 2):
        Dp = D * bits // 8
        packed = torch.randint(0, 256, (R, Dp), generator=gen, device=dev,
                               dtype=torch.uint8)
        deq = (tbe.unpack_rows(packed, bits).to(torch.float32)
               * scale[:, None] + bias[:, None])
        kernels = [("dedup_quant_pooled_lookup", tbe.dedup_quant_pooled_lookup,
                    tbe.dedup_quant_pooled_lookup_plain, {"bits": bits})]
        if bits == 8:
            kernels.insert(0, ("quant_pooled_lookup_int8",
                               tbe.quant_pooled_lookup_int8,
                               tbe.quant_pooled_lookup_int8_plain, {}))
        for dist, ids in id_sets.items():
            args = (packed, scale, bias, ids, segs, S, w)
            U = int(torch.unique(ids).numel())
            # the least this lookup must move: each distinct row (codes +
            # scale + bias) once, each id, segment and weight once, the
            # float32 output once; 4 flops per id and column
            nbytes = (U * (Dp + 8)
                      + V * (ids.element_size() + segs.element_size()
                             + w.element_size())
                      + S * D * 4)
            flops = 4 * V * D
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            flops_ms = flops / PEAK_F32_FLOPS * 1e3
            library = lambda: F.embedding_bag(  # noqa: E731
                ids, deq, offsets, mode="sum", per_sample_weights=w)
            lib_ms = cuda_ms(library, flush)
            lib_device_ms = cuda_ms(library, flush, device_only=True)
            lib_out = F.embedding_bag(ids, deq, offsets, mode="sum",
                                      per_sample_weights=w)
            for name, wrapper, plain, kw in kernels:
                got = wrapper(*args, **kw)
                torch.cuda.synchronize()
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, ref))
                err = float((got - ref).abs().max())
                if not equal:
                    raise AssertionError(
                        f"{name} bits={bits} {dist}: kernel != plain "
                        f"(max abs err {err})"
                    )
                if name == "quant_pooled_lookup_int8":
                    prep = tbe.sort_by_segment(ids, segs, w, S, R)
                    launch = lambda: tbe.launch_q8_pooled(  # noqa: E731
                        packed, scale, bias, *prep)
                else:
                    prep = tbe.dedup_prepare_sized(ids, segs, w, S)
                    launch = lambda: tbe.launch_dedup_q(  # noqa: E731
                        packed, scale, bias, *prep, bits)
                rec = {
                    "phase": "kernel", "kernel": name, "bits": bits,
                    "ids": dist, "rows": R, "D": D, "S": S, "V": V,
                    "distinct": U, "equal": equal, "max_abs_err": err,
                    "ms": cuda_ms(lambda: wrapper(*args, **kw), flush),
                    "kernel_ms": cuda_ms(launch, flush),
                    "kernel_device_ms": cuda_ms(launch, flush,
                                                device_only=True),
                    "plain_ms": cuda_ms(lambda: plain(*args, **kw), flush),
                    "library_ms": lib_ms,
                    "library_device_ms": lib_device_ms,
                    "library_max_abs_diff": float(
                        (lib_out - got).abs().max()),
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": max(bytes_ms, flops_ms),
                    "bound_by": "bytes" if bytes_ms >= flops_ms
                    else "operations",
                }
                emit(rec)
                rows.append(rec)
        del packed, deq
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the training step at full width
# ---------------------------------------------------------------------------


def build_trainer(dev, table_dtype):
    """``DistributedModelParallel`` at the configuration of ``bench.py
    main()``, on the plan of the planner at world 1 as ``bench.py main()``
    makes it (bench.py:3987; ``table_wise_plan``, which the planner
    record holds), its state from a seeded generator on the card, and the
    first ``TRAIN_BATCHES`` batches of its dataset on the card."""
    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner

    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * len(keys),
                          [1] * len(keys), num_dense=NUM_DENSE,
                          manual_seed=0)
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, EmbeddingShardingPlanner(world_size=1).plan(tables),
        TRAIN_BATCH, dict(zip(keys, ds.caps)),
        fused_config=FusedOptimConfig(learning_rate=TRAIN_LR),
        dense_optimizer=adagrad(TRAIN_LR), table_dtype=table_dtype,
        device=dev,
    )
    state = dmp.init(torch.Generator(device=dev).manual_seed(0))
    it = iter(ds)
    batches = [next(it).to(dev) for _ in range(TRAIN_BATCHES)]
    return dmp, state, batches


def _b1_bound(R, D, esize, ids, segs, w, S):
    """Bytes and flops the pooled lookup must move / do on these inputs:
    each distinct valid row once, each slot's id, segment and weight
    once, the output once; a multiply and an add per valid slot and
    column."""
    import torch

    valid = segs < S
    U = int(torch.unique(ids.clamp(0, R - 1)[valid]).numel())
    nbytes = (U * D * esize
              + ids.numel() * (ids.element_size() + segs.element_size()
                               + w.element_size())
              + S * D * esize)
    return U, nbytes, 2 * int(valid.sum()) * D


def _bound(nbytes, flops):
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def _update_bound(D, esize, sg, optim):
    """Bytes and operations a fused update must move / do on these
    inputs: each referenced gradient row once, each slot's id, flag,
    segment and weight once, each touched table row and its optimizer
    state read and written once; per kept slot a multiply and an add per
    column, per touched row ``UPDATE_OPS_PER_COLUMN`` per column."""
    import torch

    from torchrec_tpu_torch.ops.tbe_backward import STATE_LAYOUTS

    ok = sg.ok() & (sg.ids >= 0)
    U = int(torch.unique(sg.ids[ok]).numel())
    n_seg = int(torch.unique(sg.segments[ok]).numel())
    V = sg.ids.numel()
    state_bytes = sum(4 if kind == "row" else 4 * D
                      for kind in STATE_LAYOUTS[optim])
    nbytes = (n_seg * D * 4
              + V * (sg.ids.element_size() + 1 + sg.segments.element_size()
                     + sg.weights.element_size())
              + U * 2 * (D * esize + state_bytes))
    flops = 2 * int(ok.sum()) * D + UPDATE_OPS_PER_COLUMN[optim] * U * D
    return U, nbytes, flops


def _checksum(t) -> int:
    """The sum of a tensor's bit patterns as integers: changes when any
    element does (barring a cancellation), at the cost of one read.
    Summed in blocks of rows: an int64 sum casts its input whole."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    bits = t.view(ints[t.dtype])
    return sum(int(b.sum(dtype=torch.int64)) for b in bits.split(1 << 20))


class RowSnapshot:
    """The ``rows`` of each array (a stack and its optimizer states),
    saved once, so an in-place update can be undone on those rows alone
    (the 15 GB arrays are never copied whole)."""

    def __init__(self, arrays, rows):
        self.arrays, self.rows = list(arrays), rows
        self.saved = [a[rows].clone() for a in self.arrays]
        self.sums = [_checksum(a) for a in self.arrays]

    def take(self):
        """The rows as they are now, and undo the update on them."""
        now = [a[self.rows].clone() for a in self.arrays]
        self.restore()
        return now

    def restore(self):
        for a, saved in zip(self.arrays, self.saved):
            a.index_copy_(0, self.rows, saved)

    def intact(self) -> bool:
        """Every array equal to what it was when saved, by checksum: an
        update that wrote outside the saved rows shows here."""
        return [_checksum(a) for a in self.arrays] == self.sums


def _update_call(fn, stack, states, optim, sg, lr, seed, bc):
    """``fn`` (B2's wrapper or plain version) on a stack and the
    optimizer's states, with the JAX package's argument layout."""
    adam = len(states) == 2
    return fn(stack, None if adam or not states else states[0], sg.ids,
              sg.valid, sg.segments, sg.weights, sg.grad_seg, lr,
              eps=EPS, weight_decay=0.0, sr_seed=seed, optim=optim,
              states=states if adam else None, bias_corrections=bc)


def runs_slots(R, S, seed):
    """A slot stream built to hit the edges of the fused updates' grid and
    walk: one run of each of ``RUN_LENGTHS`` slots on its own random row
    (row ``R - 1`` among them), then ``RUN_PADDING`` invalid slots, all
    shuffled, with random segments in ``[0, S)`` and weights.  Returns
    host ``(ids, valid, segments, weights)``."""
    rng = np.random.RandomState(seed)
    rows = np.unique(rng.randint(0, R - 1, 4 * len(RUN_LENGTHS)))
    rows = rng.permutation(rows)[: len(RUN_LENGTHS)]
    rows[-1] = R - 1
    n_valid = sum(RUN_LENGTHS)
    n = n_valid + RUN_PADDING
    ids = np.concatenate([np.repeat(rows, RUN_LENGTHS),
                          rng.randint(0, R, RUN_PADDING)])
    perm = rng.permutation(n)
    return (ids[perm].astype(np.int32), (np.arange(n) < n_valid)[perm],
            rng.randint(0, S, n).astype(np.int32),
            rng.rand(n).astype(np.float32))


def _runs_seg_grad(dev, R, grad, seed):
    """``runs_slots`` on the card over the upstream gradient ``grad``."""
    import torch

    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    arrays = runs_slots(R, grad.shape[0], seed)
    return SparseSegGrad(*(torch.from_numpy(a).to(dev) for a in arrays),
                         grad)


def _launch_facts(kernel, optim, dtype, sg, R):
    """The launch's instantiation and grid on these inputs: registers,
    column layout, blocks (and resident per SM), warps, the 32-position
    windows that hold work, and the claims on the work queue (one more
    per warp, the claim that stops it)."""
    from torchrec_tpu_torch.ops.tbe_backward import update_launch

    D = sg.grad_seg.shape[1]
    info = update_launch(kernel, optim, dtype, D, sg.ids.numel())
    kept = int((sg.ok() & (sg.ids >= 0) & (sg.ids < R)).sum())
    windows = -(-kept // 32)
    warps = info["blocks"] * 8
    return {"registers": info["registers"], "layout": info["layout"],
            "grid": {"blocks": info["blocks"],
                     "blocks_per_sm": info["blocks_per_sm"], "warps": warps,
                     "windows": windows, "claims": windows + warps}}


def b2_row(flush, phase, stack, states, optim, sg, lr, seed, common):
    """B2 with ``optim`` against its plain version on the card, in place
    on ``stack`` and ``states`` and undone on the touched rows after
    every call: ``torch.equal`` on the touched rows of the stack and every
    state, nothing written elsewhere (checksums), times (the kernel also
    of the card alone), bound, registers and grid.  Returns the emitted
    record."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        bias_corrections,
    )

    R, D = stack.shape
    ok = sg.ok() & (sg.ids >= 0) & (sg.ids < R)
    rows = torch.unique(sg.ids[ok]).to(torch.int64)
    snap = RowSnapshot([stack, *states], rows)
    bc = bias_corrections(FusedOptimConfig(), 1)  # the Adam family's step 1
    args = (stack, states, optim, sg, lr, seed, bc)
    _update_call(tbe_backward.fused_sparse_update, *args)
    torch.cuda.synchronize()
    got = snap.take()
    kernel_intact = snap.intact()
    _update_call(tbe_backward.fused_sparse_update_plain, *args)
    ref = snap.take()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    equal = kernel_intact and all(torch.equal(a, b)
                                  for a, b in zip(got, ref))
    touched = int((got[0] != snap.saved[0]).any(dim=1).sum())
    sr_rows = None
    if seed is not None:
        _update_call(tbe_backward.fused_sparse_update_plain, stack, states,
                     optim, sg, lr, None, bc)
        sr_rows = int((snap.take()[0] != ref[0]).sum())
    if not equal:
        raise AssertionError(f"fused_sparse_update {optim} {common}: kernel "
                             f"!= plain (max abs err {err}, nothing "
                             f"written elsewhere: {kernel_intact})")
    if seed is not None and not sr_rows:
        raise AssertionError("bfloat16 update did not round stochastically")
    prep = tbe_backward.sort_by_row(sg.ids, sg.valid, sg.segments,
                                    sg.weights, R, sg.grad_seg.shape[0])

    def launch():
        tbe_backward.launch_fused_sparse_update(
            stack, states, *prep, sg.grad_seg, optim, lr, EPS, 0.0,
            (0.9, 0.999), bc, seed)

    U, nbytes, flops = _update_bound(D, stack.element_size(), sg, optim)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "fused_sparse_update",
        "optim": optim, **common, "kept": int(ok.sum()), "distinct": U,
        "touched_rows": touched,
        "rows_past_2^31_bytes": int((rows * D * 4 >= FAR_BYTES).sum()),
        "sr_seed": seed, "sr_differs_from_nearest": sr_rows,
        "equal": True, "max_abs_err": err,
        **_launch_facts("fused_sparse_update", optim, stack.dtype, sg, R),
        "ms": cuda_ms(lambda: _update_call(
            tbe_backward.fused_sparse_update, *args), flush,
            setup=snap.restore),
        "kernel_ms": cuda_ms(launch, flush, setup=snap.restore),
        "kernel_device_ms": cuda_ms(launch, flush, setup=snap.restore,
                                    device_only=True),
        "plain_ms": cuda_ms(lambda: _update_call(
            tbe_backward.fused_sparse_update_plain, *args), flush,
            runs=PLAIN_RUNS, warmup=1, setup=snap.restore),
        "library_ms": None,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    snap.restore()
    emit(rec)
    return rec


def b1_row(flush, phase, stack, ids, segs, w, S, common, regions):
    """B1 on the card at these inputs, through both entries: the region
    entry (the main paths' call: ``regions``, no sort) and the sorted one
    (``segs``), each ``torch.equal`` to the plain version; the region
    entry checked for host syncs (``set_sync_debug_mode("error")``) and
    its peak memory held to its output plus the lengths' running ends.
    Times: each entry's wrapper, the kernel on prepared inputs (the region
    entry's ends, the sorted entry's sort; host time in, and of the card
    alone), the plain version, ``F.embedding_bag`` over the sorted valid
    slots; and the bound.  Returns the emitted record."""
    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.ops import tbe

    R, D = stack.shape
    args = (stack, ids, segs, S, w)
    rargs = (stack, ids, regions, w)
    got = tbe.pooled_lookup_regions(*rargs)
    got_sorted = tbe.pooled_lookup(*args)
    torch.cuda.synchronize()
    ref = tbe.pooled_lookup_plain(*args)
    err = max(float((g.float() - ref.float()).abs().max())
              for g in (got, got_sorted))
    if not (torch.equal(got, ref) and torch.equal(got_sorted, ref)):
        raise AssertionError(f"pooled_lookup {common}: kernel != plain "
                             f"(max abs err {err})")
    # the region entry, cumsum and launch, must not synchronise
    torch.cuda.set_sync_debug_mode("error")
    try:
        tbe.pooled_lookup_regions(*rargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    lens = regions.lengths
    ends_bytes = -(-lens.numel() * lens.element_size() // 512) * 512
    peak, out_bytes = memory_of(lambda: tbe.pooled_lookup_regions(*rargs))
    if peak > out_bytes + ends_bytes:
        raise AssertionError(f"pooled_lookup {common}: peak {peak} bytes > "
                             f"output {out_bytes} + ends {ends_bytes}")
    ends = tbe.region_ends(lens)
    sids, sw, offs = tbe.sort_by_segment(ids, segs, w, S, R)
    n = int(offs[-1])
    lib_ids, lib_offs = sids[:n].to(torch.int64), offs.to(torch.int64)
    lib_w = sw[:n].to(stack.dtype)

    def kernel():
        return tbe.launch_pooled(stack, ids, w, ends, regions.starts,
                                 regions.caps, regions.counts)

    def sorted_kernel():
        return tbe.launch_pooled(stack, sids, sw, offs[1:], (0,),
                                 (ids.numel(),), (S,))

    def library():
        return F.embedding_bag(lib_ids, stack, lib_offs, mode="sum",
                               per_sample_weights=lib_w,
                               include_last_offset=True)

    U, nbytes, flops = _b1_bound(R, D, stack.element_size(), ids, segs, w, S)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "pooled_lookup", **common,
        "valid": n, "distinct": U, "regions": len(regions.counts),
        "equal": True, "max_abs_err": err, "wrapper_syncs": False,
        "peak_bytes": peak, "out_bytes": out_bytes,
        "ends_bytes": ends_bytes,
        "ms": cuda_ms(lambda: tbe.pooled_lookup_regions(*rargs), flush),
        "kernel_ms": cuda_ms(kernel, flush),
        "kernel_device_ms": cuda_ms(kernel, flush, device_only=True),
        "sorted_ms": cuda_ms(lambda: tbe.pooled_lookup(*args), flush),
        "sorted_kernel_ms": cuda_ms(sorted_kernel, flush),
        "sorted_kernel_device_ms": cuda_ms(sorted_kernel, flush,
                                           device_only=True),
        "plain_ms": cuda_ms(lambda: tbe.pooled_lookup_regions_plain(*rargs),
                            flush, runs=PLAIN_RUNS, warmup=1),
        "library_ms": cuda_ms(library, flush),
        "library_device_ms": cuda_ms(library, flush, device_only=True),
        "library_max_abs_diff": float(
            (library().float() - got.float()).abs().max()),
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(rec)
    return rec


def b4_row(flush, phase, stack, ids, segs, w, S, common):
    """B4 against its plain version on the card at these inputs
    (``torch.equal``), its wrapper checked for host syncs
    (``set_sync_debug_mode("error")``) and its peak memory held to its
    output plus what the sized prep alone allocates, with times (the
    kernel and ``F.embedding_bag`` over the sorted valid slots also of the
    card alone) and the bound.  Returns the emitted record."""
    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.ops import tbe

    R, D = stack.shape
    args = (stack, ids, segs, S, w)
    got = tbe.dedup_pooled_lookup(*args)
    torch.cuda.synchronize()
    ref = tbe.dedup_pooled_lookup_plain(*args)
    err = float((got.float() - ref.float()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"dedup_pooled_lookup {common}: kernel != "
                             f"plain (max abs err {err})")
    # the wrapper, prep and launch, must not synchronise with the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        tbe.dedup_pooled_lookup(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # one call allocates its output and, at most, what the sized prep
    # alone allocates: no copy of the distinct rows
    prep_peak, _ = memory_of(lambda: tbe.dedup_prepare_sized(ids, segs,
                                                             w, S))
    peak, out_bytes = memory_of(lambda: tbe.dedup_pooled_lookup(*args))
    if peak > out_bytes + prep_peak:
        raise AssertionError(f"dedup_pooled_lookup {common}: peak {peak} "
                             f"bytes > output {out_bytes} + prep "
                             f"{prep_peak}")
    prep = tbe.dedup_prepare_sized(ids, segs, w, S)
    sids, sw, offs = tbe.sort_by_segment(ids, segs, w, S, R)
    n = int(offs[-1])
    lib_ids, lib_offs = sids[:n].to(torch.int64), offs.to(torch.int64)
    lib_w = sw[:n].to(stack.dtype)

    def library():
        return F.embedding_bag(
            lib_ids, stack, lib_offs, mode="sum",
            per_sample_weights=lib_w, include_last_offset=True)

    def kernel():
        return tbe.launch_dedup_pooled(stack, *prep)

    U, nbytes, flops = _b1_bound(R, D, stack.element_size(), ids, segs,
                                 w, S)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": phase, "kernel": "dedup_pooled_lookup",
        **common, "distinct": U, "peak_bytes": peak,
        "out_bytes": out_bytes, "prep_peak_bytes": prep_peak,
        "wrapper_syncs": False, "equal": True, "max_abs_err": err,
        "ms": cuda_ms(lambda: tbe.dedup_pooled_lookup(*args), flush),
        "kernel_ms": cuda_ms(kernel, flush),
        "kernel_device_ms": cuda_ms(kernel, flush, device_only=True),
        "plain_ms": cuda_ms(lambda: tbe.dedup_pooled_lookup_plain(*args),
                            flush, runs=PLAIN_RUNS, warmup=1),
        "library_ms": cuda_ms(library, flush),
        "library_device_ms": cuda_ms(library, flush, device_only=True),
        "library_max_abs_diff": float(
            (library().float() - got.float()).abs().max()),
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(rec)
    return rec


def tw_b1_inputs(lay, kjt):
    """A table-wise group's lookup inputs both ways: (ids, weights,
    segments, the segment count, the slots' regions)."""
    from torchrec_tpu_torch.parallel.sharding.tw import (
        tw_regions,
        tw_segments,
        tw_slot_stream,
    )

    ids, w, lengths = tw_slot_stream(lay, kjt)
    return (ids, w, *tw_segments(lay, lengths), tw_regions(lay, lengths))


def _zipf_slots(lay, rows, seed):
    """Zipf(1.1) ids in the layout's ``[F * C]`` slot stream, each slot's
    ids drawn over its own table's rows and offset into the stack."""
    import torch

    rng = np.random.RandomState(seed)
    ids = np.stack([zipf_ids(rng, lay.cap, r) for r in rows])
    ids = ids + lay.row_offset[0][: len(rows), None]
    return torch.from_numpy(ids.reshape(-1).astype(np.int32))


def train_kernel_phase(dev, flush, dmp, state, batch):
    """B1 and B2 (rowwise Adagrad) against their plain versions on the
    card, at the shapes the training step gives them: the group's
    ``[2,600,000, 128]`` stack (the trainer's float32 one, and its
    bfloat16 cast), the slots of one bench batch (V = S = 106,496, about
    half valid), the batch's uniform ids and Zipf(1.1) ids drawn per
    feature, weight decay 0, a random ``[S, 128]`` upstream gradient;
    bfloat16 with stochastic rounding.  Returns the records it emits."""
    import torch

    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack32 = state["tables"][name]
    mom = state["fused"][name]["momentum"]
    ids_u, w, segs, S, regions = tw_b1_inputs(lay, batch.sparse_features)
    ids_z = _zipf_slots(lay, [TRAIN_ROWS] * TRAIN_FEATURES, seed=5).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        stack = stack32 if dtype == torch.float32 else stack32.to(dtype)
        seed = SR_SEED if dtype == torch.bfloat16 else None
        for dist, ids in (("uniform", ids_u), ("zipf", ids_z)):
            common = {"dtype": str(dtype).replace("torch.", ""),
                      "ids": dist, "rows": stack.shape[0], "D": DIM,
                      "S": S, "V": ids.numel()}
            rows.append(b1_row(flush, "train_kernel", stack, ids, segs, w,
                               S, common, regions))
            sg = SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad)
            rows.append(b2_row(flush, "train_kernel", stack, [mom],
                               "rowwise_adagrad", sg, TRAIN_LR, seed,
                               common))
        del stack
    torch.cuda.empty_cache()
    return rows


def train_path_check(dmp, state, batch, sr_seed, phase="train_path_check",
                     lr=None):
    """On one batch at full width, the step's own calls: B1's pooled
    output (the KT values) ``torch.equal`` to the plain version's, and
    B2's updated stack and optimizer state, from the step's real
    gradient, equal to the plain version's on the touched rows, with
    nothing written elsewhere (checksums; the touched rows are undone
    after each, so no stack is copied whole).  ``lr``: the fused update's
    learning rate for this step (a schedule's; the config's if None).  A stack larger than
    ``FAR_BYTES`` must be touched past them; with a bfloat16 stack and a
    seed, the stochastically rounded stack must differ from
    round-to-nearest.  The state is left as it was.  Returns the emitted
    record."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        apply_sparse_update_segments,
    )
    from torchrec_tpu_torch.parallel.sharding.tw import (
        tw_backward_local,
        tw_output_features,
    )

    ebc = dmp.sharded_ebc
    (name, lay), = ebc.tw_layouts.items()
    stack = state["tables"][name]
    fused = state["fused"][name]
    states = [fused[k] for k in ("momentum", "m", "v") if k in fused]
    kt, ctxs = dmp.sparse_forward(state, batch)
    ids, w, segs = ctxs[name][:3]
    S = lay.f_max * lay.world_size * lay.batch_size
    plain = tbe.pooled_lookup_plain(stack, ids, segs, S, w)
    kt_plain = ebc.output_kt(tw_output_features(lay, plain)).values()
    b1_err = float((kt.float() - kt_plain.float()).abs().max())
    loss, _, _, grad_by_feature = dmp.dense_forward_backward(state, batch,
                                                             kt)
    sg = tw_backward_local(lay, ctxs[name], grad_by_feature)
    cfg = dmp.fused_config
    R, D = stack.shape
    rows = torch.unique(sg.ids[sg.ok()]).to(torch.int64)
    snap = RowSnapshot([stack, *states], rows)
    apply_sparse_update_segments(stack, fused, sg, cfg, sr_seed=sr_seed,
                                 learning_rate=lr)
    torch.cuda.synchronize()
    got = snap.take()
    intact = snap.intact()

    def plain_update(seed):
        _update_call(tbe_backward.fused_sparse_update_plain, stack, states,
                     cfg.optim.value, sg,
                     cfg.learning_rate if lr is None else lr, seed,
                     (1.0, 1.0))
        return snap.take()

    ref = plain_update(sr_seed)
    far = rows * D * 4 >= FAR_BYTES  # the f32 offsets of stack and state
    rec = {
        "phase": phase, "table_dtype": str(stack.dtype),
        "batch": lay.batch_size, "stack": list(stack.shape),
        "states": [list(st.shape) for st in states],
        "slots": int(ids.numel()), "valid_slots": int(sg.ok().sum()),
        "segments": S, "distinct_rows": int(rows.numel()),
        "touched_rows": int((got[0] != snap.saved[0]).any(dim=1).sum()),
        "rows_past_2^31_bytes": int(far.sum()),
        "largest_row": int(rows.max()), "loss": float(loss),
        "b1_equal": bool(torch.equal(kt, kt_plain)), "b1_max_abs_err": b1_err,
        "b2_nothing_written_elsewhere": intact,
        "b2_table_equal": bool(torch.equal(got[0], ref[0])),
        "b2_momentum_equal": all(torch.equal(a, b)
                                 for a, b in zip(got[1:], ref[1:])),
        "b2_max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, ref)),
        "sr_seed": sr_seed, "learning_rate": lr,
    }
    if sr_seed is not None:
        rec["sr_differs_from_nearest"] = int((plain_update(None)[0]
                                              != got[0]).sum())
    del got, ref, snap, kt, kt_plain, plain, sg, grad_by_feature
    emit(rec)
    if not (rec["b1_equal"] and rec["b2_table_equal"]
            and rec["b2_momentum_equal"] and intact):
        raise AssertionError(f"{phase} failed: {rec}")
    if R * D * 4 > FAR_BYTES and not rec["rows_past_2^31_bytes"]:
        raise AssertionError(f"{phase}: no touched row lies past 2^31 bytes")
    if sr_seed is not None and not rec["sr_differs_from_nearest"]:
        raise AssertionError("bfloat16 update did not round stochastically")
    return rec


def _train_steps(dmp, state, batches, n):
    """``n`` train steps cycling ``batches``, ending in a synchronise;
    returns (state, losses as floats, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(n):
        state, m = dmp.train_step(state, batches[i % len(batches)])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return state, [float(x) for x in losses], dt


def train_phase(dev, flush):
    """The training main path, float32 tables then the bfloat16 arm.
    Returns (training launches per kernel, the train_kernel records, the
    path checks)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    card = nvidia_smi_line()  # beside every training number
    t0 = time.perf_counter()
    dmp, state, batches = build_trainer(dev, torch.float32)
    torch.cuda.synchronize()
    emit({"phase": "train_setup", "table_dtype": "float32",
          "seconds": time.perf_counter() - t0,
          "stacks": {k: list(v.shape) for k, v in state["tables"].items()},
          "memory_allocated": torch.cuda.memory_allocated()})
    kernel_rows = train_kernel_phase(dev, flush, dmp, state, batches[0])
    checks = [train_path_check(dmp, state, batches[0], None)]

    # the main path: 1 warm-up step, then TRAIN_STEPS timed steps cycling
    # the batches (bench.py's timed_run)
    launches = dict.fromkeys(tbe.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    state, warm, _ = _train_steps(dmp, state, batches[:1], 1)
    state, losses, dt = _train_steps(dmp, state, batches, TRAIN_STEPS)
    counts = tbe.launch_counts()
    rec = {"phase": "train", "card": card, "table_dtype": "float32",
           "batch": TRAIN_BATCH,
           "steps": 1 + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts,
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    _check_train(rec, counts, 1 + TRAIN_STEPS)
    for k, v in counts.items():
        launches[k] += v
    profile_calls({"phase": "train_profile", "card": card,
                   "table_dtype": "float32", "batch": TRAIN_BATCH},
                  lambda: dmp.train_step(state, batches[1]), 3, "step")
    del dmp, state
    torch.cuda.empty_cache()

    # the bfloat16-table arm: B1 over bfloat16 rows, B2 with stochastic
    # rounding from a per-step seed
    dmp, state, batches = build_trainer(dev, torch.bfloat16)
    checks.append(train_path_check(dmp, state, batches[0],
                                   dmp.sr_seeds(0)[0]))
    tbe.reset_launch_counts()
    state, losses, dt = _train_steps(dmp, state, batches, BF16_STEPS)
    counts = tbe.launch_counts()
    rec = {"phase": "train", "card": card, "table_dtype": "bfloat16",
           "batch": TRAIN_BATCH,
           "steps": BF16_STEPS, "samples_per_s": BF16_STEPS * TRAIN_BATCH / dt,
           "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
           "sr_seeds": [dmp.sr_seeds(s)[0] for s in range(BF16_STEPS)],
           "launches": counts}
    emit(rec)
    _check_train(rec, counts, BF16_STEPS)
    for k, v in counts.items():
        launches[k] += v
    del dmp, state, batches
    torch.cuda.empty_cache()
    return launches, kernel_rows, checks


def _check_train(rec, counts, steps):
    if not rec["all_finite"]:
        raise AssertionError(f"non-finite training loss: {rec['losses']}")
    want = {"pooled_lookup": steps, "fused_sparse_update": steps}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{steps} train steps launched {got}, want "
                             f"{want}")


# ---------------------------------------------------------------------------
# phase 4: the unsharded authoring path (EmbeddingBagCollection -> DLRM ->
# DLRMTrain) at the width of bench.py main()
# ---------------------------------------------------------------------------

# the device kernel names of the pooled lookups, by wrapper
POOLED_KERNEL_NAMES = {
    "tbe_pooled_kernel": "pooled_lookup",
    "dedup_pooled_kernel": "dedup_pooled_lookup",
    "q8_pooled_kernel": "quant_pooled_lookup_int8",
    "dedup_q_pool_kernel": "dedup_quant_pooled_lookup",
}
# DLRM_Projection's two interaction branches at this width: the shape of
# the JAX package's test (``(32, 2 * D)``) at D = 128
PROJECTION_BRANCH = (512, 2 * DIM)


def pooled_launches_profiled(call):
    """The pooled-lookup kernels one ``call`` launches on the card, by
    wrapper name, read from a ``torch.profiler`` trace (not from the
    wrappers' counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kname, wrapper in POOLED_KERNEL_NAMES.items():
            if kname in e.name:
                out[wrapper] = out.get(wrapper, 0) + 1
    return out


def ebc_forward_check(ebc, kjt, kernel, n_tables):
    """One forward of ``ebc``: its launches by the wrappers' counts and by
    the profile, each exactly ``n_tables`` of ``kernel`` and no other
    pooled kernel.  Returns (the KeyedTensor, the counts)."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    with torch.no_grad():
        kt = ebc(kjt)
        tbe.reset_launch_counts()
        profiled = pooled_launches_profiled(lambda: ebc(kjt))
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
    want = {kernel: n_tables}
    if counts != want or profiled != want:
        raise AssertionError(f"EBC forward ({kernel}) launched {counts}, "
                             f"profiled {profiled}; want {want}")
    return kt, counts


def ebc_grads(ebc, kjt, weights, g):
    """The table and per-id weight gradients of ``sum(ebc(kjt) * g)``,
    the KJT carrying ``weights``."""
    import torch

    w = weights.detach().requires_grad_()
    with torch.enable_grad():
        kt = ebc(kjt.with_values(kjt.values(), w))
        params = list(ebc.parameters())
        grads = torch.autograd.grad((kt.values() * g).sum(), params + [w])
    return grads


def ebc_phase(dev, flush):
    """The unsharded authoring path on the card.  Returns (the main run's
    launches, its kernel records, its check record)."""
    import torch

    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.models.dlrm import (
        DLRM,
        DLRM_DCN,
        DLRM_Projection,
        DLRMTrain,
    )
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
        EmbeddingConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
        EmbeddingCollection,
        key_regions,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    F = len(keys)
    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * F, [1] * F,
                          num_dense=NUM_DENSE, manual_seed=0)
    it = iter(ds)
    batches = [next(it).to(dev) for _ in range(TRAIN_BATCHES)]
    batch, kjt = batches[0], batches[0].sparse_features
    ebc = EmbeddingBagCollection(
        tables, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    torch.manual_seed(0)
    model = DLRM(ebc, NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=torch.bfloat16).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the kernels against their plain versions at the path's shapes: the
    # first table's lookup (one feature, V = S = 4096)
    ids, _, regions, _ = key_regions(kjt, [0])
    segs = regions.segment_ids(ids.numel())
    w = torch.ones(ids.shape, dtype=torch.float32, device=dev)
    table0 = getattr(ebc, tables[0].name).detach()
    S = regions.num_segments
    common = {"dtype": "float32", "ids": "ebc", "rows": TRAIN_ROWS, "D": DIM,
              "S": S, "V": ids.numel()}
    rows = [b1_row(flush, "ebc_kernel", table0, ids, segs, w, S, common,
                   regions),
            b4_row(flush, "ebc_kernel", table0, ids, segs, w, S, common)]

    # each forward: 26 launches of its kernel, none of another
    kt, tbe_counts = ebc_forward_check(ebc, kjt, "pooled_lookup", F)
    ebc_dedup = EmbeddingBagCollection(tables, device="meta",
                                       kernel="dedup")
    ebc_dedup.load_state_dict(ebc.state_dict(), assign=True)
    kt_dedup, dedup_counts = ebc_forward_check(ebc_dedup, kjt,
                                               "dedup_pooled_lookup", F)
    dedup_equal = bool(torch.equal(kt_dedup.values(), kt.values()))

    # sharded = unsharded: the one-device DMP's stack filled from the
    # EBC's own weights
    dmp = DistributedModelParallel(
        DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH), tables,
        table_wise_plan(tables), TRAIN_BATCH, dict(zip(keys, ds.caps)),
        device=dev)
    state = dmp.init(torch.Generator(device=dev).manual_seed(1))
    dmp.load_table_weights(state, {c.name: getattr(ebc, c.name).detach()
                                   for c in tables})
    with torch.no_grad():
        sharded, _ = dmp.sparse_forward(state, batch)
    sharded_equal = bool(torch.equal(sharded, kt.values())
                         and dmp.sharded_ebc.feature_order == kt.keys())
    sharded_err = float((sharded - kt.values()).abs().max())
    del dmp, state, sharded

    # the backward, twice on one batch: table and weight gradients equal
    gen = torch.Generator(device=dev).manual_seed(5)
    wts = torch.rand(kjt.values().shape, generator=gen, device=dev)
    g = torch.randn(kt.values().shape, generator=gen, device=dev)
    ebc_w = EmbeddingBagCollection(tables, is_weighted=True, device="meta")
    ebc_w.load_state_dict(ebc.state_dict(), assign=True)
    first = ebc_grads(ebc_w, kjt, wts, g)
    second = ebc_grads(ebc_w, kjt, wts, g)
    bwd_equal = all(torch.equal(a, b) for a, b in zip(first, second))
    del first, second, ebc_w

    # the sequence collection over the same rows: a row gather
    ec = EmbeddingCollection(
        [EmbeddingConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                         name=c.name, feature_names=c.feature_names)
         for c in tables], device="meta")
    ec.load_state_dict(ebc.state_dict(), assign=True)
    with torch.no_grad():
        seq = ec(kjt)
        ec_equal = True
        for c in tables:
            jt = kjt[c.feature_names[0]]
            want = getattr(ebc, c.name)[jt.values()]
            want[~jt.valid_mask()] = 0
            ec_equal &= bool(torch.equal(seq[c.feature_names[0]].values(),
                                         want))
    del seq, ec

    # DLRM_DCN and DLRM_Projection through the same collection
    with torch.no_grad():
        dcn = DLRM_DCN(ebc, NUM_DENSE, DENSE_ARCH, OVER_ARCH, DCN_LAYERS,
                       DCN_RANK, dense_dtype=torch.bfloat16).to(dev)
        proj = DLRM_Projection(ebc, NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                               PROJECTION_BRANCH, PROJECTION_BRANCH,
                               dense_dtype=torch.bfloat16).to(dev)
        other = {type(m).__name__: m(batch.dense_features, kjt)
                 for m in (dcn, proj)}
    others_finite = {k: bool(torch.isfinite(v).all()) and
                     tuple(v.shape) == (TRAIN_BATCH, 1)
                     for k, v in other.items()}
    del dcn, proj, other

    check = {
        "phase": "ebc_check", "card": card, "batch": TRAIN_BATCH,
        "tables": F, "rows": TRAIN_ROWS, "D": DIM,
        "setup_seconds": setup_s,
        "forward_launches": {"tbe": tbe_counts, "dedup": dedup_counts},
        "sharded_equal": sharded_equal, "sharded_max_abs_err": sharded_err,
        "dedup_equal": dedup_equal, "backward_deterministic": bwd_equal,
        "ec_equal": ec_equal, "others_finite": others_finite,
    }
    emit(check)
    if not (sharded_equal and dedup_equal and bwd_equal and ec_equal
            and all(others_finite.values())):
        raise AssertionError(f"ebc check failed: {check}")

    # the main path: DLRMTrain with autograd and the port's dense Adagrad
    # over every parameter, 1 warm-up and TRAIN_STEPS timed steps
    train = DLRMTrain(model)
    params = dict(model.named_parameters())
    tx = adagrad(TRAIN_LR)
    opt = tx.init(params)
    seen = torch.unique(torch.cat([
        b.sparse_features[keys[0]].values()[
            b.sparse_features[keys[0]].valid_mask()] for b in batches]))
    t0_rows = getattr(ebc, tables[0].name)
    looked = batches[0].sparse_features[keys[0]]
    looked = torch.unique(looked.values()[looked.valid_mask()])
    unseen = torch.ones(TRAIN_ROWS, dtype=torch.bool, device=dev)
    unseen[seen] = False
    before_looked = t0_rows[looked].detach().clone()
    before_unseen = _checksum(t0_rows.detach()[unseen])

    def step(b):
        loss, (loss_d, _, _) = train(b)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.update(params, dict(zip(params, grads)), opt)
        return loss_d

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    warm = [step(batches[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(batches[i % len(batches)]) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = tbe.launch_counts()
    losses = [float(x) for x in warm + losses]
    changed = (t0_rows[looked].detach() != before_looked).any(dim=1)
    rec = {"phase": "ebc", "card": card, "batch": TRAIN_BATCH,
           "steps": 1 + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": losses,
           "all_finite": bool(np.isfinite(losses).all()),
           "launches": counts,
           "looked_up_rows": int(looked.numel()),
           "looked_up_rows_changed": int(changed.sum()),
           "unseen_rows_unchanged": _checksum(t0_rows.detach()[unseen])
           == before_unseen,
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    want = {"pooled_lookup": F * (1 + TRAIN_STEPS)}
    got = {k: v for k, v in counts.items() if v}
    if not rec["all_finite"] or got != want:
        raise AssertionError(f"ebc steps: losses {losses}, launches {got}, "
                             f"want {want}")
    if not (rec["looked_up_rows_changed"] == rec["looked_up_rows"]
            and rec["unseen_rows_unchanged"]):
        raise AssertionError(f"ebc steps: the table rows moved wrongly: "
                             f"{rec}")
    profile_calls({"phase": "ebc_profile", "card": card,
                   "batch": TRAIN_BATCH},
                  lambda: step(batches[1]), 3, "step")
    launches = dict.fromkeys(tbe.LAUNCHES, 0)
    launches.update(counts)
    # the dedup arm's forward is a main path of B4 (one forward, F launches)
    launches["dedup_pooled_lookup"] += dedup_counts["dedup_pooled_lookup"]
    del train, model, ebc, ebc_dedup, params, opt, batches
    torch.cuda.empty_cache()
    return launches, rows, check


# ---------------------------------------------------------------------------
# phase 5: the bucketed training pipeline on the dedup kernels
# ---------------------------------------------------------------------------


def dedup_batches():
    """The first ``TRAIN_BATCHES`` batches of the dedup stream, on the
    host (the pipeline repacks and copies them per step)."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    F = len(keys)
    ds = RandomRecDataset(
        keys, TRAIN_BATCH, [TRAIN_ROWS] * F, [DEDUP_MAX_IDS] * F,
        num_dense=NUM_DENSE, manual_seed=0, min_ids_per_features=[1] * F,
        zipf_lengths=DEDUP_ZIPF_LENGTHS, zipf_ids=DEDUP_ZIPF_IDS)
    it = iter(ds)
    return keys, ds.caps, [next(it) for _ in range(TRAIN_BATCHES)]


def build_dedup_trainer(dev, keys, caps, optim, table_dtype):
    """``DistributedModelParallel`` of ``build_trainer`` at the dedup
    stream's caps, on the dedup kernels, with fused optimizer ``optim``
    (lr 0.05, the JAX defaults otherwise), and its state."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, table_wise_plan(tables), TRAIN_BATCH,
        dict(zip(keys, caps)),
        fused_config=FusedOptimConfig(optim=EmbOptimType(optim),
                                      learning_rate=TRAIN_LR),
        dense_optimizer=adagrad(TRAIN_LR), table_dtype=table_dtype,
        device=dev, lookup_kernel="dedup", update_kernel="dedup",
    )
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def _bucketing_config():
    from torchrec_tpu_torch.parallel.train_pipeline import BucketingConfig

    return BucketingConfig(**BUCKETING,
                           kernels={"pooled": "dedup", "update": "dedup"})


def bucketed_batch(dmp, batch, dev):
    """The batch repacked to its bucketed signature, on the card, and the
    clone of ``dmp`` for that signature (what the pipeline runs)."""
    import dataclasses

    kjt = batch.sparse_features
    sig = kjt.bucketed_caps(BUCKETING["floor"], BUCKETING["growth"])
    clone = dmp.with_feature_caps(dict(zip(kjt.keys(), sig)))
    return (dataclasses.replace(batch, sparse_features=kjt.repad(sig))
            .to(dev), clone, sig)


def _clone_state(state):
    """A deep copy of a train state (tensors cloned on their device)."""
    import torch

    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state.clone() if isinstance(state, torch.Tensor) else state


def _state_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return a == b


def dedup_kernel_phase(dev, flush, dmp, state, batch):
    """B4 and B6 against their plain versions on the card at the bucketed
    path's shapes: the ``[2,600,000, 128]`` stack and the first bucketed
    batch of the dedup stream (its real ids, segments and weights).  B4
    over the float32 stack and its bfloat16 cast, each with B1 on the same
    slots (one function, two designs, timed on one batch), B4's wrapper
    checked for host syncs (``set_sync_debug_mode("error")``) and its peak
    memory held to its output plus what the sized prep alone allocates;
    B6 for each of its eight optimizers on float32 and rowwise Adagrad on
    bfloat16 with stochastic rounding, each on fresh copies of the stack
    and of random states, with a random ``[S, 128]`` upstream gradient;
    then B6's runs arm (rowwise Adagrad over ``runs_slots``).  Times by
    ``cuda_ms`` (the kernels also of the card alone); the plain versions
    over ``PLAIN_RUNS`` runs.  Returns the records."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    bb, clone, sig = bucketed_batch(dmp, batch, dev)
    (name, lay), = clone.sharded_ebc.tw_layouts.items()
    stack32 = state["tables"][name]
    R, D = stack32.shape
    ids, w, segs, S, regions = tw_b1_inputs(lay, bb.sparse_features)
    valid = (segs < S) & (w != 0)
    common = {"rows": R, "D": D, "S": S, "V": ids.numel(),
              "valid": int(valid.sum()), "signature_slots": sum(sig)}
    gen = torch.Generator(device=dev).manual_seed(11)
    grad = torch.randn((S, D), generator=gen, device=dev) * 1e-2
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        stack = stack32 if dtype == torch.float32 else stack32.to(dtype)
        dname = str(dtype).replace("torch.", "")
        rows.append(b4_row(flush, "dedup_kernel", stack, ids, segs, w, S,
                           {"dtype": dname, **common}))
        rows.append(b1_row(flush, "dedup_kernel", stack, ids, segs, w, S,
                           {"dtype": dname, "ids": "bucketed", **common},
                           regions))
        del stack

    sg = SparseSegGrad(ids, valid, segs, w, grad)
    arms = [(o, torch.float32, None) for o in tbe_backward.OPTIMIZERS]
    arms.append(("rowwise_adagrad", torch.bfloat16, SR_SEED))
    for optim, dtype, seed in arms:
        stack = stack32 if dtype == torch.float32 else stack32.to(dtype)
        rows.append(b6_row(flush, stack, optim, sg, seed, gen, common))
        del stack
    # the runs arm: runs of 1 to 10,000 slots, then the sentinel
    rsg = _runs_seg_grad(dev, R, grad, seed=13)
    rows.append(b6_row(flush, stack32, "rowwise_adagrad", rsg, None, gen,
                       {"rows": R, "D": D, "S": S, "V": rsg.ids.numel(),
                        "valid": int(rsg.valid.sum()), "ids": "runs"}))
    torch.cuda.empty_cache()
    return rows


def b6_row(flush, stack, optim, sg, seed, gen, common):
    """B6 with ``optim`` against its plain version on the card, each on
    its own copy of ``stack`` and of random states: ``torch.equal`` on the
    whole stack and every state, times (the kernel also of the card
    alone), bound, registers and grid.  Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        bias_corrections,
    )

    R, D = stack.shape
    states = [
        torch.rand((R,) if kind == "row" else (R, D), generator=gen,
                   device=stack.device) * 1e-2
        for kind in tbe_backward.STATE_LAYOUTS[optim]]
    # the Adam family's first step (the others ignore the corrections)
    kw = {"eps": EPS, "weight_decay": 0.0,
          "bias_corrections": bias_corrections(FusedOptimConfig(), 1),
          "sr_seed": seed}
    upd = (sg.ids, sg.valid, sg.segments, sg.weights, sg.grad_seg, optim,
           TRAIN_LR)
    tk, sk = stack.clone(), [s.clone() for s in states]
    tbe_backward.dedup_fused_sparse_update(tk, sk, *upd, **kw)
    torch.cuda.synchronize()
    tp, sp = stack.clone(), [s.clone() for s in states]
    tbe_backward.dedup_fused_sparse_update_plain(tp, sp, *upd, **kw)
    err = max([float((tk.float() - tp.float()).abs().max())]
              + [float((a - b).abs().max()) for a, b in zip(sk, sp)])
    equal = bool(torch.equal(tk, tp)) and all(
        torch.equal(a, b) for a, b in zip(sk, sp))
    touched = int((tk != stack).any(dim=1).sum())
    sr_rows = None
    if seed is not None:
        rn = stack.clone()
        tbe_backward.dedup_fused_sparse_update_plain(
            rn, [s.clone() for s in states], *upd, **{**kw, "sr_seed": None})
        sr_rows = int((rn != tk).sum())
        del rn
    del tp, sp
    if not equal:
        raise AssertionError(f"dedup_fused_sparse_update {optim} "
                             f"{stack.dtype} {common}: kernel != plain "
                             f"(max abs err {err})")
    if seed is not None and not sr_rows:
        raise AssertionError("bfloat16 update did not round stochastically")

    def restore():  # the timed calls update tk and sk in place
        tk.copy_(stack)
        for a, b in zip(sk, states):
            a.copy_(b)

    srt = tbe_backward.sort_by_row(sg.ids, sg.valid, sg.segments, sg.weights,
                                   R, sg.grad_seg.shape[0])

    def launch():
        tbe_backward.launch_dedup_fused_sparse_update(
            tk, sk, *srt, sg.grad_seg, optim, TRAIN_LR, EPS, 0.0,
            (0.9, 0.999), kw["bias_corrections"], seed)

    U, nbytes, flops = _update_bound(D, stack.element_size(), sg, optim)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {
        "phase": "dedup_kernel", "kernel": "dedup_fused_sparse_update",
        "optim": optim, "dtype": str(stack.dtype).replace("torch.", ""),
        **common, "kept": int(sg.ok().sum()), "distinct": U,
        "touched_rows": touched, "sr_seed": seed,
        "sr_differs_from_nearest": sr_rows, "equal": True,
        "max_abs_err": err,
        **_launch_facts("dedup_fused_sparse_update", optim, stack.dtype, sg,
                        R),
        "ms": cuda_ms(lambda: tbe_backward.dedup_fused_sparse_update(
            tk, sk, *upd, **kw), flush, setup=restore),
        "kernel_ms": cuda_ms(launch, flush, setup=restore),
        "kernel_device_ms": cuda_ms(launch, flush, setup=restore,
                                    device_only=True),
        "plain_ms": cuda_ms(
            lambda: tbe_backward.dedup_fused_sparse_update_plain(
                tk, sk, *upd, **kw),
            flush, runs=PLAIN_RUNS, warmup=1, setup=restore),
        "library_ms": None,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(rec)
    return rec


def dedup_path_check(dmp, state, batch, dev):
    """On the first batch at full width, the three checks of the dedup
    path: (1) B4's pooled output (the KT values of the bucketed step)
    ``torch.equal`` to B1's on the same slots; (2) B6's updated stack and
    momentum from the step's real gradient equal to its plain version's;
    (3) the state after one step at the bucketed signature equal to the
    state after the same step at the full-caps signature.  The state is
    left as it was.  Returns the emitted record."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import (
        apply_sparse_update_segments,
    )
    from torchrec_tpu_torch.parallel.sharding.tw import (
        tw_backward_local,
        tw_output_features,
    )

    bb, clone, sig = bucketed_batch(dmp, batch, dev)
    ebc = clone.sharded_ebc
    (name, lay), = ebc.tw_layouts.items()
    stack = state["tables"][name]
    mom = state["fused"][name]["momentum"]
    kt, ctxs = clone.sparse_forward(state, bb)
    ids, w, segs = ctxs[name][:3]
    S = lay.f_max * lay.world_size * lay.batch_size
    b1 = tbe.pooled_lookup(stack, ids, segs, S, w)
    kt_b1 = ebc.output_kt(tw_output_features(lay, b1)).values()
    loss, _, _, grad_by_feature = clone.dense_forward_backward(state, bb, kt)
    sg = tw_backward_local(lay, ctxs[name], grad_by_feature)
    cfg = clone.fused_config
    tk, mk = stack.clone(), mom.clone()
    apply_sparse_update_segments(tk, {"momentum": mk}, sg, cfg,
                                 update_kernel="dedup")
    torch.cuda.synchronize()
    tp, mp = stack.clone(), mom.clone()
    tbe_backward.dedup_fused_sparse_update_plain(
        tp, (mp,), sg.ids, sg.valid, sg.segments, sg.weights, sg.grad_seg,
        cfg.optim.value, cfg.learning_rate, cfg.eps, cfg.weight_decay)
    rec = {
        "phase": "dedup_path_check", "batch": lay.batch_size,
        "stack": list(stack.shape), "signature_slots": sum(sig),
        "full_slots": sum(dmp.feature_caps.values()),
        "valid_slots": int(sg.ok().sum()),
        "touched_rows": int((tk != stack).any(dim=1).sum()),
        "loss": float(loss),
        "b4_equals_b1": bool(torch.equal(kt, kt_b1)),
        "b4_max_abs_err": float((kt - kt_b1).abs().max()),
        "b6_table_equal": bool(torch.equal(tk, tp)),
        "b6_momentum_equal": bool(torch.equal(mk, mp)),
        "b6_max_abs_err": max(float((tk - tp).abs().max()),
                              float((mk - mp).abs().max())),
    }
    del tk, mk, tp, mp, kt, kt_b1, b1, sg, grad_by_feature
    bucketed = _clone_state(state)
    _, mb = clone.train_step(bucketed, bb)
    full = _clone_state(state)
    _, mf = dmp.train_step(full, batch.to(dev))
    rec["bucketed_equals_full_caps"] = bool(
        _state_equal(bucketed, full) and torch.equal(mb["loss"], mf["loss"]))
    del bucketed, full
    torch.cuda.empty_cache()
    emit(rec)
    if not (rec["b4_equals_b1"] and rec["b6_table_equal"]
            and rec["b6_momentum_equal"]
            and rec["bucketed_equals_full_caps"]):
        raise AssertionError(f"dedup path check failed: {rec}")
    return rec


def _pipeline_steps(pipe, it, n):
    """``n`` pipeline steps ending in a synchronise; returns (losses as
    floats, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [pipe.progress(it)["loss"] for _ in range(n)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0


def _check_dedup(rec, counts, steps):
    if not rec["all_finite"]:
        raise AssertionError(f"non-finite training loss: {rec['losses']}")
    want = {"dedup_pooled_lookup": steps, "dedup_fused_sparse_update": steps}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{steps} dedup steps launched {got}, want "
                             f"{want}")


def train_dedup_phase(dev, flush):
    """The bucketed training pipeline on the dedup kernels: the kernels
    at the path's shapes, the path checks, 1 warm-up and 20 timed
    rowwise-Adagrad steps over 4 cycled batches, three profiled steps,
    then 3 steps of each other optimizer and 3 steps of the bfloat16-table
    arm.  Returns (the main run's launches, the dedup_kernel records, the
    path check)."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.parallel.train_pipeline import (
        BucketedTrainPipeline,
    )

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys, caps, batches = dedup_batches()
    occ = [b.sparse_features.occupancy_per_key() for b in batches]
    dmp, state = build_dedup_trainer(dev, keys, caps, "rowwise_adagrad",
                                     torch.float32)
    torch.cuda.synchronize()
    emit({"phase": "train_dedup_setup", "seconds": time.perf_counter() - t0,
          "full_caps_slots": sum(caps), "ids_per_batch": [sum(o) for o in occ],
          "max_ids_per_feature": max(max(o) for o in occ),
          "stacks": {k: list(v.shape) for k, v in state["tables"].items()},
          "memory_allocated": torch.cuda.memory_allocated()})
    kernel_rows = dedup_kernel_phase(dev, flush, dmp, state, batches[0])
    check = dedup_path_check(dmp, state, batches[0], dev)

    # the main path: 1 warm-up and TRAIN_STEPS timed steps, then the
    # profiled steps (1 + 3 + 3 calls), from one finite stream
    n_main = 1 + TRAIN_STEPS
    stream = iter([batches[i % len(batches)] for i in range(n_main + 7)])
    pipe = BucketedTrainPipeline(dmp, state, _bucketing_config())
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    warm, _ = _pipeline_steps(pipe, stream, 1)
    losses, dt = _pipeline_steps(pipe, stream, TRAIN_STEPS)
    counts = tbe.launch_counts()
    stats = pipe.stats
    rec = {"phase": "train_dedup", "card": card, "optim": "rowwise_adagrad",
           "table_dtype": "float32", "batch": TRAIN_BATCH, "steps": n_main,
           "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts,
           "signatures": {str(sum(s)): n
                          for s, n in stats.dispatch_counts.items()},
           "padding": stats.scalar_metrics(),
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    _check_dedup(rec, counts, n_main)
    main_counts = counts
    profile_calls({"phase": "train_dedup_profile", "card": card,
                   "batch": TRAIN_BATCH}, lambda: pipe.progress(stream), 3,
                  "step")
    del pipe, dmp, state
    torch.cuda.empty_cache()

    # 3 steps for each other optimizer, then the bfloat16-table arm
    arms = [(o, torch.float32) for o in tbe_backward.OPTIMIZERS
            if o != "rowwise_adagrad"]
    arms.append(("rowwise_adagrad", torch.bfloat16))
    for optim, dtype in arms:
        dmp, state = build_dedup_trainer(dev, keys, caps, optim, dtype)
        pipe = BucketedTrainPipeline(dmp, state, _bucketing_config())
        tbe.reset_launch_counts()
        losses, dt = _pipeline_steps(pipe, iter(batches[:ARM_STEPS]),
                                     ARM_STEPS)
        counts = tbe.launch_counts()
        rec = {"phase": "train_dedup_arm", "optim": optim,
               "table_dtype": str(dtype).replace("torch.", ""),
               "steps": ARM_STEPS,
               "samples_per_s": ARM_STEPS * TRAIN_BATCH / dt,
               "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
               "launches": counts,
               "fused_step": next(iter(pipe.state["fused"].values()))
               .get("step")}
        emit(rec)
        _check_dedup(rec, counts, ARM_STEPS)
        del pipe, dmp, state
        torch.cuda.empty_cache()
    return main_counts, kernel_rows, check


# ---------------------------------------------------------------------------
# phase 6: MLPerf DLRM-v2 (DLRM_DCN) training on the per-id kernels
# ---------------------------------------------------------------------------


def dcn_batches(row_cap):
    """The MLPerf DLRM-v2 tables' row counts capped at ``row_cap``, their
    feature caps, and the first ``TRAIN_BATCHES`` batches of the fixed
    multi-hot stream over them, on the host."""
    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys = list(DEFAULT_CAT_NAMES)
    rows = [min(r, row_cap) for r in MLPERF_DLRM_V2_ROWS]
    hot = list(MLPERF_DLRM_V2_MULTI_HOT)
    ds = RandomRecDataset(keys, DCN_BATCH, rows, hot, num_dense=NUM_DENSE,
                          manual_seed=0, min_ids_per_features=hot)
    it = iter(ds)
    return keys, rows, ds.caps, [next(it) for _ in range(TRAIN_BATCHES)]


def build_dcn_trainer(dev, keys, rows, caps, optim, table_dtype):
    """``DistributedModelParallel`` of ``DLRM_DCN`` at the recipe's widths
    over tables of ``rows``, on the per-id kernels, with fused optimizer
    ``optim`` (lr 0.004, eps 1e-8, the JAX defaults otherwise), and its
    state from a seeded generator on the card."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM_DCN
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = tuple(
        EmbeddingBagConfig(num_embeddings=r, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k, r in zip(keys, rows))
    torch.manual_seed(0)  # the module's own init; dmp.init draws the state
    model = DLRM_DCN(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                     DCN_LAYERS, DCN_RANK, dense_dtype=torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, table_wise_plan(tables), DCN_BATCH,
        dict(zip(keys, caps)),
        fused_config=FusedOptimConfig(optim=EmbOptimType(optim),
                                      learning_rate=DCN_LR, eps=EPS),
        dense_optimizer=adagrad(DCN_LR), table_dtype=table_dtype,
        device=dev, lookup_kernel="tbe", update_kernel="tbe",
    )
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def dcn_crossnet(flush, dmp, card):
    """The cross net's forward and backward alone at the path's shape
    (``[8192, 3456]`` float32, rank 512, 3 layers): time by CUDA events
    against the float32 operations bound, and the names of the GEMM
    kernels it launches (which mark it in the step's profile)."""
    import torch

    net = dmp.model.inter_arch.crossnet
    width = net.w_0.shape[0]
    gen = torch.Generator(device=dmp.device).manual_seed(3)
    x = torch.randn((DCN_BATCH, width), generator=gen, device=dmp.device)
    x.requires_grad_()

    def fwd_bwd():
        net(x).sum().backward()

    # per layer: forward 2 products of 2*B*d*r flops, backward 4
    flops = DCN_LAYERS * 12 * DCN_BATCH * width * DCN_RANK
    ms = cuda_ms(fwd_bwd, flush, runs=10)
    prof = profile_calls({"phase": "dcn_crossnet_profile", "card": card,
                          "batch": DCN_BATCH}, fwd_bwd, 3, "call")
    gemms = {n for n in prof["device_names"] if "gemm" in n.lower()}
    rec = {"phase": "dcn_crossnet", "card": card, "batch": DCN_BATCH,
           "width": width, "rank": DCN_RANK, "layers": DCN_LAYERS,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "ms_fwd_bwd": ms, "flops": flops,
           "bound_ms": flops / PEAK_F32_FLOPS * 1e3,
           "tflops_per_s": flops / ms / 1e9, "gemm_kernels": sorted(gemms)}
    emit(rec)
    net.zero_grad(set_to_none=True)
    return rec


def train_dcn_phase(dev, flush):
    """MLPerf DLRM-v2 training on the per-id kernels: the kernels at the
    path's shapes, the path check, 1 warm-up and 20 timed per-element
    Adagrad steps over 4 cycled batches, the cross net alone, three
    profiled steps; then at the 1,000,000-row cap B2's other optimizers
    and bfloat16 rows, and 3 steps of each other optimizer and of the
    bfloat16-table arm.  Returns (the main run's launches, the dcn_kernel
    records, the path check)."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad

    card = nvidia_smi_line()
    t0 = time.perf_counter()
    keys, rows, caps, host = dcn_batches(DCN_ROW_CAP)
    dmp, state = build_dcn_trainer(dev, keys, rows, caps, "adagrad",
                                   torch.float32)
    batches = [b.to(dev) for b in host]
    del host
    torch.cuda.synchronize()
    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack = state["tables"][name]
    mom = state["fused"][name]["momentum"]
    emit({"phase": "train_dcn_setup", "seconds": time.perf_counter() - t0,
          "stacks": {k: list(v.shape) for k, v in state["tables"].items()},
          "momentum": list(mom.shape), "slot_cap": lay.cap,
          "ids_per_batch": int(batches[0].sparse_features.lengths().sum()),
          "memory_allocated": torch.cuda.memory_allocated()})

    # B1 and B2 (Adagrad) at the path's shapes: the batch's ids, Zipf ids
    ids_u, w, segs, S, regions = tw_b1_inputs(lay,
                                              batches[0].sparse_features)
    ids_z = _zipf_slots(lay, rows, seed=5).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    kernel_rows = []
    for dist, ids in (("uniform", ids_u), ("zipf", ids_z)):
        common = {"dtype": "float32", "ids": dist, "rows": stack.shape[0],
                  "D": DIM, "S": S, "V": ids.numel()}
        kernel_rows.append(b1_row(flush, "dcn_kernel", stack, ids, segs, w,
                                  S, common, regions))
        sg = SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad)
        kernel_rows.append(b2_row(flush, "dcn_kernel", stack, [mom],
                                  "adagrad", sg, DCN_LR, None, common))
    # the runs arm: runs of 1 to 10,000 slots, then the sentinel
    sg = _runs_seg_grad(dev, stack.shape[0], grad, seed=17)
    kernel_rows.append(b2_row(
        flush, "dcn_kernel", stack, [mom], "adagrad", sg, DCN_LR, None,
        {"dtype": "float32", "ids": "runs", "rows": stack.shape[0], "D": DIM,
         "S": S, "V": sg.ids.numel()}))
    del ids_z, grad, sg
    check = train_path_check(dmp, state, batches[0], None, "dcn_path_check")

    # the main path: 1 warm-up step, then TRAIN_STEPS timed steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tbe.reset_launch_counts()
    state, warm, _ = _train_steps(dmp, state, batches[:1], 1)
    state, losses, dt = _train_steps(dmp, state, batches, TRAIN_STEPS)
    counts = tbe.launch_counts()
    rec = {"phase": "train_dcn", "card": card, "optim": "adagrad",
           "table_dtype": "float32", "batch": DCN_BATCH,
           "steps": 1 + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * DCN_BATCH / dt,
           "ms_per_step": dt * 1e3 / TRAIN_STEPS, "losses": warm + losses,
           "all_finite": bool(np.isfinite(warm + losses).all()),
           "launches": counts,
           "peak_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    _check_train(rec, counts, 1 + TRAIN_STEPS)
    main_counts = counts
    cross = dcn_crossnet(flush, dmp, card)
    profile_calls({"phase": "train_dcn_profile", "card": card,
                   "batch": DCN_BATCH, "marked": "cross-net GEMMs"},
                  lambda: dmp.train_step(state, batches[1]), 3, "step",
                  marked=set(cross["gemm_kernels"]))
    del dmp, state, stack, mom, batches, ids_u, w, segs, regions
    torch.cuda.empty_cache()

    # at the 1,000,000-row cap: B2's other optimizers on float32 and all
    # eight on bfloat16 with stochastic rounding, on the first batch's
    # slots, random states and a random gradient
    keys, rows, caps, host = dcn_batches(DCN_ARM_ROW_CAP)
    batches = [b.to(dev) for b in host]
    dmp, state = build_dcn_trainer(dev, keys, rows, caps, "sgd",
                                   torch.float32)
    (name, lay), = dmp.sharded_ebc.tw_layouts.items()
    stack32 = state["tables"][name]
    ids, w, segs, S, _ = tw_b1_inputs(lay, batches[0].sparse_features)
    grad = torch.randn((S, DIM), generator=gen, device=dev) * 1e-2
    sg = SparseSegGrad(ids, (segs < S) & (w != 0), segs, w, grad)
    arms = [(o, torch.float32, None) for o in tbe_backward.OPTIMIZERS
            if o != "adagrad"]
    arms += [(o, torch.bfloat16, SR_SEED) for o in tbe_backward.OPTIMIZERS]
    R = stack32.shape[0]
    for optim, dtype, seed in arms:
        st = stack32 if dtype == torch.float32 else stack32.to(dtype)
        states = [
            torch.rand((R,) if kind == "row" else (R, DIM), generator=gen,
                       device=dev) * 1e-2
            for kind in tbe_backward.STATE_LAYOUTS[optim]]
        common = {"dtype": str(dtype).replace("torch.", ""), "ids": "uniform",
                  "rows": R, "D": DIM, "S": S, "V": ids.numel()}
        kernel_rows.append(b2_row(flush, "dcn_kernel", st, states, optim, sg,
                                  DCN_LR, seed, common))
        del st, states
    del dmp, state, stack32, sg, grad, ids, w, segs
    torch.cuda.empty_cache()

    # 3 steps of each other optimizer, then the bfloat16-table arm
    arms = [(o, torch.float32) for o in tbe_backward.OPTIMIZERS
            if o != "adagrad"]
    arms.append(("adagrad", torch.bfloat16))
    for optim, dtype in arms:
        dmp, state = build_dcn_trainer(dev, keys, rows, caps, optim, dtype)
        tbe.reset_launch_counts()
        state, losses, dt = _train_steps(dmp, state, batches, ARM_STEPS)
        counts = tbe.launch_counts()
        rec = {"phase": "train_dcn_arm", "optim": optim,
               "table_dtype": str(dtype).replace("torch.", ""),
               "rows": sum(rows), "steps": ARM_STEPS,
               "samples_per_s": ARM_STEPS * DCN_BATCH / dt,
               "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
               "launches": counts,
               "fused_step": next(iter(state["fused"].values())).get("step")}
        emit(rec)
        _check_train(rec, counts, ARM_STEPS)
        del dmp, state
        torch.cuda.empty_cache()
    return main_counts, kernel_rows, check


# ---------------------------------------------------------------------------
# phase 7: serving at full width
# ---------------------------------------------------------------------------


def _random_int8_tables(dev, tables, seed):
    """Codes, scales and biases drawn on the device from a seeded
    generator (dequantized values in about [-0.05, 0.06])."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {}
    for cfg in tables:
        R = cfg.num_embeddings
        params[cfg.name] = {
            "q": torch.randint(0, 256, (R, cfg.embedding_dim), generator=gen,
                               device=dev, dtype=torch.uint8),
            "scale": (torch.rand(R, generator=gen, device=dev) + 0.5)
            * (0.1 / 255),
            "bias": torch.rand(R, generator=gen, device=dev) * 0.01 - 0.05,
        }
    return params


def _requests(batch, num_features):
    """Split one dataset batch into single-example requests."""
    kjt = batch.sparse_features
    B = kjt.stride()
    lengths = kjt.lengths().numpy().reshape(num_features, B)
    values = kjt.values().numpy()
    offs = kjt.cap_offsets()
    per_feat = []
    for f in range(num_features):
        starts = np.concatenate([[0], np.cumsum(lengths[f])])
        per_feat.append([values[offs[f] + starts[b]: offs[f] + starts[b + 1]]
                         for b in range(B)])
    dense = batch.dense_features.numpy()
    return [(dense[b], [per_feat[f][b] for f in range(num_features)])
            for b in range(B)]


def _serve(server, requests):
    """Send ``requests`` from NUM_CLIENTS threads; returns (scores,
    per-request latencies in ms, wall seconds)."""
    scores = np.full((len(requests),), np.nan, np.float64)
    lat = np.zeros((len(requests),), np.float64)
    errors = []

    def client(k):
        try:
            for i in range(k, len(requests), NUM_CLIENTS):
                t0 = time.perf_counter()
                scores[i] = server.predict(*requests[i])
                lat[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # reported below, after every join
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(NUM_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        raise RuntimeError(f"serving clients failed: {errors[:3]}")
    return scores, lat, wall


def _direct_batch(requests, features, caps, dev):
    """The requests as one formed batch (KJT, dense) on ``dev``."""
    import torch

    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    B, F = len(requests), len(features)
    lengths = np.asarray([[len(x) for x in ids] for _, ids in requests],
                         np.int32)
    values = np.concatenate([np.asarray(requests[b][1][f], np.int64)
                             for f in range(F) for b in range(B)])
    kjt = KeyedJaggedTensor.from_lengths_packed(
        features, values, lengths.T.reshape(-1), caps=[c * B for c in caps])
    dense = torch.from_numpy(np.stack([d for d, _ in requests]))
    return kjt.to(dev), dense.to(dev)


def profile_serving(kernel, fn, batch, iters: int = 10):
    """Where one formed batch's time goes (:func:`profile_calls` over
    ``iters`` calls of the serving module)."""

    def step():
        fn(batch.dense_features, batch.sparse_features)

    profile_calls({"phase": "profile", "kernel": kernel,
                   "batch": batch.dense_features.shape[0]}, step, iters,
                  "batch")


def profile_calls(record, call, iters: int, unit: str, marked=None):
    """``torch.profiler`` over ``iters`` calls of ``call``, each ending in
    a synchronise, emitted as ``record`` plus the numbers per ``unit``.
    Device busy time is the sum of the device events (one stream, so
    they do not overlap; spans are left out); the rest of the profiled
    wall time the card is idle.  The same calls are timed once without the
    profiler, which gives the profiler's own cost and the idle share of
    the unprofiled wall.  ``marked`` (a set of names as the record gives
    them) adds the device time of those items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        call()
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    bare_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # a span (record_function) also shows as a device-side range over the
    # kernels it launched: it is not device work of its own
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    # a profiler that traced no device event measured nothing: report
    # the device numbers as not measured (null), never as an idle card
    busy_ms = (sum(e.time_range.elapsed_us() for e in device) / 1e3 / iters
               if device else None)
    by_name: dict = {}
    for e in device:
        # the C++ signature without its argument list, cut to 72 chars
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0][:72]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rec = {**record, "iters": iters,
           f"unprofiled_wall_ms_per_{unit}": bare_ms,
           f"wall_ms_per_{unit}": wall_ms,
           f"device_busy_ms_per_{unit}": busy_ms,
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / wall_ms),
           "device_idle_share_of_unprofiled_wall": (
               None if busy_ms is None else 1.0 - busy_ms / bare_ms),
           f"device_events_per_{unit}": len(device) / iters,
           f"top_device_ms_per_{unit}": {k: v / 1e3 / iters
                                         for k, v in top}}
    if marked is not None:
        rec[f"marked_device_ms_per_{unit}"] = sum(
            v for k, v in by_name.items() if k in marked) / 1e3 / iters
    # the sort kernels (radix sorts of slot streams), by name
    sorts = {k: v for k, v in by_name.items() if "sort" in k.lower()}
    rec[f"sort_device_ms_per_{unit}"] = {k: v / 1e3 / iters
                                         for k, v in sorts.items()}
    rec[f"sort_events_per_{unit}"] = sum(
        1 for e in device if "sort" in e.name.lower()) / iters
    emit(rec)
    rec["device_names"] = sorted(by_name)  # for the caller, not printed
    return rec


def path_kernel_phase(dev, tables, params, kjt, zipf_seed):
    """Each kernel against its plain version on the card, at the shapes
    the serving path gives it: every feature of one formed batch over the
    full-size tables, as ``QuantEmbeddingBagCollection`` calls them, with
    the batch's uniform ids and with Zipf ids.  int4 and int2 run over
    the same codes viewed as packed rows (``[R, 128]`` uint8 is ``[2R,
    64]`` int4 and ``[4R, 32]`` int2, scale and bias repeated per row),
    with ids ``k * id + k - 1``, so the largest row offsets pass 2^31
    bytes at every width.  Returns the records it emits."""
    import torch

    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.sharding.common import per_slot_segments

    B = kjt.stride()
    rng = np.random.RandomState(zipf_seed)
    # per id set and (kernel, bits): [slots, slots past 2^31 bytes,
    # largest row, max abs err]
    stats: dict = {}
    for cfg in tables:
        p = params[cfg.name]
        R, D = p["q"].shape
        for f in cfg.feature_names:
            jt = kjt[f]
            seg = per_slot_segments(jt.lengths(), jt.capacity)
            valid = (seg >= 0) & (seg < B)
            uni = jt.values().to(torch.int64)
            zipf = torch.from_numpy(
                zipf_ids(rng, uni.numel(), R).astype(np.int64)).to(dev)
            for bits in (8, 4, 2):
                per = 8 // bits
                packed = p["q"].view(R * per, D // per)
                scale = p["scale"].repeat_interleave(per)
                bias = p["bias"].repeat_interleave(per)
                runs = [("dedup_quant_pooled_lookup",
                         tbe.dedup_quant_pooled_lookup,
                         tbe.dedup_quant_pooled_lookup_plain, {"bits": bits})]
                if bits == 8:
                    runs.insert(0, ("quant_pooled_lookup_int8",
                                    tbe.quant_pooled_lookup_int8,
                                    tbe.quant_pooled_lookup_int8_plain, {}))
                for dist, base in (("uniform", uni), ("zipf", zipf)):
                    ids = base * per + (per - 1)
                    vids = ids[valid]
                    far = int((vids * packed.shape[1] >= FAR_BYTES).sum())
                    top = int(vids.max()) if vids.numel() else -1
                    for name, wrapper, plain, kw in runs:
                        got = wrapper(packed, scale, bias, ids, seg, B, **kw)
                        torch.cuda.synchronize()
                        ref = plain(packed, scale, bias, ids, seg, B, **kw)
                        torch.cuda.synchronize()
                        err = float((got - ref).abs().max())
                        if not torch.equal(got, ref):
                            raise AssertionError(
                                f"{name} bits={bits} {dist} feature {f}: "
                                f"kernel != plain on the serving tables "
                                f"(max abs err {err})")
                        s = stats.setdefault((dist, name, bits),
                                             [0, 0, -1, 0.0])
                        s[0] += int(vids.numel())
                        s[1] += far
                        s[2] = max(s[2], top)
                        s[3] = max(s[3], err)
                del packed, scale, bias
    recs = []
    for (dist, name, bits), (n, far, top, err) in stats.items():
        rec = {"phase": "path_kernel", "kernel": name, "bits": bits,
               "ids": dist, "batch": B, "features": len(kjt.keys()),
               "slots": n, "slots_past_2^31_bytes": far, "largest_row": top,
               "equal": True, "max_abs_err": err}
        emit(rec)
        recs.append(rec)
    near = [(r["kernel"], r["bits"]) for r in recs
            if r["ids"] == "uniform" and r["slots_past_2^31_bytes"] == 0]
    if near:
        raise AssertionError(f"{near}: no row offset of the served batch "
                             "passed 2^31 bytes")
    return recs


# (kernel, packed bits) of the grouped rows: the int8 lookup and the dedup
# lookup at every packed width
GROUPED_KERNELS = (("tbe", 8), ("dedup", 8), ("dedup", 4), ("dedup", 2))


def grouped_phase(dev, tables, params, batches, zipf_seed):
    """The grouped lookups (every feature of a formed batch in one launch,
    as ``QuantEmbeddingBagCollection.forward`` calls them) against their
    plain versions (``torch.equal``) over the full-size tables, at each
    batch of ``batches``: the batch's uniform ids and Zipf ids, int8 and
    the int4/int2 views of the same codes (ids ``k * id + k - 1`` as in
    :func:`path_kernel_phase`, so row offsets pass 2^31 bytes), with the
    wrapper's, the kernel's (on prepared inputs) and the plain version's
    times and the bound.  No single library call computes 26 tables'
    lookups, so ``library_ms`` is null.  Returns the records it emits."""
    import torch

    from torchrec_tpu_torch.ops import tbe

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    rng = np.random.RandomState(zipf_seed)
    named = [(cfg, f) for cfg in tables for f in cfg.feature_names]
    recs = []
    for kjt in batches:
        B, keys, offs = kjt.stride(), list(kjt.keys()), kjt.cap_offsets()
        lengths = kjt.lengths()
        zipf = kjt.values().clone()
        for cfg, f in named:
            k = keys.index(f)
            zipf[offs[k]:offs[k + 1]] = torch.from_numpy(zipf_ids(
                rng, offs[k + 1] - offs[k], cfg.num_embeddings)
                .astype(np.int64)).to(dev)
        for bits in (8, 4, 2):
            per = 8 // bits
            feats, width = [], 0
            for cfg, f in named:
                p = params[cfg.name]
                R, D = p["q"].shape
                scale, bias = p["scale"], p["bias"]
                if per > 1:
                    scale = scale.repeat_interleave(per)
                    bias = bias.repeat_interleave(per)
                feats.append(tbe.GroupFeature(
                    p["q"].view(R * per, D // per), scale, bias,
                    keys.index(f), width))
                width += D
            Dp = feats[0].q.shape[1]
            for kernel, kbits in GROUPED_KERNELS:
                if kbits != bits:
                    continue
                if kernel == "tbe":
                    name = "quant_pooled_lookup_int8"
                    wrapper = tbe.quant_pooled_lookup_int8_grouped
                    plain = tbe.quant_pooled_lookup_int8_grouped_plain
                    kw = {}
                else:
                    name = "dedup_quant_pooled_lookup"
                    wrapper = tbe.dedup_quant_pooled_lookup_grouped
                    plain = tbe.dedup_quant_pooled_lookup_grouped_plain
                    kw = {"bits": bits}
                for dist, base in (("uniform", kjt.values()), ("zipf", zipf)):
                    values = base * per + (per - 1)
                    args = (values, lengths, offs, feats)
                    out = torch.empty((B, width), device=dev)
                    got = wrapper(*args, out.clone(), **kw)
                    torch.cuda.synchronize()
                    ref = plain(*args, out.clone(), **kw)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"grouped {name} bits={bits} {dist} B={B}: "
                            f"kernel != plain (max abs err {err})")
                    if kernel == "tbe":
                        ends = tbe.group_ends(lengths, len(keys), B)
                        launch = lambda: tbe.launch_q8_grouped(  # noqa: E731
                            feats, offs, values, ends, out)
                    else:
                        prep = tbe.dedup_prepare_grouped(*args, B)
                        launch = lambda: tbe.launch_dedup_q_grouped(  # noqa: E731
                            feats, offs, *prep, out, bits)
                    # the least the group must move: each distinct (feature,
                    # row) once (codes, scale, bias), each valid id (int64)
                    # once, the lengths, the float32 output once; 4 flops
                    # per valid id and column
                    gkeys = tbe.group_keys_plain(*args, B)
                    valid = gkeys != tbe.SENTINEL
                    U = int(tbe.num_unique(tbe.sized_unique(gkeys)[0]))
                    n = int(valid.sum())
                    nbytes = (U * (Dp + 8) + n * 8 + lengths.numel() * 4
                              + B * width * 4)
                    flops = 4 * n * Dp * per
                    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                    flops_ms = flops / PEAK_F32_FLOPS * 1e3
                    rec = {
                        "phase": "grouped", "kernel": name, "bits": bits,
                        "ids": dist, "batch": B, "features": len(feats),
                        "slots": n, "distinct": U,
                        "slots_past_2^31_bytes": int(
                            (values[valid] * Dp >= FAR_BYTES).sum()),
                        "equal": True, "max_abs_err": err,
                        "ms": cuda_ms(lambda: wrapper(*args, out, **kw),
                                      flush),
                        "kernel_ms": cuda_ms(launch, flush),
                        "kernel_device_ms": cuda_ms(launch, flush,
                                                    device_only=True),
                        "plain_ms": cuda_ms(
                            lambda: plain(*args, out, **kw), flush,
                            runs=PLAIN_RUNS, warmup=1),
                        "library_ms": None,
                        "bytes": nbytes, "flops": flops,
                        "bound_ms": max(bytes_ms, flops_ms),
                        "bound_by": "bytes" if bytes_ms >= flops_ms
                        else "operations",
                    }
                    rec["peak_bytes_above_inputs"] = memory_of(
                        lambda: wrapper(*args, out, **kw))[0]
                    emit(rec)
                    recs.append(rec)
            del feats
    near = [(r["kernel"], r["bits"], r["batch"]) for r in recs
            if r["ids"] == "uniform" and r["slots_past_2^31_bytes"] == 0]
    if near:
        raise AssertionError(f"{near}: no row offset of a grouped batch "
                             "passed 2^31 bytes")
    del flush
    torch.cuda.empty_cache()
    return recs


def sync_check(fns, batch):
    """Each collection's forward on one formed batch under
    ``torch.cuda.set_sync_debug_mode("error")`` (it must not synchronise
    with the host: it raises if it does); the whole serving module is
    tried the same way and only reported."""
    import torch

    for kernel, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                fn.quant_ebc(batch.sparse_features)
            try:
                fn(batch.dense_features, batch.sparse_features)
                serving_syncs = False
            except RuntimeError:
                serving_syncs = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        emit({"phase": "sync_check", "kernel": kernel,
              "batch": batch.dense_features.shape[0],
              "collection_forward_syncs": False,
              "serving_module_syncs": serving_syncs})


def serving_phase(dev):
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        MLPERF_DLRM_V2_ROWS,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.inference import InferenceServer, build_serving_fn
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

    import dataclasses

    features = list(DEFAULT_CAT_NAMES)
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    tables = tuple(dataclasses.replace(c, data_type=DataType.INT8)
                   for c in mlperf_dlrm_v2_tables(DIM))
    t0 = time.perf_counter()
    params = _random_int8_tables(dev, tables, seed=0)
    torch.cuda.synchronize()
    table_bytes = sum(p["q"].numel() + 8 * p["scale"].numel()
                      for p in params.values())
    emit({"phase": "serving_tables", "rows": sum(MLPERF_DLRM_V2_ROWS),
          "bytes": table_bytes, "seconds": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    torch.manual_seed(0)
    model = DLRM(meta_ebc(mlperf_dlrm_v2_tables(DIM)), NUM_DENSE, DENSE_ARCH,
                 OVER_ARCH)
    fns = {
        kernel: build_serving_fn(
            model, QuantEmbeddingBagCollection(tables, params, kernel),
            device=dev)
        for kernel in ("tbe", "dedup")
    }
    ds = RandomRecDataset(features, NUM_REQUESTS, MLPERF_DLRM_V2_ROWS, caps,
                          num_dense=NUM_DENSE, manual_seed=0, num_batches=1)
    uniform = _requests(next(iter(ds)), len(features))
    zrng = np.random.RandomState(1)
    zipf = [(d, [zipf_ids(zrng, len(x), r).astype(np.int64)
                 for x, r in zip(ids, MLPERF_DLRM_V2_ROWS)])
            for d, ids in uniform]
    # one batch of the server's padded size: warms both serving modules
    # (cuBLAS handles, the kernels' first launch) before any timed
    # request, then is profiled after the server runs
    served = next(iter(RandomRecDataset(
        features, SERVING_BATCH, MLPERF_DLRM_V2_ROWS, caps,
        num_dense=NUM_DENSE, manual_seed=2, num_batches=1))).to(dev)
    for fn in fns.values():
        fn(served.dense_features, served.sparse_features)
    torch.cuda.synchronize()
    path = path_kernel_phase(dev, tables, params, served.sparse_features,
                             zipf_seed=3)
    sync_check(fns, served)
    main_launches = dict.fromkeys(tbe.LAUNCHES, 0)
    runs = {}
    for kernel, requests, counter in (
        ("tbe", uniform, "quant_pooled_lookup_int8"),
        ("dedup", zipf, "dedup_quant_pooled_lookup"),
    ):
        server = InferenceServer(
            fns[kernel], features, caps, NUM_DENSE,
            max_batch_size=SERVING_BATCH, max_latency_us=2000,
            queue="python",
        )
        server.start()
        try:
            tbe.reset_launch_counts()
            scores, lat, wall = _serve(server, requests)
            counts = tbe.launch_counts()
        finally:
            server.stop()
        batches = server.metrics.snapshot()["serving/batch_size"].count
        errors = server.metrics.snapshot().get(
            "serving/executor_error_count", 0)
        for k, v in counts.items():
            main_launches[k] += v
        others = sum(v for k, v in counts.items() if k != counter)
        # the same requests as one formed batch, straight through the
        # serving module: the reference for what the server answered
        kjt, dense = _direct_batch(requests, features, caps, dev)
        direct = fns[kernel](dense, kjt).double().cpu().numpy()
        rec = {
            "phase": "serving", "kernel": kernel, "requests": len(requests),
            "clients": NUM_CLIENTS, "batches": batches,
            "executor_errors": errors, "launches": counts,
            "all_finite": bool(np.isfinite(scores).all()),
            "max_abs_diff_vs_direct": float(np.abs(scores - direct).max()),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(requests) / wall,
        }
        emit(rec)
        if not rec["all_finite"] or errors:
            raise AssertionError(f"serving with {kernel}: non-finite scores "
                                 f"or {errors} executor errors")
        # one grouped launch per batch and group, and no other kernel
        groups = fns[kernel].quant_ebc.num_groups
        if counts[counter] != groups * batches or others:
            raise AssertionError(
                f"serving with {kernel}: {counts} launches for {batches} "
                f"batches of {groups} group(s)"
            )
        if not np.allclose(scores, direct, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"serving with {kernel}: served scores "
                                 "differ from the direct batch")
        runs[kernel] = rec

    # serving_fn alone on formed batches of the bench's size
    ds = RandomRecDataset(features, BENCH_BATCH, MLPERF_DLRM_V2_ROWS, caps,
                          num_dense=NUM_DENSE, manual_seed=1, num_batches=1)
    batch = next(iter(ds)).to(dev)
    outs = {}
    for kernel, fn in fns.items():
        def step():
            return fn(batch.dense_features, batch.sparse_features)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        outs[kernel] = out
        emit({"phase": "serving_fn", "kernel": kernel, "batch": BENCH_BATCH,
              "ms_per_batch": ms, "samples_per_s": BENCH_BATCH / ms * 1e3,
              "all_finite": bool(torch.isfinite(out).all())})
    if not torch.equal(outs["tbe"], outs["dedup"]):
        raise AssertionError("tbe and dedup serving differ on one batch")
    for kernel, fn in fns.items():
        profile_serving(kernel, fn, served)
    del outs
    grouped = grouped_phase(dev, tables, params,
                            [served.sparse_features, batch.sparse_features],
                            zipf_seed=4)
    del fns, params
    torch.cuda.empty_cache()
    return main_launches, runs, path + grouped


# ---------------------------------------------------------------------------
# phase 8: artifact round trip, card against CPU
# ---------------------------------------------------------------------------


def roundtrip_phase(dev):
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.inference import load_packaged_model, package_model
    from torchrec_tpu_torch.models.dlrm import DLRM

    import dataclasses

    tables = tuple(dataclasses.replace(c, num_embeddings=ROUNDTRIP_ROWS)
                   for c in mlperf_dlrm_v2_tables(DIM))
    rng = np.random.RandomState(0)
    weights = {c.name: (rng.randn(ROUNDTRIP_ROWS, DIM) * 0.05)
               .astype(np.float32) for c in tables}
    torch.manual_seed(1)
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH)
    features = list(DEFAULT_CAT_NAMES)
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "artifact")
        package_model(
            path, tables, weights, dict(zip(features, caps)), NUM_DENSE,
            quant_dtype="int8", dense_state_dict=model.state_dict(),
            model_config={"arch": "dlrm",
                          "dense_arch_layer_sizes": list(DENSE_ARCH),
                          "over_arch_layer_sizes": list(OVER_ARCH)},
        )
        fn_gpu, _ = load_packaged_model(path, device=dev)
        fn_cpu, _ = load_packaged_model(path, device="cpu")
    ds = RandomRecDataset(features, 256, [ROUNDTRIP_ROWS] * len(features),
                          caps, num_dense=NUM_DENSE, manual_seed=2,
                          num_batches=1)
    batch = next(iter(ds))
    gpu = fn_gpu(batch.dense_features.to(dev),
                 batch.sparse_features.to(dev)).cpu().numpy()
    cpu = fn_cpu(batch.dense_features, batch.sparse_features).numpy()
    ok = bool(np.allclose(gpu, cpu, rtol=1e-4, atol=1e-5))
    rec = {"phase": "roundtrip", "examples": 256, "rows_per_table":
           ROUNDTRIP_ROWS, "max_abs_diff": float(np.abs(gpu - cpu).max()),
           "all_finite": bool(np.isfinite(gpu).all()), "within_tol": ok}
    emit(rec)
    if not ok or not rec["all_finite"]:
        raise AssertionError("card and CPU scores of one artifact differ")


# ---------------------------------------------------------------------------
# the sharding planner's records, and phase 10: the planner-driven DLRM
# application (examples/dlrm/dlrm_main.py) on the card
# ---------------------------------------------------------------------------

APP_STEPS, APP_EVAL, APP_WARMUP = 40, 10, 20
APP_FLAGS = ["--num_embeddings", "100000", "--embedding_dim", str(DIM),
             "--batch_size", str(BENCH_BATCH), "--steps", str(APP_STEPS),
             "--eval_steps", str(APP_EVAL), "--warmup_steps",
             str(APP_WARMUP)]
APP_RAMP_STEP = 3  # the ramp check's step, inside the 20-step warmup
APP_BUDGET_S = 60
METRICS_TOL = 1e-6  # card vs CPU RecMetricModule (float32 sums)


def _plan_summary(plan):
    return {t: [ps.sharding_type.value, ps.compute_kernel.value, ps.ranks,
                ps.cache_load_factor] for t, ps in plan.items()}


def planner_records():
    """The port's planner with its H100 profile, no run: the bench tables
    (26 x 100,000 x 128) at B=4096 a rank at world 1 (the train phase's
    plan, which must be ``table_wise_plan``) and world 4 (the sharded
    phase's ``planned`` plan), and the MLPerf DLRM-v2 tables (204M rows,
    D=128) at world 1 and B=8192, as the planner's defaults give it (the
    f32 tables and state do not fit 80 GB) and with the multi-hot pooling
    factors and ``tiered="on"`` (host-cached options) for the five
    40M-row tables.  Emits one record each, a ``PlannerError``'s message
    where the planner finds no plan."""
    from torchrec_tpu_torch.datasets.criteo import (
        MLPERF_DLRM_V2_MULTI_HOT,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.parallel.planner import (
        EmbeddingShardingPlanner,
        ParameterConstraints,
        PlannerError,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    _, bench = bench_tables()
    mlperf = mlperf_dlrm_v2_tables()
    tiered = {c.name: ParameterConstraints(
        tiered="on" if c.num_embeddings >= 4_000_000 else None,
        pooling_factor=float(h))
        for c, h in zip(mlperf, MLPERF_DLRM_V2_MULTI_HOT)}
    for name, tables, world, batch, cons in (
            ("bench", bench, 1, BENCH_BATCH, None),
            ("bench", bench, SHARDED_RANKS, BENCH_BATCH, None),
            ("mlperf_dlrm_v2", mlperf, 1, DCN_BATCH, None),
            ("mlperf_dlrm_v2_host_cached", mlperf, 1, DCN_BATCH, tiered)):
        t0 = time.perf_counter()
        planner = EmbeddingShardingPlanner(
            world_size=world, batch_size_per_device=batch, constraints=cons)
        rec = {"phase": "planner", "tables": name, "world": world,
               "batch_per_rank": batch,
               "device": planner.topology.device,
               "calibration": planner.topology.calibration_sources}
        try:
            plan = planner.plan(tables)
        except PlannerError as e:
            rec.update(planner_error=str(e).splitlines(),
                       seconds=time.perf_counter() - t0)
            emit(rec)
            continue
        kinds: dict = {}
        for ps in plan.values():
            k = f"{ps.sharding_type.value}/{ps.compute_kernel.value}"
            kinds[k] = kinds.get(k, 0) + 1
        rec.update(
            seconds=time.perf_counter() - t0, kinds=kinds,
            plan=_plan_summary(plan),
            per_rank_hbm_bytes=planner.stats.per_rank_hbm,
            per_rank_perf_ms={r: p.total * 1e3 for r, p in
                              planner.stats.per_rank_perf.items()},
            report=planner.last_report.splitlines())
        if name == "bench" and world == 1:
            rec["is_table_wise_plan"] = dict(plan) == table_wise_plan(tables)
            if not rec["is_table_wise_plan"]:
                raise AssertionError("the planner's world-1 plan of the "
                                     "bench tables is not table_wise_plan")
        emit(rec)


def _app_metrics_check(run, dev, device_type):
    """The application's eval batches again (a fresh iterator past the
    training batches), their predictions from the trained state into a
    fresh module on the card and one on the CPU: every metric of the two
    within ``METRICS_TOL``, and of the card's equal to the run's report."""
    import itertools

    import torch

    from torchrec_tpu_torch.metrics import (
        MetricsConfig,
        RecMetricModule,
        RecTaskInfo,
    )

    cfg = MetricsConfig(tasks=[RecTaskInfo(name="ctr")],
                        metrics=["ne", "auc", "calibration"])
    card = RecMetricModule(cfg, BENCH_BATCH, device=device_type)
    cpu = RecMetricModule(cfg, BENCH_BATCH, device="cpu")
    fwd = run["dmp"].make_forward()
    state = run["state"]
    for b in itertools.islice(iter(run["ds"]), APP_STEPS,
                              APP_STEPS + APP_EVAL):
        b = b.to(dev)
        preds = torch.sigmoid(fwd(state["dense"], state["tables"], b))
        card.update({"ctr": preds}, {"ctr": b.labels})
        cpu.update({"ctr": preds.cpu()}, {"ctr": b.labels.cpu()})
    got, want = card.compute(), cpu.compute()
    keys = sorted(k for k in got if not k.startswith("throughput"))
    err = max(abs(got[k] - want[k]) for k in keys)
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
              for k in keys)
    run_err = max(abs(got[k] - run["report"][k]) for k in keys)
    out = {"metrics": {k: got[k] for k in keys},
           "metrics_card_vs_cpu_max_abs_err": err,
           "metrics_card_vs_cpu_max_rel_err": rel,
           "metrics_vs_run_report_max_abs_err": run_err}
    if not all(np.isfinite(got[k]) for k in keys):
        raise AssertionError(f"app: non-finite metrics {got}")
    if err > METRICS_TOL and rel > METRICS_TOL:
        raise AssertionError(f"app: card metrics off the CPU module's by "
                             f"{err} ({got} vs {want})")
    if run_err > METRICS_TOL:
        raise AssertionError(f"app: metrics off the run's report by "
                             f"{run_err}")
    return out


def app_phase(dev):
    """The planner-driven DLRM application at full width: ``dlrm_main``
    (8 features x 10 ids over 100,000-row tables of D=128, DLRM 13 ->
    512-256-128, over arch 512-512-256-1 in float32, B=4096, 40 steps with
    a 20-step linear warmup on the dense Adagrad and the fused sparse lr,
    10 eval batches, NE / AUC / calibration) on the port's planner plan
    at world 1, through ``main`` as a user runs it.  Checks: one B1 per
    train step and eval batch and one B2 per train step and nothing else
    (counts, and a profile of one step and one eval forward), finite
    losses, ``id_overflow`` all zero, ``make_forward``'s logits
    ``torch.equal`` to ``train_step``'s on one state and batch, a step in
    the warmup ramp ``torch.equal`` to the plain B1/B2 at the scheduled
    float32 lr (``train_path_check``), and the card's metrics against a
    CPU module's.  Records ms a step, samples/s, eval ms a batch, peak
    memory, and the planner's per-rank estimates against them.  Returns
    (the main path's launches, the ramp check's record)."""
    import contextlib
    import io
    import itertools

    import torch

    from torchrec_tpu_torch.examples.dlrm import dlrm_main
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel.comm import ShardingEnv

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    flags = APP_FLAGS + ["--device", dev.type]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    tbe.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        run = dlrm_main.main(flags)
    counts = {k: v for k, v in tbe.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    main_s = time.perf_counter() - t_phase
    losses = [float(x) for x in run["losses"]]
    overflow = int(sum(int(o.sum()) for o in run["id_overflow"]))
    timed = APP_STEPS - 1  # after the first step
    ms_per_step = run["train_s"] * 1e3 / timed
    planner = run["planner"]
    est_perf = planner.stats.per_rank_perf[0]
    rec = {"phase": "app", "card": card, "flags": flags,
           "plan": _plan_summary(run["plan"]),
           "planner_report": planner.last_report.splitlines(),
           "stdout": out.getvalue().splitlines()[-8:],
           "steps": len(losses), "eval_batches": run["evaluated"],
           "losses": losses, "all_finite": bool(np.isfinite(losses).all()),
           "id_overflow_total": overflow, "launches": counts,
           "first_step_ms": run["first_step_s"] * 1e3,
           "ms_per_step": ms_per_step,
           "samples_per_s": timed * BENCH_BATCH / run["train_s"],
           "eval_ms_per_batch": run["eval_s"] * 1e3 / run["evaluated"],
           "peak_memory_allocated": peak,
           "planner_hbm_estimate_bytes": planner.stats.per_rank_hbm[0],
           "planner_hbm_estimate_over_peak": (
               planner.stats.per_rank_hbm[0] / peak),
           "planner_step_estimate_ms": est_perf.total * 1e3,
           "planner_step_estimate_parts_ms": {
               k: v * 1e3 for k, v in dataclasses.asdict(est_perf).items()},
           "planner_step_estimate_over_measured": (
               est_perf.total * 1e3 / ms_per_step),
           "report": run["report"]}
    want = {"pooled_lookup": APP_STEPS + APP_EVAL,
            "fused_sparse_update": APP_STEPS}
    if counts != want:
        raise AssertionError(f"app: launched {counts}, want {want}")
    if not rec["all_finite"] or overflow:
        raise AssertionError(f"app: losses {losses}, id_overflow {overflow}")
    rec.update(_app_metrics_check(run, dev, dev.type))

    # the eval forward and the train step on one state and batch; then
    # both under a profile: one B1 each, one B2 for the step
    dmp, state = run["dmp"], run["state"]
    batch = next(itertools.islice(iter(run["ds"]), APP_STEPS + APP_EVAL,
                                  None)).to(dev)
    fwd = dmp.make_forward()
    logits = fwd(state["dense"], state["tables"], batch)
    _, m = dmp.train_step(state, batch)
    rec["forward_equals_train_step_logits"] = bool(torch.equal(logits,
                                                               m["logits"]))
    if not rec["forward_equals_train_step_logits"]:
        raise AssertionError("app: make_forward's logits != train_step's")
    rec["profiled_launches"] = _profiled_kernels(lambda: (
        dmp.train_step(state, batch),
        fwd(state["dense"], state["tables"], batch)))
    if rec["profiled_launches"] != {"pooled_lookup": 2,
                                    "fused_sparse_update": 1}:
        raise AssertionError(f"app: profiled {rec['profiled_launches']}")
    del run, dmp, state, m, logits
    torch.cuda.empty_cache()

    # a step inside the warmup ramp against the plain versions, at the
    # scheduled float32 lr (a second instance of the application)
    args = dlrm_main.parse_args(flags)
    ramp = dlrm_main.build(args, ShardingEnv.single_device(dev))
    dmp, state = ramp["dmp"], ramp["state"]
    it = iter(ramp["ds"])
    for _ in range(APP_RAMP_STEP):
        state, _ = dmp.train_step(state, next(it).to(dev))
    lr = dmp.sparse_lr(state["step"])
    if not 0 < lr < dmp.fused_config.learning_rate:
        raise AssertionError(f"app: step {state['step']} lr {lr} is not in "
                             "the ramp")
    check = train_path_check(dmp, state, next(it).to(dev), None,
                             phase="app_ramp_check", lr=lr)
    del ramp, dmp, state
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    rec["main_seconds"] = main_s
    rec["budget_s"] = APP_BUDGET_S
    emit(rec)
    return counts, check


# ---------------------------------------------------------------------------
# phase 9: multi-rank sharding at the width of bench.py main(): 4 ranks on
# one card over gloo, and one rank over NCCL
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4
SHARDED_STEPS = 5  # timed, after one warm-up step
SHARDED_PLANS = ("tw", "cw", "rw", "twrw", "mixed", "planned")
SHARDED_TIMEOUT = 600
ONE_CARD = "4 ranks on one card over gloo: not a multi-GPU figure"
# the sharded losses against the plain one-device train_step's: measured
# 1.9e-5 to 3.0e-5 apart over 6 steps (bf16 dense GEMMs at 4 x 4,096 rows
# against 16,384, then the rowwise steps that follow); 3x that
PLAIN_LOSS_RTOL = 1e-4


def sharded_plan(kind, tables, n):
    """The plans of the sharded phase over ``n`` ranks: table-wise
    round-robin, column-wise in 2 shards, row-wise, table-row-wise over
    nodes of 2 ranks, a mix of row-wise, table-wise, column-wise and
    (two tables) data-parallel, and the port's planner's plan with its
    H100 profile at B=4096 a rank (``planned``)."""
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    if kind == "planned":
        return EmbeddingShardingPlanner(
            world_size=n, batch_size_per_device=TRAIN_BATCH).plan(tables)

    def one(i, t):
        if kind == "mixed":
            t = ("rw", "tw", "cw")[min(i * 3 // (len(tables) - 2), 2)] \
                if i < len(tables) - 2 else "dp"
        if t == "tw":
            return ParameterSharding(ST.TABLE_WISE, ranks=[i % n])
        if t == "cw":
            return ParameterSharding(ST.COLUMN_WISE,
                                     ranks=[i % n, (i + 1) % n])
        if t == "rw":
            return ParameterSharding(ST.ROW_WISE, ranks=list(range(n)))
        if t == "twrw":
            start = 2 * (i % (n // 2))
            return ParameterSharding(ST.TABLE_ROW_WISE,
                                     ranks=[start, start + 1])
        return ParameterSharding(ST.DATA_PARALLEL)

    return {c.name: one(i, kind) for i, c in enumerate(tables)}


def bench_tables():
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig

    keys = [f"cat_{i}" for i in range(TRAIN_FEATURES)]
    return keys, tuple(
        EmbeddingBagConfig(num_embeddings=TRAIN_ROWS, embedding_dim=DIM,
                           name=f"t_{k}", feature_names=[k])
        for k in keys)


def sharded_dmp(dev, plan, batch, caps, env=None, eps=EPS,
                dense_dtype=None):
    """The DMP of ``build_trainer`` with ``plan``, on ``env`` (one rank
    when None), and its state from a seeded generator on the card (every
    rank draws the same full tables and keeps its share).  ``eps`` is the
    fused optimizer's, ``dense_dtype`` the dense part's (bf16 if None)."""
    import torch

    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )

    _, tables = bench_tables()
    model = DLRM(meta_ebc(tables), NUM_DENSE, DENSE_ARCH, OVER_ARCH,
                 dense_dtype=dense_dtype or torch.bfloat16)
    dmp = DistributedModelParallel(
        model, tables, plan, batch, caps,
        fused_config=FusedOptimConfig(learning_rate=TRAIN_LR, eps=eps),
        dense_optimizer=adagrad(TRAIN_LR), device=dev, env=env)
    return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))


def one_id_batches(n_batches):
    """The first ``n_batches`` batches of ``build_trainer``'s dataset (one
    id per feature at most), on the host."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    keys, _ = bench_tables()
    ds = RandomRecDataset(keys, TRAIN_BATCH, [TRAIN_ROWS] * len(keys),
                          [1] * len(keys), num_dense=NUM_DENSE,
                          manual_seed=0)
    it = iter(ds)
    return dict(zip(keys, ds.caps)), [next(it) for _ in range(n_batches)]


def global_batch(batches):
    """The batches of one step's ranks as the one global batch, examples
    in rank order (each key's values and lengths concatenated)."""
    import torch

    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjts = [b.sparse_features for b in batches]
    keys = kjts[0].keys()
    vals, lens, ws = [], [], []
    for f in range(len(keys)):
        for k in kjts:
            ln = k.lengths_for_key(f).cpu().numpy()
            co, n = k.cap_offsets()[f], int(ln.sum())
            vals.append(k.values()[co:co + n].cpu().numpy())
            lens.append(ln)
            if k.weights_or_none() is not None:
                ws.append(k.weights_or_none()[co:co + n].cpu().numpy())
    caps = [sum(k.caps[f] for k in kjts) for f in range(len(keys))]
    kjt = KeyedJaggedTensor.from_lengths_packed(
        keys, np.concatenate(vals), np.concatenate(lens),
        np.concatenate(ws) if ws else None, caps=caps)
    return Batch(torch.cat([b.dense_features for b in batches]), kjt,
                 torch.cat([b.labels for b in batches]))


def multi_hot_batch(env):
    """This rank's weighted multi-hot batch: the bucketed stream's
    Zipf(1.2) lengths of 1 to 64 with Zipf(1.0) ids (seeded per rank),
    repacked to the bucketed caps of the largest of the ranks' batches
    (each feature's cap the same on every rank: the dists' geometry)."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset
    from torchrec_tpu_torch.parallel.multiprocess import allgather_host

    keys, _ = bench_tables()
    F = len(keys)
    b = next(iter(RandomRecDataset(
        keys, TRAIN_BATCH, [TRAIN_ROWS] * F, [DEDUP_MAX_IDS] * F,
        num_dense=NUM_DENSE, manual_seed=100 + env.rank,
        min_ids_per_features=[1] * F, zipf_lengths=DEDUP_ZIPF_LENGTHS,
        zipf_ids=DEDUP_ZIPF_IDS, weighted=True)))
    kjt = b.sparse_features
    sig = kjt.bucketed_caps(BUCKETING["floor"], BUCKETING["growth"])
    caps = [int(c) for c in allgather_host(np.asarray(sig, np.int64))
            .max(axis=0)]
    return dict(zip(keys, caps)), kjt.repad(caps)


def group_kind_of_features(dmp):
    """{feature: kind} of the sharded collection's groups."""
    ebc = dmp.sharded_ebc
    out = {}
    for kind, _, lay in ebc.sharded_groups():
        feats = (lay.feature_order if kind != "rw"
                 else [f.name for f in lay.features])
        out.update(dict.fromkeys(feats, kind))
    for g in ebc.dp_groups.values():
        out.update(dict.fromkeys((f.name for f in g.features), "dp"))
    return out


def _kt_check(kt, ref, kinds, exact_all):
    """The sharded KT against the unsharded collection's, per feature:
    (bitwise equal features, max abs err), or raise.  Table-wise,
    column-wise and data-parallel features (and every feature when
    ``exact_all``) must be ``torch.equal``; row-wise and block-shard
    ones, summed over ranks, within rtol 1e-5, atol 1e-5."""
    import torch

    got, want = kt.to_dict(), ref.to_dict()
    equal, err = 0, 0.0
    for f, kind in kinds.items():
        a, b = got[f].float(), want[f].float()
        err = max(err, float((a - b).abs().max()))
        if torch.equal(a, b):
            equal += 1
        elif exact_all or kind in ("tw", "dp"):
            raise AssertionError(f"{kind} feature {f}: sharded KT != "
                                 f"unsharded (max abs err "
                                 f"{float((a - b).abs().max())})")
        elif not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{kind} feature {f}: sharded KT off the "
                                 f"unsharded by {float((a - b).abs().max())}")
    return equal, err


def _in_turns(env, fn):
    """``fn()`` on one rank at a time, rank order, the others waiting at
    a barrier (a rank's kernel times are then its own on the card)."""
    import torch.distributed as dist

    out = None
    for r in range(env.world_size):
        if env.rank == r:
            out = fn()
        dist.barrier()
    return out


def sharded_kernel_check(dmp, state, batch, flush):
    """B1 and B2 at this rank's shapes on one step's inputs: for each
    sharded group, the group's received slot stream through B1's region
    entry and the step's real gradient through B2 (rowwise Adagrad, on a
    copy of the rank's stack), each ``torch.equal`` to its plain version;
    and their card-alone times, ranks in turns.  Returns the records."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward
    from torchrec_tpu_torch.parallel.sharding.rw import rw_backward_local
    from torchrec_tpu_torch.parallel.sharding.tw import tw_backward_local
    from torchrec_tpu_torch.parallel.sharding.twrw import (
        twrw_backward_local,
    )

    ebc, env = dmp.sharded_ebc, dmp.env
    back = {"tw": tw_backward_local, "rw": rw_backward_local,
            "twrw": twrw_backward_local}
    kt, ctxs = dmp.sparse_forward(state, batch)
    _, _, _, grads = dmp.dense_forward_backward(state, batch, kt)
    cfg = dmp.fused_config
    recs = []
    for kind, name, lay in ebc.sharded_groups():
        stack = state["tables"][name]
        mom = state["fused"][name]["momentum"]
        ids, w, segs, regions = ctxs[name]
        got = tbe.pooled_lookup_regions(stack, ids, regions, w)
        ref = tbe.pooled_lookup_regions_plain(stack, ids, regions, w)
        sg = back[kind](lay, ctxs[name], grads, env)  # a collective
        outs = []
        for fn in (tbe_backward.fused_sparse_update,
                   tbe_backward.fused_sparse_update_plain):
            t, m = stack.clone(), mom.clone()
            _update_call(fn, t, [m], "rowwise_adagrad", sg,
                         cfg.learning_rate, None, (1.0, 1.0))
            outs.append((t, m))
        torch.cuda.synchronize()
        b1_eq = bool(torch.equal(got, ref))
        b2_eq = all(torch.equal(a, b) for a, b in zip(*outs))
        rec = {"phase": "sharded_kernel", "rank": env.rank, "group": name,
               "kind": kind, "stack": list(stack.shape),
               "slots": int(ids.numel()), "regions": len(regions.counts),
               "segments": regions.num_segments,
               "valid_slots": int(sg.ok().sum()),
               "b1_equal": b1_eq, "b2_equal": b2_eq,
               "b1_max_abs_err": float((got.float() - ref.float())
                                       .abs().max()),
               "b2_max_abs_err": max(float((a - b).abs().max())
                                     for a, b in zip(*outs))}
        del outs, got, ref
        if not (b1_eq and b2_eq):
            raise AssertionError(f"sharded kernel check failed: {rec}")
        tk, mk = stack.clone(), mom.clone()
        ends = tbe.region_ends(regions.lengths)
        prep = tbe_backward.sort_by_row(sg.ids, sg.valid, sg.segments,
                                        sg.weights, stack.shape[0],
                                        sg.grad_seg.shape[0])

        def restore():
            tk.copy_(stack)
            mk.copy_(mom)

        def b1():
            return tbe.pooled_lookup_regions(stack, ids, regions, w)

        def b1_kernel():
            return tbe.launch_pooled(stack, ids, w, ends, regions.starts,
                                     regions.caps, regions.counts)

        def b2():
            _update_call(tbe_backward.fused_sparse_update, tk, [mk],
                         "rowwise_adagrad", sg, cfg.learning_rate, None,
                         (1.0, 1.0))

        def b2_kernel():
            tbe_backward.launch_fused_sparse_update(
                tk, [mk], *prep, sg.grad_seg, "rowwise_adagrad",
                cfg.learning_rate, EPS, 0.0, (0.9, 0.999), (1.0, 1.0), None)

        def times():
            return {
                "b1_kernel_device_ms": cuda_ms(b1_kernel, flush,
                                               device_only=True),
                "b1_wrapper_device_ms": cuda_ms(b1, flush, device_only=True),
                "b2_kernel_device_ms": cuda_ms(b2_kernel, flush,
                                               setup=restore,
                                               device_only=True),
                "b2_wrapper_device_ms": cuda_ms(b2, flush, setup=restore,
                                                device_only=True)}

        R, D = stack.shape
        _, nbytes, flops = _b1_bound(R, D, stack.element_size(), ids, segs,
                                     w, regions.num_segments)
        rec["b1_bound_ms"] = _bound(nbytes, flops)[0]
        _, nbytes, flops = _update_bound(D, stack.element_size(), sg,
                                         "rowwise_adagrad")
        rec["b2_bound_ms"] = _bound(nbytes, flops)[0]
        rec.update(_in_turns(env, times) or {})
        del tk, mk, prep
        recs.append(rec)
    return recs


def _profiled_kernels(call):
    """B1's and B2's device launches in one ``call``, by a profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"pooled_lookup": sum("tbe_pooled_kernel" in n for n in names),
            "fused_sparse_update": sum("fused_update_kernel" in n
                                       for n in names)}


def _rank_device(device_type):
    """The rank's device: the card's first for every rank (the kernels
    built by the parent are loaded), or the CPU for a rehearsal."""
    import torch

    from torchrec_tpu_torch.ops import _native

    if device_type != "cuda":
        return torch.device(device_type)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _native.load_libraries()  # built by the parent: loads them
    return dev


def sharded_rank(kinds, device_type="cuda"):
    """One rank of the gloo arm (run by ``multiprocess.launch``): every
    plan of ``kinds`` through the checks of the phase.  Returns its
    records and launch counts."""
    import torch

    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops import tbe
    from torchrec_tpu_torch.parallel import multiprocess
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting

    dev = _rank_device(device_type)
    multiprocess.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device=dev)
    r, N = env.rank, env.world_size
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    caps, host = one_id_batches(N * (1 + SHARDED_STEPS))
    mine = [host[s * N + r].to(dev) for s in range(1 + SHARDED_STEPS)]
    records, launches, refs = [], {}, {}
    _, tables = bench_tables()
    ebc = EmbeddingBagCollection(
        tables, is_weighted=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    mh_caps, mh_kjt = multi_hot_batch(env)
    mh_kjt = mh_kjt.to(dev)
    for kind in kinds:
        t0 = time.perf_counter()
        stages = {}
        plan = sharded_plan(kind, tables, N)
        ref_key = one_device_plan(plan)
        if r == 0 and ref_key not in refs:  # the others wait
            refs[ref_key] = (one_device_run(dev, ref_key, host, N),
                             one_device_run(dev, ref_key, host, N, False)[0])
        stages["one_device_reference_s"] = time.perf_counter() - t0
        dmp, state = sharded_dmp(dev, plan, TRAIN_BATCH, caps, env)
        kinds_of = group_kind_of_features(dmp)
        with torch.no_grad():
            kt, _ = dmp.sparse_forward(state, mine[0])
            one_hot = _kt_check(_kt(dmp, kt), ebc(mine[0].sparse_features),
                                kinds_of, exact_all=True)
            mh = dmp.with_feature_caps(mh_caps)
            kt_m, _ = mh.sparse_forward(state, _with_kjt(mine[0], mh_kjt))
            multi = _kt_check(_kt(mh, kt_m), ebc(mh_kjt), kinds_of,
                              exact_all=False)
            dedup = None
            if kind == "tw":
                dd = dmp.with_feature_caps(caps, "dedup", "dedup")
                kt_d, _ = dd.sparse_forward(state, mine[0])
                dedup = bool(torch.equal(kt_d, kt))
                if not dedup:
                    raise AssertionError("tw: B4's KT != B1's")
        planned = None
        if kind == "planned":
            planned, one = planned_forward_check(dmp, state, mine[0], dev)
        stages["forward_checks_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        kchecks = sharded_kernel_check(dmp, state, mine[0], flush)
        stages["kernel_checks_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        # the main path: 1 warm-up and SHARDED_STEPS timed steps
        torch.cuda.synchronize()
        tbe.reset_launch_counts()
        state, warm, _ = _train_steps(dmp, state, mine[:1], 1)
        with wire_accounting() as ledger:
            state, losses, dt = _train_steps(dmp, state, mine[1:],
                                             SHARDED_STEPS)
        counts = {k: v for k, v in tbe.launch_counts().items() if v}
        steps = 1 + SHARDED_STEPS
        if (counts.get("pooled_lookup", 0) < steps
                or counts.get("fused_sparse_update", 0) < steps
                or set(counts) - {"pooled_lookup", "fused_sparse_update"}):
            raise AssertionError(f"{kind} rank {r}: {steps} steps launched "
                                 f"{counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        stages["train_steps_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        weights = dmp.table_weights(state)  # a collective
        table_err = ref_losses = tables_equal = plain_losses = None
        plain_gap = None
        if r == 0:
            (ref_losses, ref_tables), plain_losses = refs[ref_key]
            plain_gap = max(abs(a - b) / abs(b)
                            for a, b in zip(warm + losses, plain_losses))
            if plain_gap > PLAIN_LOSS_RTOL:
                raise AssertionError(
                    f"{kind}: losses {warm + losses} off the one-device "
                    f"train_step's {plain_losses} by {plain_gap} (rtol "
                    f"{PLAIN_LOSS_RTOL})")
            tables_equal = all(np.array_equal(weights[t], ref_tables[t])
                               for t in ref_tables)
            table_err = max(float(np.abs(weights[t] - ref_tables[t]).max())
                            for t in ref_tables)
            if not tables_equal:
                raise AssertionError(
                    f"{kind}: trained tables != the one-device DMP's (max "
                    f"abs err {table_err}; tables " + str(sorted(
                        t for t in ref_tables
                        if not np.array_equal(weights[t], ref_tables[t])))
                    + ")")
        stages["tables_check_s"] = time.perf_counter() - t0 - sum(
            stages.values())
        # every rank profiles the same step at once: a profiler's first
        # start takes seconds in each process, so not one rank at a time;
        # the barrier keeps rank 0's table check (seconds) out of the
        # other ranks' profiling windows, which then hold the step alone
        torch.distributed.barrier()
        profiled = _profiled_kernels(lambda: dmp.train_step(state, mine[0]))
        if not (profiled["pooled_lookup"] and
                profiled["fused_sparse_update"]):
            raise AssertionError(f"{kind} rank {r}: profiled {profiled}")
        stages["profile_s"] = time.perf_counter() - t0 - sum(stages.values())
        if kind == "planned":
            planned.update(planned_overflow_check(dmp, state, mine[1], env,
                                                  one))
            planned["plan"] = _plan_summary(plan)
            del one
            stages["planned_checks_s"] = time.perf_counter() - t0 - sum(
                stages.values())
        rec = {"phase": "sharded", "plan": kind, "rank": r, "ranks": N,
               "backend": "gloo", "note": ONE_CARD,
               "groups": {n: list(t.shape)
                          for n, t in state["tables"].items()},
               "batch_per_rank": TRAIN_BATCH, "steps": steps,
               "ms_per_step": dt * 1e3 / SHARDED_STEPS,
               "losses": warm + losses,
               "all_finite": bool(np.isfinite(warm + losses).all()),
               "one_device_losses": ref_losses,
               "one_hot_equal_features": one_hot[0],
               "one_hot_max_abs_err": one_hot[1],
               "multi_hot_equal_features": multi[0],
               "multi_hot_max_abs_err": multi[1],
               "multi_hot_caps": sorted(set(mh_caps.values())),
               "dedup_kt_equal": dedup, "launches": counts,
               "profiled_launches_one_step": profiled,
               "wire_bytes_per_step": {k: v / SHARDED_STEPS
                                       for k, v in ledger.items()},
               "tables_equal_one_device": tables_equal,
               "table_max_abs_err_vs_one_device": table_err,
               "one_device_train_step_losses": plain_losses,
               "loss_max_rel_gap_vs_train_step": plain_gap,
               "stage_seconds": stages,
               "seconds": time.perf_counter() - t0}
        if planned is not None:
            rec["planned"] = planned
        if not rec["all_finite"]:
            raise AssertionError(f"{kind} rank {r}: losses {rec['losses']}")
        records += [rec] + kchecks
        del dmp, state, weights
        torch.cuda.empty_cache()
    return records, launches


def over_cap_batch(batch, key_index, length):
    """``batch`` with every example of key ``key_index`` claiming
    ``length`` ids, past the key's capacity: the saturation a device-side
    relayout leaves, which ``id_overflow`` counts."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjt = batch.sparse_features
    B = kjt.stride()
    lengths = kjt.lengths().clone()
    lengths[key_index * B:(key_index + 1) * B] = length
    return dataclasses.replace(batch, sparse_features=KeyedJaggedTensor(
        kjt.keys(), kjt.values(), lengths, stride=B, caps=kjt.caps))


def planned_forward_check(dmp, state, batch, dev):
    """The planned plan's eval forward on this rank: ``make_forward``'s
    logits of the rank's batch ``torch.equal`` to the one-device DMP's
    (the same seeded tables and dense parameters, each table whole) on
    that batch.  Returns (the record's fields, the one-device DMP and
    state, kept for :func:`planned_overflow_check`)."""
    import torch

    one, one_st = one_device_dmp(dev, one_device_plan(dmp.plan), 1)
    logits = dmp.make_forward()(state["dense"], state["tables"], batch)
    ref = one.make_forward()(one_st["dense"], one_st["tables"], batch)
    out = {"forward_equal_one_device": bool(torch.equal(logits, ref)),
           "forward_max_abs_err": float((logits - ref).abs().max())}
    if not out["forward_equal_one_device"]:
        raise AssertionError(f"planned: rank forward != one device: {out}")
    return out, (one, one_st)


def planned_overflow_check(dmp, state, batch, env, one):
    """One step with rank 0's batch over capacity (key 0 claiming two ids
    an example, its cap one): the step's ``id_overflow``, summed over
    ranks, equal to the sum of each rank's one-device count on its own
    batch, and on key 0 the ``B`` ids dropped."""
    from torchrec_tpu_torch.parallel.multiprocess import allgather_host

    if env.rank == 0:
        batch = over_cap_batch(batch, 0, 2)
    _, m = dmp.train_step(state, batch)
    one_dmp, one_st = one
    _, m1 = one_dmp.train_step(one_st, batch)
    mine = m1["id_overflow"].cpu().numpy()
    want = allgather_host(mine).sum(axis=0)
    got = m["id_overflow"].cpu().numpy()
    out = {"id_overflow": got.tolist(),
           "one_device_id_overflow_sum": want.tolist()}
    if not (np.array_equal(got, want) and got[0] == TRAIN_BATCH
            and not got[1:].any()):
        raise AssertionError(f"planned: id_overflow {out}")
    return out


def one_device_plan(plan):
    """The one-device plan a sharded plan trains like: each table whole
    on rank 0, but a column-wise one in its column shards (the rowwise
    optimizer's state is a shard's own), as a hashable tuple."""
    from torchrec_tpu_torch.parallel.types import ShardingType as ST

    cw = (ST.COLUMN_WISE, ST.TABLE_COLUMN_WISE)
    return tuple((t, len(ps.ranks) if ps.sharding_type in cw else 1)
                 for t, ps in plan.items())


def _micro_grads(one, st, kt, micro_batches):
    """The sharded step's dense arithmetic on one device: the dense
    forward and backward over each rank's micro-batch (its rows of the
    global ``kt``), the loss and dense gradients summed in rank order and
    divided by the ranks, the KT gradient divided by them.  (loss, dense
    gradients, KT gradient by feature.)"""
    import torch

    from torchrec_tpu_torch.parallel.comm import sum_over_ranks

    n = len(micro_batches)
    flats, kt_grads = [], []
    for r, b in enumerate(micro_batches):
        loss, _, g_dense, g_kt = one.dense_forward_backward(
            st, b, kt[r * TRAIN_BATCH:(r + 1) * TRAIN_BATCH])
        flats.append(torch.cat([loss.reshape(1).to(torch.float32)]
                               + [g.reshape(-1) for g in g_dense.values()]))
        kt_grads.append(g_kt)
    flat = sum_over_ranks(torch.stack(flats)) / n
    pieces = flat[1:].split([g.numel() for g in g_dense.values()])
    g_dense = {k: p.view_as(g) for (k, g), p in zip(g_dense.items(), pieces)}
    grads = {f: torch.cat([g[f] for g in kt_grads]) / n for f in kt_grads[0]}
    return flat[0], g_dense, grads


def one_device_dmp(dev, key, n, eps=EPS, dense_dtype=None):
    """The one-device DMP of :func:`one_device_plan`'s ``key`` at the
    global batch of ``n`` ranks, and its state."""
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType as ST,
    )

    caps, _ = one_id_batches(0)
    plan = {t: ParameterSharding(ST.COLUMN_WISE if k > 1 else ST.TABLE_WISE,
                                 ranks=[0] * k) for t, k in key}
    return sharded_dmp(dev, plan, n * TRAIN_BATCH,
                       {k: n * c for k, c in caps.items()}, eps=eps,
                       dense_dtype=dense_dtype)


def one_device_run(dev, key, host, n, micro=True, eps=EPS,
                   dense_dtype=None):
    """The one-device DMP of ``key`` over the global batches (each the
    ``n`` ranks' batches of a step): its losses and its trained tables
    after ``1 + SHARDED_STEPS`` steps.  With ``micro`` its step runs the
    sparse forward and the fused update over the global batch and the
    dense part by :func:`_micro_grads`: the sharded step's arithmetic,
    which the sharded run matches bit for bit.  Without, ``train_step``
    on the global batch: its dense GEMMs run at ``n`` times the rows and
    its dense gradients stay in the dense dtype, so it rounds otherwise
    (see :func:`one_device_gap` for how far that carries)."""
    import torch

    one, st = one_device_dmp(dev, key, n, eps, dense_dtype)
    losses = []
    for s in range(1 + SHARDED_STEPS):
        gb = global_batch(host[s * n:(s + 1) * n]).to(dev)
        if not micro:
            st, m = one.train_step(st, gb)
            losses.append(float(m["loss"]))
            continue
        kt, ctxs = one.sparse_forward(st, gb)
        loss, g_dense, grads = _micro_grads(
            one, st, kt, [b.to(dev) for b in host[s * n:(s + 1) * n]])
        one.sharded_ebc.backward_and_update_local(
            st["tables"], st["fused"], ctxs, grads, one.fused_config)
        one.dense_tx.update(st["dense"], g_dense, st["dense_opt"])
        st["step"] += 1
        losses.append(float(loss))
    tables = one.table_weights(st)
    del one, st
    torch.cuda.empty_cache()
    return losses, tables


def _quantiles(x):
    import torch

    q = torch.tensor([0.0, 0.01, 0.5, 0.99, 1.0], device=x.device)
    x = x.reshape(-1).float()
    if x.numel() > 1 << 24:  # torch.quantile's limit
        x = x[torch.randperm(x.numel(), device=x.device)[:1 << 24]]
    return [float(v) for v in torch.quantile(x, q)]


def first_step_gap(dev, key, host, n, eps, dense_dtype):
    """On the first global batch, from one state: the plain step's and
    the micro-batched step's KT gradients per (feature, example) row, and
    the first rowwise Adagrad step each gives a row hit once (``lr * g /
    (rms(g) + eps)``, the fused update from a zero momentum)."""
    import torch

    one, st = one_device_dmp(dev, key, n, eps, dense_dtype)
    gb = global_batch(host[:n]).to(dev)
    kt, _ = one.sparse_forward(st, gb)
    _, _, gd_plain, gk_plain = one.dense_forward_backward(st, gb, kt)
    _, gd_micro, gk_micro = _micro_grads(one, st, kt,
                                         [b.to(dev) for b in host[:n]])
    keys = list(gk_plain)
    P = torch.stack([gk_plain[f].float() for f in keys])  # [F, B, D]
    M = torch.stack([gk_micro[f].float() for f in keys])
    lengths = torch.stack([gb.sparse_features.lengths_for_key(f)
                           for f in range(len(keys))]).to(dev)
    hit = lengths > 0  # the rows the update reads

    def step(g):
        return TRAIN_LR * g / (g.pow(2).mean(-1, keepdim=True).sqrt() + eps)

    rms = P.pow(2).mean(-1).sqrt()[hit]
    rel = ((M - P).norm(dim=-1) / P.norm(dim=-1).clamp_min(1e-30))[hit]
    dstep = (step(M) - step(P)).abs().amax(-1)[hit]
    dense_rel = max(float((gd_micro[k].float() - g.float()).norm()
                          / g.float().norm().clamp_min(1e-30))
                    for k, g in gd_plain.items())
    out = {"rows_hit": int(hit.sum()),
           "kt_grad_row_rms_q": _quantiles(rms),
           "kt_grad_row_rel_diff_q": _quantiles(rel),
           "first_step_gap_q": _quantiles(dstep),
           "first_step_rows_over_1e-2": int((dstep > 1e-2).sum()),
           "dense_grad_max_rel_diff": dense_rel}
    del one, st
    torch.cuda.empty_cache()
    return out


def one_device_gap():
    """``python3 chip_smoke.py --one-device-gap``: how far the plain
    one-device ``train_step`` on the global batches parts from the
    micro-batched one (the sharded step's arithmetic), at the sharded
    phase's table-wise reference (4 ranks of B=4096), and why.  Arms: the
    fused optimizer's eps at 1e-8 (the phase's) and 1e-5, the dense part
    in bf16 (the phase's) and float32.  Per arm: the KT gradients' and
    the first rowwise Adagrad step's gaps on one state, then the losses
    and the tables after ``1 + SHARDED_STEPS`` steps of each."""
    import torch

    sys.path.insert(0, ROOT)
    from torchrec_tpu_torch.ops import _native

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    _native.load_libraries()
    card = nvidia_smi_line()
    n = SHARDED_RANKS
    _, host = one_id_batches(n * (1 + SHARDED_STEPS))
    _, tables = bench_tables()
    key = one_device_plan(sharded_plan("tw", tables, n))
    one, st = one_device_dmp(dev, key, n)
    init = one.table_weights(st)
    del one, st
    for eps, dtype in ((EPS, torch.bfloat16), (EPS, torch.float32),
                       (1e-5, torch.bfloat16)):
        t0 = time.perf_counter()
        rec = {"phase": "one_device_gap", "card": card, "fused_eps": eps,
               "dense_dtype": str(dtype).replace("torch.", ""),
               **first_step_gap(dev, key, host, n, eps, dtype)}
        micro = one_device_run(dev, key, host, n, True, eps, dtype)
        plain = one_device_run(dev, key, host, n, False, eps, dtype)
        gap = np.concatenate([np.abs(micro[1][t] - w).max(axis=1)
                              for t, w in plain[1].items()])
        moved = np.concatenate([np.abs(micro[1][t] - w).max(axis=1)
                                for t, w in init.items()])
        rec.update({
            "micro_losses": micro[0], "plain_losses": plain[0],
            "loss_max_rel_gap": max(abs(a - b) / abs(b)
                                    for a, b in zip(*(micro[0], plain[0]))),
            "table_max_abs_gap": float(gap.max()),
            "table_rows_gap_over_1e-2": int((gap > 1e-2).sum()),
            "table_rows_gap_over_1e-4": int((gap > 1e-4).sum()),
            "rows_moved": int((moved > 0).sum()),
            "row_move_q": _quantiles(torch.from_numpy(moved[moved > 0])),
            "seconds": time.perf_counter() - t0})
        emit(rec)
        del micro, plain, gap, moved


def _kt(dmp, values):
    """The sharded collection's KT values as a KeyedTensor."""
    from torchrec_tpu_torch.sparse import KeyedTensor

    ebc = dmp.sharded_ebc
    return KeyedTensor(ebc.feature_order, ebc.feature_dims, values)


def _with_kjt(batch, kjt):
    import dataclasses

    return dataclasses.replace(batch, sparse_features=kjt)


def nccl_rank(backend="nccl", device_type="cuda"):
    """The NCCL arm, one rank on the card: the row-wise plan's forward
    and one step ``torch.equal`` to the one-device DMP's (at one rank a
    row-wise table is the whole table; the NCCL collectives run).  A CPU
    rehearsal passes gloo and the CPU."""
    import torch

    from torchrec_tpu_torch.parallel import multiprocess
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.parallel.qcomm import wire_accounting
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    dev = _rank_device(device_type)
    multiprocess.initialize(backend)
    env = ShardingEnv.from_process_group(backend, device=dev)
    caps, host = one_id_batches(1)
    batch = host[0].to(dev)
    _, tables = bench_tables()
    rw, rw_state = sharded_dmp(dev, sharded_plan("rw", tables, 1),
                               TRAIN_BATCH, caps, env)
    one, one_state = sharded_dmp(dev, table_wise_plan(tables), TRAIN_BATCH,
                                 caps)
    with torch.no_grad():
        kt, _ = rw.sparse_forward(rw_state, batch)
        kt_one, _ = one.sparse_forward(one_state, batch)
    with wire_accounting() as ledger:
        rw_state, m = rw.train_step(rw_state, batch)
    one_state, m1 = one.train_step(one_state, batch)
    a, b = rw.table_weights(rw_state), one.table_weights(one_state)
    rec = {"phase": "sharded_nccl", "ranks": env.world_size,
           "backend": env.backend, "plan": "rw",
           "kt_equal": bool(torch.equal(kt, kt_one)),
           "tables_equal_after_step": all(np.array_equal(a[t], b[t])
                                          for t in a),
           "loss": float(m["loss"]), "one_device_loss": float(m1["loss"]),
           "wire_bytes_per_step": dict(ledger)}
    if not (rec["kt_equal"] and rec["tables_equal_after_step"]):
        raise AssertionError(f"NCCL arm failed: {rec}")
    return rec


def sharded_phase(rank_fn=sharded_rank, nccl_fn=nccl_rank):
    """The multi-rank phase: the gloo arm's 4 ranks, then the NCCL arm's
    one, each spawned by ``multiprocess.launch`` (the parent built every
    kernel before), each rank's records emitted here beside the card's
    line.  Returns (the main path's launches, summed over ranks and
    plans; the kernel checks' records)."""
    import torch

    from torchrec_tpu_torch.parallel.multiprocess import launch

    card = nvidia_smi_line()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = launch(rank_fn, SHARDED_RANKS, args=(SHARDED_PLANS,),
                     timeout=SHARDED_TIMEOUT)
    launches: dict = {}
    kchecks = []
    for records, counts in results:
        for rec in records:
            emit({**rec, "card": card})
        kchecks += [r for r in records if r["phase"] == "sharded_kernel"]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = launch(nccl_fn, 1, timeout=SHARDED_TIMEOUT)
    emit({**nccl, "card": card})
    emit({"phase": "sharded_summary", "card": card, "note": ONE_CARD,
          "gloo_arm_seconds": gloo_s,
          "nccl_arm_seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches, kchecks


def registers_record():
    """The registers a thread of every B2 and B6 instantiation uses, by
    optimizer and table dtype, at D = 128 (the narrow layout, bounded to
    two 256-thread blocks an SM, so at most 128), D = 512 (wide) and
    D = 130 (scalar); fails if a narrow one takes more than 128.  And
    every B1 instantiation's registers and resident blocks, by table
    dtype, column path and index types."""
    import torch

    from torchrec_tpu_torch.ops import tbe, tbe_backward

    rec = {"phase": "registers", "pooled_lookup": {}}
    for dtype, runs, vec, ids, ends in itertools.product(
            (torch.float32, torch.bfloat16), (True, False), (True, False),
            (torch.int32, torch.int64), (torch.int32, torch.int64)):
        key = " ".join(str(t).replace("torch.", "") for t in (
            dtype, "runs" if runs else "segments",
            "4 columns" if vec else "1 column", ids, ends))
        rec["pooled_lookup"][key] = tbe.pooled_kernel_info(dtype, runs, vec,
                                                           ids, ends)
    for kernel in ("fused_sparse_update", "dedup_fused_sparse_update"):
        rec[kernel] = {}
        for dim in (128, 512, 130):
            for dtype in (torch.float32, torch.bfloat16):
                for optim in tbe_backward.OPTIMIZERS:
                    info = tbe_backward.update_launch(kernel, optim, dtype,
                                                      dim)
                    if info["layout"] != tbe_backward.column_layout(dim)[0]:
                        raise AssertionError(f"{kernel} D={dim}: layout "
                                             f"{info['layout']}")
                    if dim == 128 and info["registers"] > 128:
                        raise AssertionError(f"{kernel} {optim} {dtype}: "
                                             f"{info['registers']} registers")
                    key = f"D={dim} {str(dtype).replace('torch.', '')}"
                    rec[kernel].setdefault(key, {})[optim] = {
                        "registers": info["registers"],
                        "blocks_per_sm": info["blocks_per_sm"]}
    return rec


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    sys.path.insert(0, ROOT)
    from torchrec_tpu_torch.ops import _native, tbe

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _native.load_libraries()  # one nvcc per source, all started together
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "load_seconds": time.perf_counter() - t0,
          "build_seconds": {s: i["seconds"]
                            for s, i in _native.BUILD_INFO.items()},
          "ptxas": {s: [l.strip() for l in str(i["log"]).splitlines()
                        if "registers" in l or "spill" in l]
                    for s, i in _native.BUILD_INFO.items()}})
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    emit(registers_record())
    kernel_rows = kernel_phase(dev, flush)
    planner_records()
    train_launches, train_rows, checks = train_phase(dev, flush)
    ebc_launches, ebc_rows, _ = ebc_phase(dev, flush)
    dedup_launches, dedup_rows, dedup_check = train_dedup_phase(dev, flush)
    dcn_launches, dcn_rows, dcn_check = train_dcn_phase(dev, flush)
    del flush
    app_launches, app_check = app_phase(dev)
    serve_launches, _, path_rows = serving_phase(dev)
    roundtrip_phase(dev)
    sharded_launches, sharded_checks = sharded_phase()

    # each kernel's launches on its own main paths: B1/B2 the training
    # step (21 + 3 steps), the DCN step (21) and the application (40
    # steps; B1 also its 10 eval batches), B1 also the EBC's 21 steps (26
    # a step), B4/B6 the bucketed pipeline's 21 steps, B4 also the dedup
    # EBC's forward (26), B3/B5 serving
    launches = {k: train_launches[k] + ebc_launches[k] + dedup_launches[k]
                + dcn_launches[k] + app_launches.get(k, 0)
                + serve_launches[k] + sharded_launches.get(k, 0)
                for k in tbe.LAUNCHES}
    errs = [(r["kernel"], r["max_abs_err"])
            for r in kernel_rows + train_rows + ebc_rows + dedup_rows
            + dcn_rows + path_rows]
    errs += [(k, c[f"{b}_max_abs_err"])
             for c in checks + [dcn_check, app_check]
             for k, b in (("pooled_lookup", "b1"),
                          ("fused_sparse_update", "b2"))]
    errs += [("dedup_pooled_lookup", dedup_check["b4_max_abs_err"]),
             ("dedup_fused_sparse_update", dedup_check["b6_max_abs_err"])]
    errs += [(k, c[f"{b}_max_abs_err"]) for c in sharded_checks
             for k, b in (("pooled_lookup", "b1"),
                          ("fused_sparse_update", "b2"))]

    def representative(name):
        """The timed row of each kernel: float32 (int8 for B3/B5), rowwise
        Adagrad for B6; B1/B2 at the training batch's uniform ids, B3 at
        uniform and B5 at Zipf ids; B4/B6 at the bucketed batch."""
        want_ids = "zipf" if name == "dedup_quant_pooled_lookup" else "uniform"
        return next(
            r for r in kernel_rows + train_rows + dedup_rows
            if r["kernel"] == name and r.get("bits", 8) == 8
            and r.get("dtype", "float32") == "float32"
            and r.get("optim", "rowwise_adagrad") == "rowwise_adagrad"
            and r.get("ids", want_ids) == want_ids)

    summary = []
    for name in tbe.LAUNCHES:
        rep = representative(name)
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on its path")
        summary.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name], "paths": KERNEL_PATHS[name],
            "launches": launches[name],
            "max_abs_err": max(e for k, e in errs if k == name),
            "ms": rep["ms"], "kernel_ms": rep["kernel_ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            **{k: rep[k] for k in ("kernel_device_ms", "library_device_ms")
               if k in rep},
        })
    # B2 covers all eight optimizers: each one's float32 row of the DCN
    # phase (Adagrad at the path's uniform ids, the others at the
    # 1,000,000-row cap)
    b2 = next(k for k in summary if k["name"] == "fused_sparse_update")
    b2["optimizers"] = {
        r["optim"]: {k: r[k] for k in ("ms", "kernel_ms", "kernel_device_ms",
                                       "plain_ms", "bound_ms", "registers")}
        for r in dcn_rows
        if r["kernel"] == "fused_sparse_update" and r["dtype"] == "float32"
        and r["ids"] == "uniform"}
    # B3 and B5 as the collection launches them: one grouped launch for
    # the 26 features of a formed batch (B=256 served, B=4096 serving_fn)
    for k in summary:
        grouped = {f"B={r['batch']} {r['ids']} int{r['bits']}": {
            x: r[x] for x in ("ms", "kernel_ms", "kernel_device_ms",
                              "plain_ms", "bound_ms",
                              "peak_bytes_above_inputs")}
            for r in path_rows
            if r["phase"] == "grouped" and r["kernel"] == k["name"]}
        if grouped:
            k["grouped"] = grouped
    emit({"kernels": summary})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--one-device-gap"]:
        one_device_gap()
    else:
        main()
