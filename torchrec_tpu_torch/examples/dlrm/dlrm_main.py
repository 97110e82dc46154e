"""DLRM training application, the port of the JAX package's
``examples/dlrm/dlrm_main.py`` flag for flag: Criteo (preprocessed npy) or
synthetic data, planner-driven sharding, fused rowwise Adagrad with one
warmup schedule driving both the dense and the sparse learning rate,
train then eval batches, and NE, AUC and calibration.

Run on the card (synthetic data):
  python -m torchrec_tpu_torch.examples.dlrm.dlrm_main --steps 60

With preprocessed Criteo shards ({prefix}_dense.npy / _sparse.npy /
_labels.npy, see datasets/criteo.py):
  python -m torchrec_tpu_torch.examples.dlrm.dlrm_main --criteo_prefix /data/day0

``--device cpu`` runs the kernels' plain versions on the CPU.  The world
is the process group's when the process has joined one
(``parallel/multiprocess.py``; each rank takes its share of every step's
batches, as each device of the JAX mesh does), else one rank.
"""

from __future__ import annotations

import argparse
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from torchrec_tpu_torch.datasets.criteo import (
    CAT_FEATURE_COUNT,
    DEFAULT_CAT_NAMES,
    INT_FEATURE_COUNT,
    criteo_dataset,
)
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.metrics import (
    MetricsConfig,
    RecMetricModule,
    RecTaskInfo,
)
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import (
    WarmupPolicy,
    WarmupStage,
    adagrad,
    warmup_optimizer,
    warmup_schedule,
)
from torchrec_tpu_torch.parallel.comm import ShardingEnv, all_gather
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
from torchrec_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--criteo_prefix", type=str, default=None,
                   help="npy prefix from datasets/criteo preprocessing; "
                        "synthetic data when absent")
    p.add_argument("--num_embeddings", type=int, default=100_000,
                   help="per-table rows (synthetic mode)")
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=256, help="per rank")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--eval_steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--warmup_steps", type=int, default=20)
    p.add_argument("--device", type=str, default=None,
                   help="the device to run on (default: the card)")
    return p.parse_args(argv)


def _env(device: torch.device) -> ShardingEnv:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return ShardingEnv.from_process_group(
            torch.distributed.get_backend(), device=device)
    return ShardingEnv.single_device(device)


def build(args: argparse.Namespace, env: ShardingEnv) -> Dict[str, Any]:
    """The application's pieces: the dataset, tables, planner and plan,
    the DMP with its warmup schedules, its fresh state and the metrics
    module."""
    n = env.world_size
    if args.criteo_prefix:
        # fold raw ids into --num_embeddings rows per table
        ds = criteo_dataset(args.criteo_prefix, args.batch_size,
                            hashes=[args.num_embeddings] * CAT_FEATURE_COUNT)
        keys = DEFAULT_CAT_NAMES
        hash_sizes = list(ds.hashes)
    else:
        keys = [f"cat_{i}" for i in range(8)]
        hash_sizes = [args.num_embeddings] * len(keys)
        ds = RandomRecDataset(keys, args.batch_size, hash_sizes,
                              ids_per_features=[10] * len(keys),
                              num_dense=INT_FEATURE_COUNT)
    tables = tuple(
        EmbeddingBagConfig(num_embeddings=h, embedding_dim=args.embedding_dim,
                           name=f"t_{k}", feature_names=[k],
                           pooling=PoolingType.SUM)
        for k, h in zip(keys, hash_sizes))
    model = DLRM(EmbeddingBagCollection(tables, device="meta"),
                 INT_FEATURE_COUNT, (512, 256, args.embedding_dim),
                 (512, 512, 256, 1))
    planner = EmbeddingShardingPlanner(
        world_size=n, batch_size_per_device=args.batch_size)
    plan = planner.plan(tables)
    # one schedule drives both sides
    stages = [WarmupStage(WarmupPolicy.LINEAR, max_iters=args.warmup_steps,
                          value=1.0)]
    dmp = DistributedModelParallel(
        model, tables, plan, args.batch_size,
        dict(zip(keys, ds.caps)),
        fused_config=FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                                      learning_rate=args.lr),
        dense_optimizer=warmup_optimizer(adagrad(args.lr), stages),
        sparse_lr_schedule=warmup_schedule(stages), env=env)
    state = dmp.init(torch.Generator(device=env.device).manual_seed(0))
    metrics = RecMetricModule(
        MetricsConfig(tasks=[RecTaskInfo(name="ctr")],
                      metrics=["ne", "auc", "calibration"]),
        batch_size=args.batch_size * n, device=env.device)
    return {"ds": ds, "tables": tables, "planner": planner, "plan": plan,
            "dmp": dmp, "state": state, "metrics": metrics}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train ``--steps`` steps, evaluate ``--eval_steps`` batches and
    print the lifetime metrics (rank 0).  Returns the run's pieces and
    results: the ``build`` dict with the trained state, ``losses`` and
    ``id_overflow`` per step (device tensors), the wall seconds of the
    first step and of the rest (``first_step_s``, ``train_s``), of the
    evaluation (``eval_s``), the batches evaluated and the metrics
    report."""
    args = parse_args(argv)
    env = _env(resolve_device(args.device))
    dev, n, r = env.device, env.world_size, env.rank
    run = build(args, env)
    if r == 0:
        print(run["planner"].last_report)
    dmp, state, metrics = run["dmp"], run["state"], run["metrics"]
    step = dmp.make_train_step()
    fwd = dmp.make_forward()

    it = iter(run["ds"])
    losses: List[torch.Tensor] = []
    overflow: List[torch.Tensor] = []
    first_s = train_s = 0.0
    t0 = time.perf_counter()
    for i in range(args.steps):
        locals_ = list(itertools.islice(it, n))
        if len(locals_) < n:  # a finite Criteo shard ran dry
            print(f"data exhausted after {i} steps")
            break
        state, out = step(state, locals_[r].to(dev))
        losses.append(out["loss"])
        overflow.append(out["id_overflow"])
        if i == 0:
            _sync(dev)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        if (i + 1) % 20 == 0 and r == 0:
            print(f"step {i + 1}: loss={float(out['loss']):.4f}")
    _sync(dev)
    if losses:
        train_s = time.perf_counter() - t0

    # validation: forward-only over held-out batches, AUC + NE
    evaluated = 0
    t0 = time.perf_counter()
    for _ in range(args.eval_steps):
        locals_ = list(itertools.islice(it, n))
        if len(locals_) < n:
            break
        batch = locals_[r].to(dev)
        preds = torch.sigmoid(fwd(state["dense"], state["tables"], batch))
        labels = batch.labels.reshape(-1)
        if n > 1:  # the metrics of the global batch, as JAX's are
            preds = all_gather(preds, env).reshape(-1)
            labels = all_gather(labels, env).reshape(-1)
        metrics.update({"ctr": preds}, {"ctr": labels})
        evaluated += 1
    _sync(dev)
    eval_s = time.perf_counter() - t0
    report: Dict[str, float] = {}
    if evaluated == 0:
        print("no eval batches available (data exhausted)")
    else:
        report = metrics.compute()
        if r == 0:
            print(f"eval over {evaluated} batches:")
            for k in sorted(report):
                if "lifetime" in k:
                    print(f"  {k} = {report[k]:.4f}")
    run.update(state=state, losses=losses, id_overflow=overflow,
               first_step_s=first_s, train_s=train_s, eval_s=eval_s,
               evaluated=evaluated, report=report)
    return run


if __name__ == "__main__":
    main()
