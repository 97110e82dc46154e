"""The deterministic elastic-training recipe
(``torchrec_tpu/reliability/elastic_demo.py``): one DLRM train that runs
at ANY world size.

The sharding plan is recomputed for the live world
(``EmbeddingShardingPlanner``), and the batch rank ``r`` consumes at
global step ``g`` is a pure function of ``(seed, g, r)``, so a run
resumed at step ``s`` at another world size and a clean run restarted
from the same checkpoint at that size consume the same batches, and
their final committed states compare bit for bit through
:func:`checkpoint_digest`.  The widths are parameters (:class:`Widths`):
the defaults are the JAX recipe's tiny model; ``chip_smoke.py`` runs
``bench.py main()``'s widths with fewer rows.

Launched three ways:

* as the worker script of an ``ElasticSupervisor`` (heartbeats,
  watchdog, fault plan and the checkpoint commit barrier wired from the
  ``TORCHREC_ELASTIC_*`` environment; one gloo rank a process);
* in-process, ``run(...)``, as the clean comparison run;
* as a CLI: ``python -m torchrec_tpu_torch.reliability.elastic_demo
  --steps N --ckpt DIR [--device cpu]``.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Widths:
    """The recipe's model: ``features`` tables of ``rows`` x ``dim``,
    ``ids`` ids per feature per example, ``batch`` examples a rank,
    ``dense_in`` dense features, the DLRM's arches."""

    features: int = 2
    rows: Tuple[int, ...] = (64, 40)
    dim: int = 8
    ids: int = 2
    batch: int = 2
    dense_in: int = 4
    dense_arch: Tuple[int, ...] = (8, 8)
    over_arch: Tuple[int, ...] = (8, 1)

    @property
    def keys(self) -> Tuple[str, ...]:
        return tuple(f"f{i}" for i in range(self.features))

    @property
    def table_rows(self) -> Tuple[int, ...]:
        r = tuple(self.rows)
        return r if len(r) == self.features else (r[0],) * self.features


def make_local_batch(seed: int, gstep: int, rank: int,
                     widths: Widths = Widths()):
    """The host batch rank ``rank`` consumes at global step ``gstep``: a
    pure function of its arguments."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    ds = RandomRecDataset(
        list(widths.keys), widths.batch, list(widths.table_rows),
        [widths.ids] * widths.features, num_dense=widths.dense_in,
        manual_seed=seed * 100003 + gstep * 1009 + rank,
    )
    return next(iter(ds))


def checkpoint_digest(ckpt_dir: str, step: int) -> str:
    """sha256 over every payload leaf of a committed checkpoint (its key
    path, then its bytes): the final committed train state that the
    elastic drills compare bit for bit."""
    import numpy as np
    import torch

    from torchrec_tpu_torch.checkpoint import (
        Checkpointer,
        _leaves,
        _numpy_words,
    )

    payload = Checkpointer(ckpt_dir)._read_payload(step)
    h = hashlib.sha256()
    for path, leaf in _leaves(payload):
        h.update("/".join(path).encode())
        if isinstance(leaf, torch.Tensor):
            h.update(_numpy_words(leaf).tobytes())
        else:
            h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def run(
    target_steps: int,
    ckpt_dir: str,
    out_path: str = "",
    seed: int = 7,
    device: Optional[str] = None,
    widths: Widths = Widths(),
):
    """Train to ``target_steps`` committed global steps, resuming from
    whatever ``ckpt_dir`` holds (``restore_elastic``: any world size), a
    checkpoint every step.  Under a supervisor the world is every worker
    (one gloo rank each); otherwise one rank on ``device`` (the card
    unless ``"cpu"``; every rank on the named card, e.g. ``"cuda:0"``,
    when ranks share one).  Returns (and prints, after
    ``ELASTIC_RESULT``) the run's summary, this process's kernel launches
    in it."""
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.ops._native import launch_counts
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel import multiprocess as mp
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
    from torchrec_tpu_torch.reliability.elastic import (
        ElasticWorkerContext,
        LocalShardPipeline,
    )
    from torchrec_tpu_torch.reliability.train_loop import (
        FaultTolerantTrainLoop,
    )
    from torchrec_tpu_torch.utils.device import resolve_device

    ctx = ElasticWorkerContext.from_env()
    dev = resolve_device(device)
    if os.environ.get(mp._ENV_COORD):
        mp.initialize("gloo")
        env = ShardingEnv.from_process_group("gloo", device=dev)
    else:
        env = ShardingEnv.single_device(dev)
    if ctx is not None:
        ctx.start()
    world, rank = env.world_size, env.rank

    tables = tuple(
        EmbeddingBagConfig(num_embeddings=r, embedding_dim=widths.dim,
                           name=f"t_{k}", feature_names=[k])
        for k, r in zip(widths.keys, widths.table_rows))
    model = DLRM(EmbeddingBagCollection(tables, device="meta"),
                 widths.dense_in, widths.dense_arch, widths.over_arch)
    # replan for THIS world: the elastic resume path
    plan = EmbeddingShardingPlanner(world_size=world).plan(tables)
    caps = make_local_batch(seed, 0, 0, widths).sparse_features.caps
    dmp = DistributedModelParallel(
        model, tables, plan, widths.batch, dict(zip(widths.keys, caps)),
        fused_config=FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                                      learning_rate=0.05),
        dense_optimizer=adagrad(0.05), env=env)
    barrier = ctx.commit_barrier(deadline_s=30.0) if ctx else None
    ck = Checkpointer(ckpt_dir, commit_barrier=barrier)
    state = dmp.init(torch.Generator(device=dev).manual_seed(seed))
    pipeline = LocalShardPipeline(dmp.train_step, state, env)
    loop = FaultTolerantTrainLoop(pipeline, ck, dmp, checkpoint_interval=1,
                                  resume=True, checkpoint_on_start=True,
                                  elastic_resume=True)
    start = loop.resumed_from or 0

    def local_stream():
        for g in range(start, target_steps):
            yield make_local_batch(seed, g, rank, widths)

    it = local_stream()
    losses = []
    g = start
    while g < target_steps:
        if ctx is not None:
            ctx.beat(step=g, applied=g - start)
            with ctx.step_scope(g):
                m = loop.progress(it)
        else:
            m = loop.progress(it)
        g = start + loop.applied_steps
        losses.append(float(m["loss"]))  # the mean over ranks
        if ctx is not None:
            ctx.beat(step=g, applied=g - start)

    final_step = ck.latest_step()
    result = {
        "resumed_from": loop.resumed_from,
        "start": start,
        "target": target_steps,
        "final_step": final_step,
        "world": world,
        "num_processes": mp.process_count(),
        "losses": losses,
        "restore_seconds": loop.checkpoint_restore_seconds,
        "save_seconds": loop.checkpoint_save_seconds,
        "saves": loop.checkpoint_save_count,
        # this process's kernel launches (none on the CPU)
        "launches": {k: v for k, v in launch_counts().items() if v},
        # one process: every rank of a larger world would read the same
        # directory at once
        "digest": (checkpoint_digest(ckpt_dir, final_step)
                   if world == 1 else None),
    }
    if out_path and rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    print("ELASTIC_RESULT", json.dumps(result), flush=True)
    if barrier is not None:
        barrier.close()
    if ctx is not None:
        ctx.shutdown()
    return result


def _ints(s: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI over :func:`run` (the supervisor spawns this file)."""
    d = Widths()
    ap = argparse.ArgumentParser(prog="elastic_demo")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: the card)")
    ap.add_argument("--features", type=int, default=d.features)
    ap.add_argument("--rows", type=_ints, default=d.rows,
                    help="rows a table: one number, or one a table")
    ap.add_argument("--dim", type=int, default=d.dim)
    ap.add_argument("--ids", type=int, default=d.ids)
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--dense-in", type=int, default=d.dense_in)
    ap.add_argument("--dense-arch", type=_ints, default=d.dense_arch)
    ap.add_argument("--over-arch", type=_ints, default=d.over_arch)
    ns = ap.parse_args(argv)
    widths = Widths(ns.features, ns.rows, ns.dim, ns.ids, ns.batch,
                    ns.dense_in, ns.dense_arch, ns.over_arch)
    run(ns.steps, ns.ckpt, out_path=ns.out, seed=ns.seed, device=ns.device,
        widths=widths)
    return 0


def widths_args(widths: Widths) -> list:
    """The CLI arguments that give ``widths``."""
    return ["--features", str(widths.features),
            "--rows", ",".join(map(str, widths.rows)),
            "--dim", str(widths.dim), "--ids", str(widths.ids),
            "--batch", str(widths.batch), "--dense-in", str(widths.dense_in),
            "--dense-arch", ",".join(map(str, widths.dense_arch)),
            "--over-arch", ",".join(map(str, widths.over_arch))]


if __name__ == "__main__":
    # spawned as a bare script: the repository root on the path before
    # run() imports the package (a library import leaves sys.path alone)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main())
