"""The deterministic online-migration recipe
(``torchrec_tpu/reliability/migration_demo.py``).

A DLRM whose big table ``t_f0`` is planned ROW_WISE under a plan-time
padding efficiency of 0.9 (the stream really runs at about 0.93
occupancy).  At ``drift_step`` the stream's lengths of ``f0`` collapse
(Zipf-skewed toward one id, the caps unchanged, so the shapes stay and
the real occupancy falls to about 0.1): the ``HealthMonitor`` alarms on
the per-key KJT occupancy, the ``ReplanTrigger`` arms, and the
``PlanMigrator`` prices both plans with the live occupancy
(``EstimatorContext.from_telemetry`` divides every id-proportional
row-wise wire term by it), so DATA_PARALLEL wins and the migration flips
the big table RW -> DP with no committed step lost.

The batch rank ``r`` consumes at global step ``g`` is a pure function of
``(seed, g, r, g >= drift_step)``, so a run migrated at any step and a
clean restart from the same committed checkpoint consume the same
batches.  The widths are parameters (:class:`Widths`): the defaults are
the JAX recipe's; ``chip_smoke.py`` runs ``bench.py main()``'s widths
with fewer rows.

Launched three ways, as ``elastic_demo``: as an ``ElasticSupervisor``
worker script (the ``kill_mid_reshard`` / ``kill_mid_validate`` drills;
one gloo rank a process), in-process (``run(..., env=...)`` inside a
``multiprocess.launch`` of ranks that already joined their group), and
as a CLI: ``python -m torchrec_tpu_torch.reliability.migration_demo
--steps N --ckpt DIR [--device cpu] [--drift-step S]``.
"""

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence, Tuple

KEYS = ("f0", "f1")


@dataclasses.dataclass(frozen=True)
class Widths:
    """The recipe's model: tables ``t_f0`` (big) and ``t_f1`` of
    ``rows`` x ``dim``; ``batch`` examples a rank; per-example id caps
    ``cap_ids`` and the pre-drift floors ``min_ids``; the planner's
    pooling factors ``pooling`` and plan-time padding efficiency of
    ``f0``; the DLRM's dense input and arches."""

    rows: Tuple[int, int] = (1024, 128)
    dim: int = 8
    batch: int = 16
    cap_ids: Tuple[int, int] = (32, 4)
    min_ids: Tuple[int, int] = (28, 4)
    pooling: Tuple[float, float] = (30.0, 4.0)
    plan_pad_eff: float = 0.9
    dense_in: int = 4
    dense_arch: Tuple[int, ...] = (8, 8)
    over_arch: Tuple[int, ...] = (8, 1)


def make_local_batch(seed: int, gstep: int, rank: int, drifted: bool,
                     widths: Widths = Widths()):
    """The host batch rank ``rank`` consumes at global step ``gstep``, a
    pure function of its arguments; ``drifted`` swaps f0's lengths
    (uniform on ``[min_ids, cap_ids]`` -> Zipf(2.5) on ``[1, cap]``)
    without touching the caps."""
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    ds = RandomRecDataset(
        list(KEYS), widths.batch, list(widths.rows), list(widths.cap_ids),
        num_dense=widths.dense_in,
        min_ids_per_features=([1, widths.min_ids[1]] if drifted
                              else list(widths.min_ids)),
        zipf_lengths=2.5 if drifted else None,
        manual_seed=seed * 100003 + gstep * 1009 + rank
        + (500009 if drifted else 0))
    return next(iter(ds))


def table_configs(widths: Widths = Widths()):
    """The two tables (``t_f0`` big, ``t_f1`` small)."""
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )

    return tuple(EmbeddingBagConfig(num_embeddings=r, embedding_dim=widths.dim,
                                    name=f"t_{k}", feature_names=[k])
                 for k, r in zip(KEYS, widths.rows))


def plan_constraints(widths: Widths = Widths()):
    """``t_f0`` may be ROW_WISE or DATA_PARALLEL (the migration's axis),
    priced at the plan-time padding efficiency; ``t_f1`` is TABLE_WISE on
    both sides."""
    from torchrec_tpu_torch.parallel.planner.types import (
        ParameterConstraints,
    )
    from torchrec_tpu_torch.parallel.types import ShardingType

    return {
        "t_f0": ParameterConstraints(
            sharding_types=[ShardingType.ROW_WISE,
                            ShardingType.DATA_PARALLEL],
            pooling_factor=widths.pooling[0],
            padding_efficiency=widths.plan_pad_eff),
        "t_f1": ParameterConstraints(
            sharding_types=[ShardingType.TABLE_WISE],
            pooling_factor=widths.pooling[1]),
    }


def run(
    target_steps: int,
    ckpt_dir: str,
    out_path: str = "",
    seed: int = 11,
    device: Optional[str] = None,
    widths: Widths = Widths(),
    drift_step: Optional[int] = None,
    migrate: bool = True,
    min_improvement: float = 0.2,
    cooldown_steps: int = 1000,
    plan_override=None,
    phase_hook=None,
    env=None,
    topology_fn=None,
):
    """Train to ``target_steps`` committed global steps with the monitor,
    trigger and migrator wired into the loop, resuming from whatever
    ``ckpt_dir`` holds.

    drift_step: the global step at which f0 drifts (None: the clean
    arm); migrate: wire the ``PlanMigrator`` (False: the monitor alone);
    plan_override: a plan to run under instead of planning (or
    ``plan_from_env``); phase_hook: forwarded to the migrator (fault
    injection); env: a ``ShardingEnv`` of ranks that already joined
    their group (default: the supervisor's group, else one rank on
    ``device``, the card unless ``"cpu"``); topology_fn: ``world ->
    planner Topology`` (default: the planner's H100 topology).  Returns
    (and writes to ``out_path`` on rank 0, prints after
    ``MIGRATE_RESULT``) the result the drills check."""
    import numpy as np
    import torch

    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.obs.health import HealthMonitor
    from torchrec_tpu_torch.obs.registry import MetricsRegistry
    from torchrec_tpu_torch.ops._native import launch_counts
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
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
    from torchrec_tpu_torch.reliability.elastic_demo import checkpoint_digest
    from torchrec_tpu_torch.reliability.migration import (
        PlanMigrator,
        ReplanTrigger,
        plan_from_env,
        serialize_plan_for_env,
    )
    from torchrec_tpu_torch.reliability.train_loop import (
        FaultTolerantTrainLoop,
    )
    from torchrec_tpu_torch.utils.device import resolve_device

    ctx = ElasticWorkerContext.from_env() if env is None else None
    if env is None:
        dev = resolve_device(device)
        if os.environ.get(mp._ENV_COORD):
            mp.initialize("gloo")
            env = ShardingEnv.from_process_group("gloo", device=dev)
        else:
            env = ShardingEnv.single_device(dev)
    dev = env.device
    if ctx is not None:
        ctx.start()
    world, rank = env.world_size, env.rank

    tables = table_configs(widths)
    constraints = plan_constraints(widths)
    model = DLRM(EmbeddingBagCollection(tables, device="meta"),
                 widths.dense_in, widths.dense_arch, widths.over_arch)

    def make_planner(estimator_ctx=None):
        """A fresh planner; a live context's constraints replace the
        plan-time ones, so that the enumeration sees the live numbers."""
        c = constraints
        if estimator_ctx is not None and estimator_ctx.constraints:
            c = estimator_ctx.constraints
        topo = topology_fn(world) if topology_fn is not None else None
        return EmbeddingShardingPlanner(
            world_size=None if topo is not None else world, topology=topo,
            constraints=c, batch_size_per_device=widths.batch)

    planner = make_planner()
    plan = plan_override
    if plan is None:
        plan = plan_from_env()
    # the belief set: replanning is deterministic, so an env or override
    # plan gets the assumptions its provider stamped
    planned = planner.plan(tables)
    assumptions = planner.last_assumptions
    if plan is None:
        plan = planned

    caps = make_local_batch(seed, 0, 0, False, widths).sparse_features.caps
    dmp = DistributedModelParallel(
        model, tables, plan, widths.batch, dict(zip(KEYS, caps)),
        fused_config=FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                                      learning_rate=0.05),
        dense_optimizer=adagrad(0.05), env=env)
    registry = MetricsRegistry()

    def absorb_host_batch(local_batches):
        # the real stream's per-key occupancy, the monitor's drift input:
        # the mean over every rank's batch (one all-reduce), so that each
        # rank's monitor sees the stream the JAX recipe's one process sees
        # and every rank reaches the same migration decision
        acc = {}
        for b in local_batches:
            for k, v in b.sparse_features.scalar_metrics().items():
                acc.setdefault(k, []).append(v)
        keys = sorted(acc)
        means = torch.tensor([float(np.mean(acc[k])) for k in keys],
                             dtype=torch.float64)
        if world > 1:
            import torch.distributed as dist

            means = means.to(dev)
            dist.all_reduce(means)
            means = means.cpu() / world
        registry.absorb(dict(zip(keys, means.tolist())))

    def make_pipeline(for_dmp, state):
        return LocalShardPipeline(for_dmp.train_step, state, env,
                                  on_host_batch=absorb_host_batch)

    barrier = ctx.commit_barrier(deadline_s=30.0) if ctx else None
    ck = Checkpointer(ckpt_dir, commit_barrier=barrier)
    pipeline = make_pipeline(
        dmp, dmp.init(torch.Generator(device=dev).manual_seed(seed)))
    loop = FaultTolerantTrainLoop(pipeline, ck, dmp, checkpoint_interval=1,
                                  resume=True, checkpoint_on_start=True,
                                  elastic_resume=True)
    monitor = HealthMonitor(registry, assumptions, warmup=4,
                            min_consecutive=2)
    loop.attach_telemetry(registry, interval=1)
    loop.attach_health(monitor)
    migrator = None
    if migrate:
        trigger = ReplanTrigger(monitor, cooldown_steps=cooldown_steps,
                                reject_cooldown_steps=3)
        hook = phase_hook
        if hook is None and ctx is not None and ctx.fault_plan is not None:
            kill_phase = ctx.fault_plan.migration_kill_phase(ctx.rank,
                                                             ctx.gen)
            if kill_phase is not None:
                import signal as _signal

                def hook(phase, _kill=kill_phase):
                    if phase == _kill:
                        sys.stderr.write(
                            f"fault injection: SIGKILL in migration {phase} "
                            f"window (rank {ctx.rank}, committed step "
                            f"{ck.latest_step()})\n")
                        sys.stderr.flush()
                        os.kill(os.getpid(), _signal.SIGKILL)

        migrator = PlanMigrator(trigger, planner_factory=make_planner,
                                pipeline_factory=make_pipeline,
                                tables=tables, base_context=planner.ctx,
                                min_improvement=min_improvement,
                                phase_hook=hook)
        loop.attach_migrator(migrator)

    start = loop.resumed_from or 0

    def local_stream():
        for g in range(start, target_steps):
            drifted = drift_step is not None and g >= drift_step
            yield make_local_batch(seed, g, rank, drifted, widths)

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
        losses.append(float(m["loss"]))
        g = start + loop.applied_steps
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
        "alarms": len(monitor.alerts),
        "alerts": [dataclasses.asdict(a) for a in monitor.alerts],
        "migration": migrator.summary() if migrator else None,
        "initial_plan": {t: ps.sharding_type.value for t, ps in plan.items()},
        "final_plan": {t: ps.sharding_type.value
                       for t, ps in loop.dmp.plan.items()},
        "final_plan_payload": serialize_plan_for_env(loop.dmp.plan),
        "losses": losses,
        "restore_seconds": loop.checkpoint_restore_seconds,
        "save_seconds": loop.checkpoint_save_seconds,
        # this process's kernel launches (none on the CPU)
        "launches": {k: v for k, v in launch_counts().items() if v},
        # rank 0 reads the committed final step (every rank's save of it
        # has returned, so the directory is whole)
        "digest": (checkpoint_digest(ckpt_dir, final_step)
                   if rank == 0 and final_step is not None else None),
    }
    if out_path and rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    print("MIGRATE_RESULT", json.dumps(result), flush=True)
    if barrier is not None:
        barrier.close()
    if ctx is not None:
        ctx.shutdown()
    return result


def drill_arms(env, tmp: str, target: int, drift_step: int,
               clean_target: Optional[int] = None, seed: int = 11,
               widths: Widths = Widths(), min_improvement: float = 0.2,
               topology_fn=None) -> dict:
    """The migration drill's arms in ranks that joined their group
    (``env``), under ``tmp``: ``drift`` (the stream drifts at
    ``drift_step``, the migrator armed), ``restart`` (a clean restart
    from a copy of the drift arm's migration-committed step under its
    final plan, the migrator off; absent when no migration completed) and
    ``clean`` (no drift, the migrator armed, ``clean_target`` steps).
    Returns each arm's result and seconds; only rank 0's carry
    digests."""
    import shutil
    import time

    import torch.distributed as dist

    from torchrec_tpu_torch.ir.serializer import deserialize_plan

    kw = dict(seed=seed, widths=widths, env=env, topology_fn=topology_fn)
    out = {}
    t0 = time.perf_counter()
    out["drift"] = run(target, os.path.join(tmp, "drift"),
                       drift_step=drift_step, migrate=True,
                       min_improvement=min_improvement, **kw)
    out["drift_s"] = time.perf_counter() - t0
    done = [r for r in out["drift"]["migration"]["reports"]
            if r["outcome"] == "completed"]
    if done:
        step = done[0]["committed_step"]
        restart = os.path.join(tmp, "restart")
        if env.rank == 0:
            shutil.copytree(os.path.join(tmp, "drift", f"step_{step}"),
                            os.path.join(restart, f"step_{step}"))
        if env.world_size > 1:
            dist.barrier()
        t0 = time.perf_counter()
        out["restart"] = run(
            target, restart, drift_step=drift_step, migrate=False,
            plan_override=deserialize_plan(
                out["drift"]["final_plan_payload"]), **kw)
        out["restart_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["clean"] = run(clean_target or target, os.path.join(tmp, "clean"),
                       drift_step=None, migrate=True,
                       min_improvement=min_improvement, **kw)
    out["clean_s"] = time.perf_counter() - t0
    return out


def _ints(s: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x)


def _floats(s: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in s.split(",") if x)


def widths_args(widths: Widths) -> list:
    """The CLI arguments that give ``widths``."""
    return ["--rows", ",".join(map(str, widths.rows)),
            "--dim", str(widths.dim), "--batch", str(widths.batch),
            "--cap-ids", ",".join(map(str, widths.cap_ids)),
            "--min-ids", ",".join(map(str, widths.min_ids)),
            "--pooling", ",".join(map(str, widths.pooling)),
            "--plan-pad-eff", str(widths.plan_pad_eff),
            "--dense-in", str(widths.dense_in),
            "--dense-arch", ",".join(map(str, widths.dense_arch)),
            "--over-arch", ",".join(map(str, widths.over_arch))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI over :func:`run` (the supervisor spawns this file)."""
    d = Widths()
    ap = argparse.ArgumentParser(prog="migration_demo")
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: the card)")
    ap.add_argument("--drift-step", type=int, default=None)
    ap.add_argument("--no-migrate", action="store_true")
    ap.add_argument("--min-improvement", type=float, default=0.2)
    ap.add_argument("--rows", type=_ints, default=d.rows)
    ap.add_argument("--dim", type=int, default=d.dim)
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--cap-ids", type=_ints, default=d.cap_ids)
    ap.add_argument("--min-ids", type=_ints, default=d.min_ids)
    ap.add_argument("--pooling", type=_floats, default=d.pooling)
    ap.add_argument("--plan-pad-eff", type=float, default=d.plan_pad_eff)
    ap.add_argument("--dense-in", type=int, default=d.dense_in)
    ap.add_argument("--dense-arch", type=_ints, default=d.dense_arch)
    ap.add_argument("--over-arch", type=_ints, default=d.over_arch)
    ns = ap.parse_args(argv)
    widths = Widths(ns.rows, ns.dim, ns.batch, ns.cap_ids, ns.min_ids,
                    ns.pooling, ns.plan_pad_eff, ns.dense_in, ns.dense_arch,
                    ns.over_arch)
    run(ns.steps, ns.ckpt, out_path=ns.out, seed=ns.seed, device=ns.device,
        widths=widths, drift_step=ns.drift_step, migrate=not ns.no_migrate,
        min_improvement=ns.min_improvement)
    return 0


if __name__ == "__main__":
    # spawned as a bare script: the repository root on the path before
    # run() imports the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main())
