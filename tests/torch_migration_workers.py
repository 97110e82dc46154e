"""The ranks of the port's plan-migration test
(``tests/test_torch_migration.py``): a function that
``multiprocess.launch`` runs in spawned processes over a gloo process
group on the CPU.  It imports torch and the port only (the JAX side runs
in the test's own process) and returns plain data."""

from __future__ import annotations

from torchrec_tpu_torch.parallel import multiprocess as mp
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.planner.types import Topology
from torchrec_tpu_torch.reliability.migration_demo import drill_arms


def jax_topology(profile):
    """``world -> Topology`` of the JAX planner's default device, whose
    constants ``profile`` carries."""
    return lambda world: Topology(world_size=world, device="v5p",
                                  profile=dict(profile))


def drill_rank(tmp, target, drift, clean_target, profile):
    """One gloo rank on the CPU running the migration drill's arms under
    the JAX planner's device constants; returns the arms' results."""
    mp.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device="cpu")
    return drill_arms(env, tmp, target, drift, clean_target=clean_target,
                      topology_fn=jax_topology(profile))
