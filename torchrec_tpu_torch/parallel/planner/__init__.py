"""Planner package surface — mirrors the reference's
``torchrec.distributed.planner`` __init__ (planner + constraints +
topology re-exported from the package root)."""

from torchrec_tpu_torch.parallel.planner.planners import EmbeddingShardingPlanner
from torchrec_tpu_torch.parallel.planner.provider import load_plan, save_plan
from torchrec_tpu_torch.parallel.planner.types import (
    ParameterConstraints,
    PlannerError,
    Topology,
)

__all__ = [
    "EmbeddingShardingPlanner",
    "load_plan",
    "save_plan",
    "ParameterConstraints",
    "PlannerError",
    "Topology",
]
