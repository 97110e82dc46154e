"""Plan persistence with hash validation.

Reference: ``planner/provider.py`` — cache a computed plan keyed by a
hash of everything that determined it (tables, topology, batch size), so
a restart reuses the plan only while the inputs are unchanged.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence

from torchrec_tpu_torch.ir.serializer import (
    deserialize_plan,
    serialize_plan,
)
from torchrec_tpu_torch.parallel.planner.types import Topology
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan


def plan_inputs_hash(
    tables: Sequence,
    topology: Topology,
    batch_size_per_device: int,
    constraints=None,
    storage_reservation=None,
) -> str:
    """Stable hash of the plan's inputs (reference provider.py hash
    validation): tables (incl. pooling), topology budget, batch size,
    per-table constraints, and the storage reservation."""
    payload = {
        "tables": [
            {
                "name": c.name,
                "rows": c.num_embeddings,
                "dim": c.embedding_dim,
                "features": list(c.feature_names),
                "pooling": str(getattr(c, "pooling", None)),
            }
            for c in tables
        ],
        "world_size": topology.world_size,
        # the JAX package's key for the device profile's name: a plan
        # saved by either package validates in the other
        "tpu_version": topology.device,
        "slice_size": topology.slice_size,
        "hbm_per_device": topology.devices[0].storage.hbm,
        "batch_size": batch_size_per_device,
        "constraints": {
            t: {
                "sharding_types": [
                    str(s) for s in (c.sharding_types or [])
                ],
                "min_partition": c.min_partition,
                "pooling_factor": c.pooling_factor,
            }
            for t, c in (constraints or {}).items()
        },
        "reservation": repr(storage_reservation),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()


def save_plan(
    path: str,
    plan: EmbeddingModuleShardingPlan,
    tables: Sequence,
    topology: Topology,
    batch_size_per_device: int,
    constraints=None,
    storage_reservation=None,
) -> None:
    """Persist a plan keyed on the config hash (reference provider)."""
    blob = {
        "inputs_hash": plan_inputs_hash(
            tables, topology, batch_size_per_device,
            constraints, storage_reservation,
        ),
        "plan": json.loads(serialize_plan(plan)),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1)
    os.replace(tmp, path)


def load_plan(
    path: str,
    tables: Sequence,
    topology: Topology,
    batch_size_per_device: int,
    constraints=None,
    storage_reservation=None,
) -> Optional[EmbeddingModuleShardingPlan]:
    """Returns the stored plan, or None when absent OR when the inputs
    hash no longer matches (tables/topology/batch/constraints/reservation
    changed — the plan must be recomputed, reference provider.py's
    validation)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        blob = json.load(f)
    expect = plan_inputs_hash(
        tables, topology, batch_size_per_device, constraints,
        storage_reservation,
    )
    if blob.get("inputs_hash") != expect:
        return None
    return deserialize_plan(json.dumps(blob["plan"]))
