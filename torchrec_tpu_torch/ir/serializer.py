"""IR serialization — module configs as JSON metadata.

Reference: ``torchrec/ir/`` (serializer.py:161, utils.py:136 —
``encapsulate_ir_modules``/``decapsulate_ir_modules``): EBC/EC configs
serialize to JSON carried through torch.export so the sparse modules can
be reconstructed and swapped back after unflattening.

The module metadata (table configs, feature order, sharding plan)
serializes to JSON, the same strings as the JAX package's
``ir/serializer.py``, so a plan or config written by either package loads
in the other.
"""

from __future__ import annotations

import json
from typing import List, Sequence, Union

from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    EmbeddingConfig,
    PoolingType,
)
from torchrec_tpu_torch.parallel.types import (
    EmbeddingModuleShardingPlan,
    ParameterSharding,
    ShardingType,
)

IR_VERSION = 1


def serialize_embedding_configs(
    configs: Sequence[Union[EmbeddingBagConfig, EmbeddingConfig]],
) -> str:
    """Configs -> JSON (reference serializer.py:161)."""
    out = []
    for c in configs:
        d = {
            "kind": "bag" if isinstance(c, EmbeddingBagConfig) else "sequence",
            "name": c.name,
            "num_embeddings": c.num_embeddings,
            "embedding_dim": c.embedding_dim,
            "feature_names": list(c.feature_names),
            "data_type": c.data_type.value,
            "ids_per_feature_capacity": c.ids_per_feature_capacity,
            "weight_init_min": c.weight_init_min,
            "weight_init_max": c.weight_init_max,
        }
        if isinstance(c, EmbeddingBagConfig):
            d["pooling"] = c.pooling.value
        out.append(d)
    return json.dumps({"version": IR_VERSION, "tables": out})


def deserialize_embedding_configs(
    payload: str,
) -> List[Union[EmbeddingBagConfig, EmbeddingConfig]]:
    """Inverse of :func:`serialize_embedding_configs`."""
    data = json.loads(payload)
    assert data["version"] == IR_VERSION, data["version"]
    out: List[Union[EmbeddingBagConfig, EmbeddingConfig]] = []
    for d in data["tables"]:
        common = dict(
            name=d["name"],
            num_embeddings=d["num_embeddings"],
            embedding_dim=d["embedding_dim"],
            feature_names=list(d["feature_names"]),
            data_type=DataType(d["data_type"]),
            ids_per_feature_capacity=d.get("ids_per_feature_capacity"),
            weight_init_min=d.get("weight_init_min"),
            weight_init_max=d.get("weight_init_max"),
        )
        if d["kind"] == "bag":
            out.append(
                EmbeddingBagConfig(
                    pooling=PoolingType(d["pooling"]), **common
                )
            )
        else:
            out.append(EmbeddingConfig(**common))
    return out


def serialize_plan(plan: EmbeddingModuleShardingPlan) -> str:
    """Sharding plan -> JSON (shard specs, kernels, ranks) — the
    reference ir/serializer.py plan leg."""
    out = {}
    for table, ps in plan.items():
        spec = None
        if ps.sharding_spec is not None:
            spec = [
                {
                    "shard_offsets": list(m.shard_offsets),
                    "shard_sizes": list(m.shard_sizes),
                    "placement": m.placement,
                }
                for m in ps.sharding_spec
            ]
        out[table] = {
            "sharding_type": ps.sharding_type.value,
            # preserve [] vs None
            "ranks": list(ps.ranks) if ps.ranks is not None else None,
            "num_col_shards": ps.num_col_shards,
            "compute_kernel": ps.compute_kernel.value,
            "sharding_spec": spec,
            # runtime-behavior fields: a deserialized plan must compile
            # the same dists (dedup, hierarchical) and size the same
            # caches as the original, or an elastic relaunch handed a
            # replanned plan over the wire (ElasticSupervisor
            # plan_provider) would silently train a different program
            "cache_load_factor": ps.cache_load_factor,
            "dedup": ps.dedup,
            "dedup_factor": ps.dedup_factor,
            "hier": ps.hier,
            "hier_factor": ps.hier_factor,
        }
    return json.dumps({"version": IR_VERSION, "plan": out})


def deserialize_plan(payload: str) -> EmbeddingModuleShardingPlan:
    """Inverse of :func:`serialize_plan`."""
    from torchrec_tpu_torch.parallel.types import (
        EmbeddingComputeKernel,
        ShardMetadata,
    )

    data = json.loads(payload)
    assert data["version"] == IR_VERSION
    out: EmbeddingModuleShardingPlan = {}
    for table, d in data["plan"].items():
        spec = None
        if d.get("sharding_spec") is not None:
            spec = [
                ShardMetadata(
                    shard_offsets=tuple(m["shard_offsets"]),
                    shard_sizes=tuple(m["shard_sizes"]),
                    placement=m["placement"],
                )
                for m in d["sharding_spec"]
            ]
        out[table] = ParameterSharding(
            sharding_type=ShardingType(d["sharding_type"]),
            ranks=d["ranks"],
            num_col_shards=d["num_col_shards"],
            compute_kernel=EmbeddingComputeKernel(d["compute_kernel"]),
            sharding_spec=spec,
            # .get defaults keep pre-field payloads loadable
            cache_load_factor=d.get("cache_load_factor"),
            dedup=bool(d.get("dedup", False)),
            dedup_factor=float(d.get("dedup_factor", 1.0)),
            hier=bool(d.get("hier", False)),
            hier_factor=float(d.get("hier_factor", 1.0)),
        )
    return out
