"""Plan compilation and parameter plumbing for sharded embedding modules
(a subset of ``torchrec_tpu/parallel/grouped.py``): tables are grouped by
(sharding type, dim) into stacked layouts.

Ported for TABLE_WISE groups only; every other sharding type raises
``NotImplementedError`` (row-wise, table-row-wise, data-parallel and
column-wise layouts come with multi-GPU sharding, ROADMAP A6).  Left out:
the hierarchical topology, qcomms, ``stack_rows_for_table``,
``feature_table_info`` and ``param_specs``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.ops.fused_update import (
    FusedOptimConfig,
    init_optimizer_state,
)
from torchrec_tpu_torch.parallel.sharding.common import (
    FeatureSpec,
    feature_specs_for_tables,
)
from torchrec_tpu_torch.parallel.sharding.tw import (
    TwGroupLayout,
    WeightLike,
    build_tw_layout,
    tw_params_from_tables,
    tw_tables_from_params,
)
from torchrec_tpu_torch.parallel.types import (
    EmbeddingModuleShardingPlan,
    ShardingType,
)

_I32_MAX = (1 << 31) - 1


@dataclasses.dataclass
class GroupedLayouts:
    """Output of :func:`classify_plan`: the TW layouts by group name and
    the features in KJT/KT order."""

    tw_layouts: Dict[str, TwGroupLayout]
    feature_order: Tuple[str, ...]
    feature_dims: Tuple[int, ...]


def classify_plan(
    tables: Sequence[EmbeddingBagConfig],
    plan: EmbeddingModuleShardingPlan,
    world_size: int,
    batch_size: int,
    feature_caps: Dict[str, int],
) -> GroupedLayouts:
    """Group the plan's TABLE_WISE tables by dim (group ``tw_d{dim}``) and
    compile their layouts."""
    specs = feature_specs_for_tables(tables, feature_caps)
    by_table: Dict[str, List[FeatureSpec]] = {}
    for s in specs:
        by_table.setdefault(s.table_name, []).append(s)
    tw_feats: Dict[int, List[FeatureSpec]] = {}
    tw_owner: Dict[str, List[int]] = {}
    for cfg in tables:
        ps = plan[cfg.name]
        if ps.sharding_type != ShardingType.TABLE_WISE:
            raise NotImplementedError(
                f"{cfg.name}: {ps.sharding_type.value} sharding is not "
                "ported (table-wise only)"
            )
        if not ps.ranks or ps.num_col_shards != 1 or len(ps.ranks) != 1:
            raise ValueError(f"{cfg.name}: a table-wise plan needs one rank")
        tw_owner[cfg.name] = list(ps.ranks)
        for s in by_table.get(cfg.name, []):
            tw_feats.setdefault(cfg.embedding_dim, []).append(s)
    tw_layouts = {
        f"tw_d{d}": build_tw_layout(f"tw_d{d}", feats, tw_owner, world_size,
                                    batch_size)
        for d, feats in sorted(tw_feats.items())
    }
    for n, lay in tw_layouts.items():
        # the kernels index the stack with int32 row ids
        if lay.world_size * lay.r_stack > _I32_MAX:
            raise ValueError(f"group {n}: {lay.world_size * lay.r_stack} "
                             "stacked rows exceed the int32 index range")
    return GroupedLayouts(
        tw_layouts=tw_layouts,
        feature_order=tuple(s.name for s in specs),
        feature_dims=tuple(s.dim for s in specs),
    )


class GroupedShardingBase:
    """Parameter and optimizer-state plumbing of the sharded modules.
    Subclasses are dataclasses exposing ``tables`` and ``tw_layouts``."""

    def params_from_tables(
        self,
        table_weights: Mapping[str, WeightLike],
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> Dict[str, torch.Tensor]:
        """Table-name-keyed full weights -> the group stacks."""
        return {
            name: tw_params_from_tables(lay, table_weights, dtype, device)
            for name, lay in self.tw_layouts.items()
        }

    def tables_to_weights(
        self, params: Mapping[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """The group stacks -> table-name-keyed full weights (views)."""
        out: Dict[str, torch.Tensor] = {}
        for name, lay in self.tw_layouts.items():
            out.update(tw_tables_from_params(lay, params[name]))
        return out

    def init_params(
        self,
        generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
    ) -> Dict[str, torch.Tensor]:
        """Fresh group stacks on the generator's device: each table drawn
        by its config's ``init_fn`` in table order, then cast to
        ``dtype``."""
        weights = {c.name: c.init_fn(generator) for c in self.tables}
        return self.params_from_tables(weights, dtype, generator.device)

    def init_fused_state(
        self, config: FusedOptimConfig, device=None
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fused-optimizer state per group, in the stack's row layout and
        the optimizer's layout of ``ops/fused_update.py`` (rowwise
        Adagrad's ``[R]`` momentum, Adagrad's ``[R, D]``, the Adam
        family's ``m``, ``v`` and ``step``)."""
        return {
            name: init_optimizer_state(config, lay.world_size * lay.r_stack,
                                       lay.dim, device)
            for name, lay in self.tw_layouts.items()
        }
