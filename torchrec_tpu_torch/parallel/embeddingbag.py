"""Sharded EmbeddingBagCollection, the model-parallel pooled-embedding
runtime (a subset of ``torchrec_tpu/parallel/embeddingbag.py``).

The plan compiles on the host into group layouts; the forward runs each
group's lookup (a pooled kernel of ``ops/tbe.py``) and the backward
feeds each group's segment-level gradient to the fused update (a kernel
of ``ops/tbe_backward.py``), which writes the stacks and their optimizer
state in place.  The caller names both kernels (``lookup_kernel``,
``update_kernel``: ``"tbe"`` or ``"dedup"``); both update kernels take
all eight fused optimizers.

Ported for TABLE_WISE groups on one device.  Left out: row-wise,
table-row-wise and data-parallel groups, the dedup and hierarchical
dists, variable-batch KJTs, the traced id sanitizer, ``dedup_overflow``,
``backward_rows_local`` (their callers are not ported) and the
per-call learning-rate override (sparse lr schedules are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.ops.fused_update import (
    FusedOptimConfig,
    apply_sparse_update_segments,
)
from torchrec_tpu_torch.parallel.grouped import (
    GroupedShardingBase,
    classify_plan,
)
from torchrec_tpu_torch.parallel.sharding.tw import (
    TwGroupLayout,
    tw_backward_local,
    tw_forward_local,
)
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, KeyedTensor


@dataclasses.dataclass
class ShardedEmbeddingBagCollection(GroupedShardingBase):
    """Plan-compiled sharded EBC: build once on the host, then run
    :meth:`forward_local` and :meth:`backward_and_update_local` per
    step."""

    tables: Tuple[EmbeddingBagConfig, ...]
    plan: EmbeddingModuleShardingPlan
    world_size: int
    batch_size: int  # per device
    tw_layouts: Dict[str, TwGroupLayout]
    feature_order: Tuple[str, ...]  # KJT/KT feature order
    feature_dims: Tuple[int, ...]

    @staticmethod
    def build(
        tables: Sequence[EmbeddingBagConfig],
        plan: EmbeddingModuleShardingPlan,
        world_size: int,
        batch_size: int,
        feature_caps: Dict[str, int],
    ) -> "ShardedEmbeddingBagCollection":
        g = classify_plan(tables, plan, world_size, batch_size, feature_caps)
        return ShardedEmbeddingBagCollection(
            tables=tuple(tables), plan=dict(plan), world_size=world_size,
            batch_size=batch_size, tw_layouts=g.tw_layouts,
            feature_order=g.feature_order, feature_dims=g.feature_dims,
        )

    def forward_local(
        self,
        params: Mapping[str, torch.Tensor],
        kjt: KeyedJaggedTensor,
        lookup_kernel: str = "tbe",
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
        """Input dist + lookup + output dist for every group.  Returns
        ({feature: [B, dim]}, ctx per group)."""
        outs: Dict[str, torch.Tensor] = {}
        ctxs: Dict[str, Tuple] = {}
        for name, lay in self.tw_layouts.items():
            o, ctx = tw_forward_local(lay, params[name], kjt, lookup_kernel)
            outs.update(o)
            ctxs[name] = ctx
        return outs, ctxs

    def backward_and_update_local(
        self,
        params: Mapping[str, torch.Tensor],
        fused_state: Mapping[str, Dict[str, torch.Tensor]],
        ctxs: Mapping[str, Tuple],
        grad_by_feature: Mapping[str, torch.Tensor],
        config: FusedOptimConfig,
        sr_seeds: Optional[Sequence[int]] = None,
        update_kernel: str = "tbe",
    ) -> None:
        """Reverse dists and apply the fused optimizer to the touched rows
        of every group, in place.  ``sr_seeds``: one int32 seed per group
        for stochastic rounding of bfloat16 stacks (None: round to
        nearest)."""
        for gi, (name, lay) in enumerate(self.tw_layouts.items()):
            sg = tw_backward_local(lay, ctxs[name], grad_by_feature)
            apply_sparse_update_segments(
                params[name], fused_state[name], sg, config,
                sr_seed=None if sr_seeds is None else sr_seeds[gi],
                update_kernel=update_kernel,
            )

    def output_kt(self, outs: Mapping[str, torch.Tensor]) -> KeyedTensor:
        """The per-feature pooled outputs as one KeyedTensor."""
        values = torch.cat([outs[f] for f in self.feature_order], dim=-1)
        return KeyedTensor(self.feature_order, self.feature_dims, values)
