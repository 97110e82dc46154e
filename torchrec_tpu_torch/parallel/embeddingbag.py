"""Sharded EmbeddingBagCollection, the model-parallel pooled-embedding
runtime (a subset of ``torchrec_tpu/parallel/embeddingbag.py``).

The plan compiles on the host into group layouts; every rank runs
:meth:`ShardedEmbeddingBagCollection.forward_local` on its own batch and
its own share of the stacks, each group's input dist, lookup (a pooled
kernel of ``ops/tbe.py``) and output dist over the rank's
:class:`~torchrec_tpu_torch.parallel.comm.ShardingEnv`, and
:meth:`~ShardedEmbeddingBagCollection.backward_and_update_local` feeds
each sharded group's segment-level gradient to the fused update (a kernel
of ``ops/tbe_backward.py``), which writes the rank's stacks and their
optimizer state in place.  Data-parallel groups are replicated: each rank
pools its own examples, every rank's slots and their gradients are
all-gathered, and every rank applies the same update to its replica
through the same fused kernel, the global batch's slots in one device's
order (the JAX package all-reduces a dense table gradient and applies
its XLA update, ``apply_sparse_update(..., dedup=False)``: the same
sums, another rounding).

The caller names both kernels (``lookup_kernel``, ``update_kernel``:
``"tbe"`` or ``"dedup"``).  The dedup kernels run on table-wise groups,
whose owner's call is the same local call at any world size; on row-wise
and block-shard groups they belong with the dedup'd row-wise dist
(ROADMAP A7) and raise.

Left out: the dedup'd and hierarchical dists, variable-batch KJTs, the
traced id sanitizer, ``dedup_overflow`` and ``backward_rows_local`` (its
callers, FULLY_SHARDED 2D, are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.ops.embedding_ops import (
    SlotRegions,
    pooled_embedding_lookup,
    pooled_embedding_lookup_regions,
)
from torchrec_tpu_torch.ops.fused_update import (
    FusedOptimConfig,
    SparseSegGrad,
    apply_sparse_update_segments,
)
from torchrec_tpu_torch.parallel.comm import ShardingEnv, resolve_env
from torchrec_tpu_torch.parallel.grouped import (
    DpGroup,
    GroupedShardingBase,
    classify_plan,
)
from torchrec_tpu_torch.parallel.qcomm import qcomm_all_gather
from torchrec_tpu_torch.parallel.sharding.common import (
    per_slot_segments,
    source_weights,
)
from torchrec_tpu_torch.parallel.sharding.rw import (
    RwGroupLayout,
    rw_backward_local,
    rw_forward_local,
)
from torchrec_tpu_torch.parallel.sharding.tw import (
    TwGroupLayout,
    tw_backward_local,
    tw_forward_local,
)
from torchrec_tpu_torch.parallel.sharding.twrw import (
    TwRwGroupLayout,
    twrw_backward_local,
    twrw_forward_local,
)
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, KeyedTensor

_FORWARD = {"rw": rw_forward_local, "twrw": twrw_forward_local}
_BACKWARD = {"rw": rw_backward_local, "twrw": twrw_backward_local}


def _require_tbe(kernel: str, name: str, what: str) -> None:
    if kernel != "tbe":
        raise NotImplementedError(
            f"group {name}: the {kernel!r} {what} kernel on row-wise groups "
            "comes with the dedup'd row-wise dist (ROADMAP A7)")


@dataclasses.dataclass
class ShardedEmbeddingBagCollection(GroupedShardingBase):
    """Plan-compiled sharded EBC: build once on the host, then run
    :meth:`forward_local` and :meth:`backward_and_update_local` per step
    on every rank."""

    tables: Tuple[EmbeddingBagConfig, ...]
    plan: EmbeddingModuleShardingPlan
    world_size: int
    batch_size: int  # per rank
    tw_layouts: Dict[str, TwGroupLayout]
    rw_layouts: Dict[str, RwGroupLayout]
    twrw_layouts: Dict[str, TwRwGroupLayout]
    dp_groups: Dict[str, DpGroup]
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
            rw_layouts=g.rw_layouts, twrw_layouts=g.twrw_layouts,
            dp_groups=g.dp_groups, feature_order=g.feature_order,
            feature_dims=g.feature_dims,
        )

    def sharded_groups(self):
        """(kind ``"tw"``, ``"rw"`` or ``"twrw"``, name, layout) of every
        sharded group, in group order."""
        for kind, layouts in (("tw", self.tw_layouts),
                              ("rw", self.rw_layouts),
                              ("twrw", self.twrw_layouts)):
            for name, lay in layouts.items():
                yield kind, name, lay

    def forward_local(
        self,
        params: Mapping[str, torch.Tensor],
        kjt: KeyedJaggedTensor,
        lookup_kernel: str = "tbe",
        env: Optional[ShardingEnv] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
        """Input dist + lookup + output dist for every group, on this
        rank's batch and stacks.  Returns ({feature: [B, dim]}, ctx per
        group).  ``env``: the rank's world (None: one rank)."""
        outs: Dict[str, torch.Tensor] = {}
        ctxs: Dict[str, Tuple] = {}
        for kind, name, lay in self.sharded_groups():
            if kind == "tw":
                o, ctx = tw_forward_local(lay, params[name], kjt,
                                          lookup_kernel, env)
            else:
                _require_tbe(lookup_kernel, name, "lookup")
                o, ctx = _FORWARD[kind](lay, params[name], kjt, env)
            outs.update(o)
            ctxs[name] = ctx
        for name, g in self.dp_groups.items():
            o, ctx = self._dp_forward(g, params[name], kjt, lookup_kernel)
            outs.update(o)
            ctxs[name] = ctx
        return outs, ctxs

    def _dp_forward(self, g: DpGroup, stack: torch.Tensor,
                    kjt: KeyedJaggedTensor, lookup_kernel: str):
        """A replicated group's lookup over this rank's examples: each
        feature's KJT slots a region, offset into the group's stack."""
        B = self.batch_size
        jts = kjt.to_dict()
        ids, ws, lens, starts, caps = [], [], [], [], []
        start = 0
        for f in g.features:
            jt = jts[f.name]
            seg = per_slot_segments(jt.lengths(), f.cap)
            ws.append(source_weights(jt.weights_or_none(), seg, jt.lengths(),
                                     f.pooling))
            ids.append(jt.values().to(torch.int32)
                       + g.local_offset[f.table_name])
            lens.append(jt.lengths())
            starts.append(start)
            caps.append(f.cap)
            start += f.cap
        ids_c, w_c = torch.cat(ids), torch.cat(ws)
        regions = SlotRegions(torch.cat(lens), tuple(starts), tuple(caps),
                              (B,) * len(g.features))
        segs = regions.segment_ids(ids_c.shape[0])
        if lookup_kernel == "tbe":
            pooled = pooled_embedding_lookup_regions(stack, ids_c, regions,
                                                     w_c)
        else:
            pooled = pooled_embedding_lookup(stack, ids_c, segs,
                                             regions.num_segments, w_c,
                                             kernel=lookup_kernel)
        outs = {f.name: pooled[i * B:(i + 1) * B]
                for i, f in enumerate(g.features)}
        return outs, (ids_c, w_c, segs, regions)

    def backward_and_update_local(
        self,
        params: Mapping[str, torch.Tensor],
        fused_state: Mapping[str, Dict[str, torch.Tensor]],
        ctxs: Mapping[str, Tuple],
        grad_by_feature: Mapping[str, torch.Tensor],
        config: FusedOptimConfig,
        sr_seeds: Optional[Sequence[int]] = None,
        update_kernel: str = "tbe",
        env: Optional[ShardingEnv] = None,
        learning_rate: Optional[float] = None,
    ) -> None:
        """Reverse dists and apply the fused optimizer to the touched rows
        of every group, in place.  ``sr_seeds``: one int32 seed per group
        (:attr:`group_names` order) for stochastic rounding of bfloat16
        stacks, or None (round to nearest); a DP group's seed must be the
        same on every rank, or the replicas fork.  ``learning_rate``
        overrides ``config``'s for this step (a sparse lr schedule)."""
        seeds = dict(zip(self.group_names, sr_seeds or ()))
        for kind, name, lay in self.sharded_groups():
            if kind == "tw":
                sg = tw_backward_local(lay, ctxs[name], grad_by_feature, env)
            else:
                _require_tbe(update_kernel, name, "update")
                sg = _BACKWARD[kind](lay, ctxs[name], grad_by_feature, env)
            apply_sparse_update_segments(
                params[name], fused_state[name], sg, config,
                sr_seed=seeds.get(name), update_kernel=update_kernel,
                learning_rate=learning_rate)
        for name, g in self.dp_groups.items():
            sg = self._dp_backward(g, ctxs[name], grad_by_feature, env)
            apply_sparse_update_segments(
                params[name], fused_state[name], sg, config,
                sr_seed=seeds.get(name), update_kernel=update_kernel,
                learning_rate=learning_rate)

    def _dp_backward(self, g: DpGroup, ctx: Tuple,
                     grad_by_feature: Mapping[str, torch.Tensor],
                     env: Optional[ShardingEnv]) -> SparseSegGrad:
        """A replicated group's sparse gradient over every rank's slots:
        the ranks' ids, weights, segments and pooled gradients
        all-gathered (a ``[F * B, dim]`` block a rank, where the JAX
        package all-reduces a dense ``[rows, dim]`` gradient), so every
        rank applies the same update to its replica, each row's slots
        summed in the global batch's order, as one device would."""
        ids_c, w_c, segs = ctx[:3]
        env = resolve_env(env, self.world_size, w_c.device)
        g_flat = torch.cat([grad_by_feature[f.name].to(torch.float32)
                            for f in g.features])  # [F * B, dim]
        S, N = g_flat.shape[0], env.world_size
        tag = f"{g.name}:bwd_dist"

        def gather(x):
            return qcomm_all_gather(x, env, None, "bwd", tag=tag, fanout=N)

        ids, w = gather(ids_c).reshape(-1), gather(w_c).reshape(-1)
        seg = gather(segs.to(torch.int32)).to(torch.int64)  # [N, V]
        src = torch.arange(N, device=seg.device)[:, None]
        seg = torch.where(seg < S, src * S + seg, N * S).reshape(-1)
        valid = (seg < N * S) & (w != 0)
        return SparseSegGrad(ids, valid, seg, w,
                             gather(g_flat).view(N * S, g_flat.shape[1]))

    def output_kt(self, outs: Mapping[str, torch.Tensor]) -> KeyedTensor:
        """The per-feature pooled outputs as one KeyedTensor."""
        values = torch.cat([outs[f] for f in self.feature_order], dim=-1)
        return KeyedTensor(self.feature_order, self.feature_dims, values)
