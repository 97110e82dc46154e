"""Sharded EmbeddingCollection, the unpooled (sequence) embedding runtime
(``torchrec_tpu/parallel/embedding.py``).

The plan compiles as the pooled collection's does (``grouped.py``: the
same group layouts and parameter plumbing), with the sequence variants of
the dists: table-wise and column-wise groups through
``sharding/tw.py::tw_sequence_*``, row-wise ones through
``sharding/rw.py::rw_sequence_*``; TABLE_ROW_WISE and GRID_SHARD have no
sequence variant and raise.  :meth:`ShardedEmbeddingCollection.
forward_local` returns ``{feature: JaggedTensor([cap_f, D], the input
KJT's lengths)}``, the rows of the padding slots zero; a row gather has
no sum, so every plan gives the unsharded ``EmbeddingCollection``'s rows
bit for bit.  A data-parallel group gathers its rows from its own
replica.

:meth:`~ShardedEmbeddingCollection.backward_and_update_local` takes each
id's gradient row back to its owner and applies the fused optimizer
through the dedup fused update (B6, ``ops/tbe_backward.py``), each id one
segment of weight 1: B6 sums each row's gradients in slot order and runs
the optimizer math of the JAX package's ``apply_sparse_update``, the
update the JAX collection applies.  A data-parallel group's per-id
gradients are all-gathered from every rank and every row of its stack
takes the step (``grouped.step_every_row``), as the JAX package's dense
all-reduced update of every row does.

``index_dedup`` dedupes each key's ids before the dists (the unique ids
front-packed into example 0), looks each distinct id up once and expands
the rows back to their positions; the backward sums each position's
gradient onto its unique slot (in slot order, so the bits do not depend
on a scatter's order) before the dists.

Left out: variable-batch (VBE) KJTs, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.ops.embedding_ops import (
    aggregate_duplicate_rows,
    dedup_ids,
    dedup_inverse,
    sequence_embedding_lookup,
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
    step_every_row,
)
from torchrec_tpu_torch.parallel.qcomm import qcomm_all_gather
from torchrec_tpu_torch.parallel.sharding.common import per_slot_segments
from torchrec_tpu_torch.parallel.sharding.rw import (
    RwGroupLayout,
    rw_sequence_backward_local,
    rw_sequence_forward_local,
)
from torchrec_tpu_torch.parallel.sharding.tw import (
    TwGroupLayout,
    tw_sequence_backward_local,
    tw_sequence_forward_local,
)
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan
from torchrec_tpu_torch.sparse import JaggedTensor, KeyedJaggedTensor

# the EC's update: B6, the JAX collection's XLA update
UPDATE_KERNEL = "dedup"


def _per_id(ids: torch.Tensor, valid: torch.Tensor,
            row_grads: torch.Tensor) -> SparseSegGrad:
    """Per-id gradients as a segment-level gradient: slot ``i`` is
    segment ``i``, weight 1."""
    segs = torch.arange(ids.shape[0], device=ids.device)
    return SparseSegGrad(ids, valid, segs, None, row_grads)


@dataclasses.dataclass
class ShardedEmbeddingCollection(GroupedShardingBase):
    """Plan-compiled sharded EC: build once on the host, then run
    :meth:`forward_local` and :meth:`backward_and_update_local` per step
    on every rank."""

    tables: Tuple[EmbeddingConfig, ...]
    plan: EmbeddingModuleShardingPlan
    world_size: int
    batch_size: int
    tw_layouts: Dict[str, TwGroupLayout]
    rw_layouts: Dict[str, RwGroupLayout]
    twrw_layouts: Dict[str, object]  # always empty (no sequence TWRW/GRID)
    dp_groups: Dict[str, DpGroup]
    feature_order: Tuple[str, ...]
    feature_dims: Tuple[int, ...]
    feature_caps: Dict[str, int]
    index_dedup: bool = False

    @staticmethod
    def build(
        tables: Sequence[EmbeddingConfig],
        plan: EmbeddingModuleShardingPlan,
        world_size: int,
        batch_size: int,
        feature_caps: Dict[str, int],
        index_dedup: bool = False,
    ) -> "ShardedEmbeddingCollection":
        g = classify_plan(tables, plan, world_size, batch_size, feature_caps,
                          allow_block_sharding=False)
        return ShardedEmbeddingCollection(
            tables=tuple(tables), plan=dict(plan), world_size=world_size,
            batch_size=batch_size, tw_layouts=g.tw_layouts,
            rw_layouts=g.rw_layouts, twrw_layouts=g.twrw_layouts,
            dp_groups=g.dp_groups, feature_order=g.feature_order,
            feature_dims=g.feature_dims, feature_caps=dict(feature_caps),
            index_dedup=index_dedup,
        )

    def _dedup_kjt(self, kjt: KeyedJaggedTensor):
        """Per key, the distinct ids front-packed into example 0, and the
        inverse map (each original position -> its unique slot) with the
        positions' validity, for the re-expansion."""
        keys, co = kjt.keys(), kjt.cap_offsets()
        seg = kjt.segment_ids()
        total, B = kjt.total_stride, kjt.stride()
        vals = kjt.values()
        big = torch.iinfo(vals.dtype).max
        new_vals, new_lens = [], []
        invs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for f, k in enumerate(keys):
            region = vals[co[f]: co[f + 1]]
            valid = seg[co[f]: co[f + 1]] < total
            order, unique_slot, slot_rows = dedup_ids(region, valid)
            n_u = (slot_rows != big).sum().to(torch.int32)
            new_vals.append(torch.where(slot_rows == big, 0, slot_rows))
            lens = torch.zeros((B,), dtype=torch.int32, device=vals.device)
            lens[0] = n_u
            new_lens.append(lens)
            invs[k] = (dedup_inverse(order, unique_slot), valid)
        kjt_u = KeyedJaggedTensor(keys, torch.cat(new_vals),
                                  torch.cat(new_lens), stride=B,
                                  caps=kjt.caps)
        return kjt_u, invs

    def forward_local(
        self,
        params: Mapping[str, torch.Tensor],
        kjt: KeyedJaggedTensor,
        env: Optional[ShardingEnv] = None,
    ) -> Tuple[Dict[str, JaggedTensor], Dict[str, Tuple]]:
        """Input dist, row gather and output dist of every group on this
        rank's batch.  Returns ({feature: JaggedTensor([cap_f, D], the
        input lengths)}, ctx per group).  ``env``: the rank's world (None:
        one rank)."""
        if kjt.variable_stride_per_key:
            raise NotImplementedError(
                "sharded execution of variable-stride KJTs")
        orig = kjt
        dedup_inv = None
        if self.index_dedup:
            kjt, dedup_inv = self._dedup_kjt(kjt)
        values: Dict[str, torch.Tensor] = {}
        ctxs: Dict[str, Tuple] = {}
        for name, lay in self.tw_layouts.items():
            o, ctxs[name] = tw_sequence_forward_local(lay, params[name], kjt,
                                                      env)
            values.update(o)
        for name, lay in self.rw_layouts.items():
            o, ctxs[name] = rw_sequence_forward_local(lay, params[name], kjt,
                                                      env)
            values.update(o)
        for name, g in self.dp_groups.items():
            o, ctxs[name] = self._dp_forward(g, params[name], kjt)
            values.update(o)
        if dedup_inv is not None:
            expanded = {}
            for f in self.feature_order:
                inv, valid = dedup_inv[f]
                rows = values[f][inv.clamp(0, values[f].shape[0] - 1)]
                expanded[f] = torch.where(valid[:, None], rows,
                                          rows.new_zeros(()))
            values = expanded
            ctxs["__dedup_inv__"] = dedup_inv
        out = {f: JaggedTensor(values[f], orig[f].lengths())
               for f in self.feature_order}
        return out, ctxs

    def _dp_forward(self, g: DpGroup, stack: torch.Tensor,
                    kjt: KeyedJaggedTensor):
        """A replicated group's rows of this rank's ids."""
        B = self.batch_size
        outs, parts = {}, []
        for f in g.features:
            jt = kjt[f.name]
            valid = per_slot_segments(jt.lengths(), f.cap) < B
            ids = jt.values().to(torch.int32) + g.local_offset[f.table_name]
            outs[f.name] = sequence_embedding_lookup(stack, ids, valid)
            parts.append((ids, valid))
        return outs, tuple(parts)

    def _unique_grads(
        self, dedup_inv, grad_by_feature: Mapping[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Each position's gradient summed onto its unique slot, in slot
        order (the chain rule through the expansion gather)."""
        out = {}
        for f in self.feature_order:
            inv, valid = dedup_inv[f]
            g = grad_by_feature[f].to(torch.float32)
            cap = g.shape[0]
            rows, agg = aggregate_duplicate_rows(inv, valid, g)
            buf = g.new_zeros((cap + 1, g.shape[1]))
            buf[rows.clamp(max=cap)] = agg  # unused groups: zero, spare row
            out[f] = buf[:cap]
        return out

    def backward_local(
        self,
        ctxs: Mapping[str, Tuple],
        grad_by_feature: Mapping[str, torch.Tensor],  # [cap_f, D]
        env: Optional[ShardingEnv] = None,
    ) -> Dict[str, SparseSegGrad]:
        """Reverse dists without the update: each group's per-id gradients
        against this rank's stack (each id its own segment of weight 1),
        in :attr:`group_names` order; a data-parallel group's of every
        rank, extended to step every row."""
        dedup_inv = ctxs.get("__dedup_inv__")
        if dedup_inv is not None:
            grad_by_feature = self._unique_grads(dedup_inv, grad_by_feature)
        sgs: Dict[str, SparseSegGrad] = {}
        for name, lay in self.tw_layouts.items():
            sgs[name] = _per_id(*tw_sequence_backward_local(
                lay, ctxs[name], grad_by_feature, env))
        for name, lay in self.rw_layouts.items():
            sgs[name] = _per_id(*rw_sequence_backward_local(
                lay, ctxs[name], grad_by_feature, env))
        for name, g in self.dp_groups.items():
            sgs[name] = step_every_row(
                self._dp_backward(g, ctxs[name], grad_by_feature, env),
                g.stack_rows)
        return sgs

    def backward_and_update_local(
        self,
        params: Mapping[str, torch.Tensor],
        fused_state: Mapping[str, Dict[str, torch.Tensor]],
        ctxs: Mapping[str, Tuple],
        grad_by_feature: Mapping[str, torch.Tensor],  # [cap_f, D]
        config: FusedOptimConfig,
        env: Optional[ShardingEnv] = None,
        learning_rate: Optional[float] = None,
    ) -> None:
        """Reverse dists and apply the fused optimizer through B6 (module
        docstring), in place: the ids of every sharded group, every row of
        a data-parallel group.  ``learning_rate`` overrides ``config``'s
        for this step."""
        for name, sg in self.backward_local(ctxs, grad_by_feature,
                                            env).items():
            apply_sparse_update_segments(
                params[name], fused_state[name], sg, config,
                update_kernel=UPDATE_KERNEL, learning_rate=learning_rate)

    def _dp_backward(self, g: DpGroup, ctx: Tuple,
                     grad_by_feature: Mapping[str, torch.Tensor],
                     env: Optional[ShardingEnv]) -> SparseSegGrad:
        """A replicated group's per-id gradients of every rank (ids,
        validity and rows all-gathered in rank order), each id its own
        segment: every rank applies the same update to its replica."""
        ids = torch.cat([i for i, _ in ctx])
        valid = torch.cat([v for _, v in ctx])
        rg = torch.cat([torch.where(
            v[:, None], grad_by_feature[f.name].to(torch.float32), 0.0)
            for f, (_, v) in zip(g.features, ctx)])
        env = resolve_env(env, self.world_size, ids.device)
        N = env.world_size
        tag = f"{g.name}:bwd_dist"

        def gather(x):
            return qcomm_all_gather(x, env, None, "bwd", tag=tag, fanout=N)

        return _per_id(gather(ids).reshape(-1), gather(valid).reshape(-1),
                       gather(rg).reshape(-1, rg.shape[1]))
