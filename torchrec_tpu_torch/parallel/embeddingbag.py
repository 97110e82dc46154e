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
order, and every row of the stack takes the step
(``grouped.step_every_row``: an untouched row a zero gradient).  The JAX
package all-reduces a dense table gradient and applies its XLA update to
every row, ``apply_sparse_update(..., dedup=False)``: the same sums,
another rounding.  :meth:`~ShardedEmbeddingBagCollection.backward_local`
is the backward without the update (the JAX package's
``backward_rows_local``, its gradients kept as slot streams), which the
FULLY_SHARDED 2D strategy gathers over the replicas.  ``qcomms``
(``parallel/qcomm.py``) sets the wire precision of every sharded group's
pooled output dist and its backward; a data-parallel group's all-gather
stays float32, as the JAX package's all-reduce of its dense gradient
takes no codec.

The caller names both kernels (``lookup_kernel``, ``update_kernel``:
``"tbe"`` or ``"dedup"``), on every group: the ragged dedup lookup (B4)
and update (B6) take a block-split group's received slots as they take a
table-wise group's.  A row-wise group of the dedup'd input dist
(``sharding/rw.py``) pools at the source with the per-id lookup (B1)
whatever the lookup kernel, and its owners update through the caller's
update kernel; :meth:`~ShardedEmbeddingBagCollection.dedup_overflow`
sums the distinct ids its capacity dropped.  With ``sanitize``, the
forward runs the traced id sanitizer (``robustness/sanitize.py``) on the
batch before any dist, its per-key counts in ``ctxs["__sanitize__"]``,
and the dedup'd groups drop its null slots before the wire.

On a two-level world (``build(hier_topo=...)``, which the DMP passes for a
``ShardingEnv`` with ``num_slices``) the row-wise and block-shard groups
whose plan sets ``hier`` run the two-level ICI/DCN dists of
``sharding/hier.py`` (source pooling by B1, their owners' updates by the
caller's update kernel), and :meth:`~ShardedEmbeddingBagCollection.
dedup_overflow` counts their dropped rows too.

A variable-batch (VBE) KJT, each key with its own stride, needs its
``inverse_indices`` (``[F, B]``: each example's row in its key's reduced
batch); without them the forward raises.  Its strides are padded to the
full batch (``KeyedJaggedTensor.pad_strides``: zero-length rows pool to
zero), every group runs its uniform path, and each feature's pooled rows
are expanded to the full batch by a row gather through its inverse
indices, kept in ``ctxs["__vbe_inv__"]``.  The backward first sums each
key's full-batch gradients onto its reduced rows (B1's sorted entry over
the gradient rows, in example order: deterministic, no float atomics),
then runs the uniform backward, as the JAX package's ``segment_sum``
does.
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
    step_every_row,
)
from torchrec_tpu_torch.parallel.qcomm import QCommsConfig, qcomm_all_gather
from torchrec_tpu_torch.parallel.sharding.common import (
    per_slot_segments,
    source_weights,
)
from torchrec_tpu_torch.parallel.sharding.hier import (
    rw_hier_backward_local,
    rw_hier_forward_local,
    twrw_hier_backward_local,
    twrw_hier_forward_local,
)
from torchrec_tpu_torch.parallel.sharding.rw import (
    RwGroupLayout,
    rw_backward_local,
    rw_dedup_backward_local,
    rw_dedup_forward_local,
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
_BACKWARD = {"tw": tw_backward_local, "rw": rw_backward_local,
             "twrw": twrw_backward_local}


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
    # per feature its table's rows, and the traced sanitizer's switch
    feature_rows: Tuple[int, ...] = ()
    sanitize: bool = False

    @staticmethod
    def build(
        tables: Sequence[EmbeddingBagConfig],
        plan: EmbeddingModuleShardingPlan,
        world_size: int,
        batch_size: int,
        feature_caps: Dict[str, int],
        qcomms: Optional[QCommsConfig] = None,
        row_align: int = 1,
        sanitize: bool = False,
        hier_topo=None,
    ) -> "ShardedEmbeddingBagCollection":
        """Compile the plan (``grouped.classify_plan``): ``qcomms`` the
        sharded groups' wire precision, ``row_align`` a multiple every
        sharded stack is rounded up to, ``sanitize`` the traced id
        sanitizer in every forward, ``hier_topo`` (a
        ``sharding.hier.HierTopology``) the two-level world whose ``hier``
        plan entries compile to the two-level dists."""
        g = classify_plan(tables, plan, world_size, batch_size, feature_caps,
                          qcomms=qcomms, row_align=row_align,
                          hier_topo=hier_topo)
        return ShardedEmbeddingBagCollection(
            tables=tuple(tables), plan=dict(plan), world_size=world_size,
            batch_size=batch_size, tw_layouts=g.tw_layouts,
            rw_layouts=g.rw_layouts, twrw_layouts=g.twrw_layouts,
            dp_groups=g.dp_groups, feature_order=g.feature_order,
            feature_dims=g.feature_dims, feature_rows=g.feature_rows,
            sanitize=sanitize,
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
        group, ``"__sanitize__"``: the ``[F]`` id violations when the
        collection sanitizes, and ``"__vbe_inv__"``: a variable-batch
        KJT's inverse indices per feature).  ``env``: the rank's world
        (None: one rank)."""
        if kjt.variable_stride_per_key:
            if kjt.inverse_indices_or_none() is None:
                raise ValueError(
                    "a variable-batch KJT needs inverse_indices for the "
                    "sharded collection to expand each key's reduced batch "
                    "to the full batch")
            kjt = kjt.pad_strides()
        inv = kjt.inverse_indices_or_none()
        vbe_inv: Optional[Dict[str, torch.Tensor]] = None
        if inv is not None:
            if kjt.stride() != self.batch_size:
                raise ValueError(f"variable-batch full stride {kjt.stride()}"
                                 f" != the layout's batch {self.batch_size}")
            keys = kjt.keys()
            vbe_inv = {f: inv[keys.index(f)].to(torch.int64)
                       for f in self.feature_order}
        outs: Dict[str, torch.Tensor] = {}
        ctxs: Dict[str, Tuple] = {}
        if self.sanitize and self.feature_rows:
            from torchrec_tpu_torch.robustness.sanitize import sanitize_kjt

            kjt, ctxs["__sanitize__"] = sanitize_kjt(
                kjt, dict(zip(self.feature_order, self.feature_rows)))
        for kind, name, lay in self.sharded_groups():
            if kind != "tw" and lay.hier is not None:
                fwd = (rw_hier_forward_local if kind == "rw"
                       else twrw_hier_forward_local)
                o, ctx = fwd(lay, params[name], kjt, env,
                             drop_zero_weight=self.sanitize)
            elif kind == "rw" and lay.dedup:
                o, ctx = rw_dedup_forward_local(
                    lay, params[name], kjt, env,
                    drop_zero_weight=self.sanitize)
            elif kind == "tw":
                o, ctx = tw_forward_local(lay, params[name], kjt,
                                          lookup_kernel, env)
            else:
                o, ctx = _FORWARD[kind](lay, params[name], kjt, env,
                                        lookup_kernel)
            outs.update(o)
            ctxs[name] = ctx
        for name, g in self.dp_groups.items():
            o, ctx = self._dp_forward(g, params[name], kjt, lookup_kernel)
            outs.update(o)
            ctxs[name] = ctx
        if vbe_inv is not None:
            # a row gather, no clipping: valid inverse indices lie below
            # the key's stride, and the backward drops any that do not
            outs = {f: o[vbe_inv[f]] for f, o in outs.items()}
            ctxs["__vbe_inv__"] = vbe_inv
        return outs, ctxs

    def _vbe_reduce(self, vbe_inv: Mapping[str, torch.Tensor],
                    grad_by_feature: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The chain rule through the forward's expansion: each feature's
        full-batch gradients ``[B, D]`` summed onto its reduced rows,
        ``out[r] = sum of g[b] over the examples b with inv[b] == r`` in
        example order, by B1's sorted entry over the gradient rows (a
        stable sort by row, then each row's examples in order; an index
        outside ``[0, B)`` drops its example)."""
        B = self.batch_size
        out = {}
        for f, g in grad_by_feature.items():
            g32 = g.to(torch.float32).contiguous()
            rows = torch.arange(B, dtype=torch.int32, device=g32.device)
            out[f] = pooled_embedding_lookup(g32, rows, vbe_inv[f], B)
        return out

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

    def backward_local(
        self,
        ctxs: Mapping[str, Tuple],
        grad_by_feature: Mapping[str, torch.Tensor],
        env: Optional[ShardingEnv] = None,
        dp_env: Optional[ShardingEnv] = None,
        dp_divisor: int = 1,
    ) -> Dict[str, SparseSegGrad]:
        """Reverse dists without the update: each group's sparse gradient
        against this rank's stack, in :attr:`group_names` order.  A
        data-parallel group's slots are gathered over ``dp_env`` (default
        ``env``), their gradients divided by ``dp_divisor``, and extended
        to step every row (``grouped.step_every_row``).  A variable-batch
        forward's gradients are first summed onto each key's reduced rows
        (:meth:`_vbe_reduce`)."""
        vbe_inv = ctxs.get("__vbe_inv__")
        if vbe_inv is not None:
            grad_by_feature = self._vbe_reduce(vbe_inv, grad_by_feature)
        out: Dict[str, SparseSegGrad] = {}
        for kind, name, lay in self.sharded_groups():
            if kind != "tw" and lay.hier is not None:
                bwd = (rw_hier_backward_local if kind == "rw"
                       else twrw_hier_backward_local)
            elif kind == "rw" and lay.dedup:
                bwd = rw_dedup_backward_local
            else:
                bwd = _BACKWARD[kind]
            out[name] = bwd(lay, ctxs[name], grad_by_feature, env)
        for name, g in self.dp_groups.items():
            sg = self._dp_backward(g, ctxs[name], grad_by_feature,
                                   dp_env or env, dp_divisor)
            out[name] = step_every_row(sg, g.stack_rows)
        return out

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
        """Reverse dists and apply the fused optimizer, in place: to the
        touched rows of every sharded group, to every row of a
        data-parallel group.  ``sr_seeds``: one int32 seed per group
        (:attr:`group_names` order) for stochastic rounding of bfloat16
        stacks, or None (round to nearest); a DP group's seed must be the
        same on every rank, or the replicas fork.  ``learning_rate``
        overrides ``config``'s for this step (a sparse lr schedule)."""
        seeds = dict(zip(self.group_names, sr_seeds or ()))
        sgs = self.backward_local(ctxs, grad_by_feature, env)
        for name, sg in sgs.items():
            apply_sparse_update_segments(
                params[name], fused_state[name], sg, config,
                sr_seed=seeds.get(name), update_kernel=update_kernel,
                learning_rate=learning_rate)

    def _dp_backward(self, g: DpGroup, ctx: Tuple,
                     grad_by_feature: Mapping[str, torch.Tensor],
                     env: Optional[ShardingEnv],
                     divisor: int = 1) -> SparseSegGrad:
        """A replicated group's sparse gradient over every rank's slots:
        the ranks' ids, weights, segments and pooled gradients
        all-gathered over ``env`` (a ``[F * B, dim]`` block a rank, where
        the JAX package all-reduces a dense ``[rows, dim]`` gradient), the
        gradients divided by ``divisor``, so every rank applies the same
        update to its replica, each row's slots summed in the global
        batch's order, as one device would."""
        ids_c, w_c, segs = ctx[:3]
        if env is None:
            env = resolve_env(None, self.world_size, w_c.device)
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
        grads = gather(g_flat).view(N * S, g_flat.shape[1])
        if divisor != 1:
            grads = grads / divisor
        return SparseSegGrad(ids, valid, seg, w, grads)

    def dedup_overflow(self, ctxs: Mapping[str, Tuple]
                       ) -> Optional[torch.Tensor]:
        """The distinct ids the dedup'd and two-level groups' capacities
        dropped this step (a 0-d int32 on the device, the sum over the
        groups), or None when no group has such a capacity."""
        ovs = [ctxs[name][5] for name, lay in self.rw_layouts.items()
               if lay.dedup or lay.hier is not None]
        ovs += [ctxs[name][5] for name, lay in self.twrw_layouts.items()
                if lay.hier is not None]
        if not ovs:
            return None
        total = ovs[0]
        for o in ovs[1:]:
            total = total + o
        return total

    def output_kt(self, outs: Mapping[str, torch.Tensor]) -> KeyedTensor:
        """The per-feature pooled outputs as one KeyedTensor."""
        values = torch.cat([outs[f] for f in self.feature_order], dim=-1)
        return KeyedTensor(self.feature_order, self.feature_dims, values)
