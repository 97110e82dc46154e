"""Table-wise and column-wise sharded execution (a subset of
``torchrec_tpu/parallel/sharding/tw.py``).

A TW group stacks every table of one embedding dim that lives whole on
one rank (or, column-wise, every column shard: a table split into
``len(ranks)`` shards of ``dim`` columns, each a table of its own on its
rank) row-wise into one array per rank, and keeps the JAX package's
uniform ``[N, F, C]`` slot geometry: N ranks, F slots per rank, C ids per
slot.  Each rank runs

  input dist : an all-to-all of its ``[N, F, C]`` ids and per-id weights
               and its ``[N, F, B]`` lengths to the slots' owners;
  lookup     : one pooled lookup over its stack (a kernel of
               ``ops/tbe.py``, by the caller's ``lookup_kernel``): the
               per-id ``"tbe"`` lookup reads the received ``[N, F, C]``
               slots as ``N * F`` regions with no sort, each source's
               slots front-packed in example order; the ragged
               ``"dedup"`` one takes each slot's segment;
  output dist: an all-to-all of the pooled ``[N, F, B, D]`` blocks back to
               the examples' ranks, where
               each feature's column shards are concatenated;

and the backward sends the gradients of those blocks back to the owners
and hands the owner's slots to the fused update as a
:class:`SparseSegGrad`.  Example ``(src, slot, b)`` of the received slots
is segment ``(src * F + slot) * B + b`` throughout.  The collectives run
on a :class:`~torchrec_tpu_torch.parallel.comm.ShardingEnv`; at one rank
with none given they are the identity.

The sequence (unpooled) variants, :func:`tw_sequence_forward_local` and
:func:`tw_sequence_backward_local`, serve the sharded
``EmbeddingCollection``: the same input dist, a row gather of the
received ids, and an all-to-all of the ``[N, F, C, dim]`` rows back to
the ids' source positions.  A layout's ``qcomms`` (``parallel/qcomm.py``)
sets the wire precision of the pooled output dist and its backward;
``row_align`` rounds each rank's stack up to a multiple (the
FULLY_SHARDED 2D strategy splits it over the replicas).

Left out: the link-class split of the ledger.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchrec_tpu_torch.ops.embedding_ops import (
    SlotRegions,
    pooled_embedding_lookup,
    pooled_embedding_lookup_regions,
    sequence_embedding_lookup,
)
from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
from torchrec_tpu_torch.parallel.comm import ShardingEnv, resolve_env
from torchrec_tpu_torch.parallel.qcomm import QCommsConfig, qcomm_all_to_all
from torchrec_tpu_torch.parallel.sharding.common import (
    FeatureSpec,
    all_to_all,
    per_slot_segments,
    source_weights,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

WeightLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class TwSlot:
    """One table-wise slot: a table (or a column shard of one) placed
    whole on one rank within a stacked same-dim group."""

    feature: FeatureSpec
    owner: int
    slot_index: int  # slot position on owner
    out_offset: int  # column offset into the feature's embedding (CW)
    out_feature: str  # the feature this slot contributes to


@dataclasses.dataclass
class TwGroupLayout:
    """Static layout of one (TABLE_WISE | COLUMN_WISE, dim) group."""

    name: str
    world_size: int
    batch_size: int  # per-rank batch
    dim: int
    cap: int  # uniform per-slot id capacity
    f_max: int  # slots per rank (padded)
    r_stack: int  # rows per rank's stack (padded)
    slots: List[TwSlot]
    # row offset of slot j's table within owner's stack: [N, F_max]
    row_offset: np.ndarray
    # owner -> [(table_name, stack_row_offset, rows, col_offset)]
    stack_assignment: Dict[int, List[Tuple[str, int, int, int]]]
    # feature -> its slots in column order
    feature_slots: Dict[str, List[TwSlot]]
    feature_order: List[str]
    qcomms: Optional[QCommsConfig] = None  # wire precision of the dists

    @property
    def param_shape(self) -> Tuple[int, int]:
        """The stacks of all ranks, row-stacked: row r of rank d is row
        ``d * r_stack + r``."""
        return (self.world_size * self.r_stack, self.dim)


def build_tw_layout(
    name: str,
    features: Sequence[FeatureSpec],
    table_owner: Dict[str, List[int]],  # table -> owner rank per col shard
    world_size: int,
    batch_size: int,
    qcomms: Optional[QCommsConfig] = None,
    row_align: int = 1,
) -> TwGroupLayout:
    """Compile a TW/CW group: assign (feature x column-shard) slots to
    owners, stack each owner's tables (each column shard its own rows),
    pad to uniform sizes (each rank's stack rounded up to a multiple of
    ``row_align``)."""
    dim = features[0].dim
    if any(f.dim != dim for f in features):
        raise ValueError(f"group {name}: features of different dims")
    cap = max(f.cap for f in features)
    stack_assignment: Dict[int, List[Tuple[str, int, int, int]]] = {
        d: [] for d in range(world_size)
    }
    # (table, column shard) -> stack row offset on its owner
    placed: Dict[Tuple[str, int], int] = {}
    for f in features:
        for ci, owner in enumerate(table_owner[f.table_name]):
            if (f.table_name, ci) not in placed:
                off = sum(r for (_, _, r, _) in stack_assignment[owner])
                stack_assignment[owner].append((f.table_name, off,
                                                f.table_rows, ci * dim))
                placed[(f.table_name, ci)] = off

    slots: List[TwSlot] = []
    next_slot = {d: 0 for d in range(world_size)}
    feature_slots: Dict[str, List[TwSlot]] = {}
    for f in features:
        fslots = []
        for ci, owner in enumerate(table_owner[f.table_name]):
            s = TwSlot(feature=f, owner=owner, slot_index=next_slot[owner],
                       out_offset=ci * dim, out_feature=f.name)
            next_slot[owner] += 1
            slots.append(s)
            fslots.append(s)
        feature_slots[f.name] = fslots

    f_max = max(1, max(next_slot.values()))
    r_stack = max(
        1, max(sum(r for (_, _, r, _) in v) for v in stack_assignment.values())
    )
    r_stack = -(-r_stack // row_align) * row_align
    row_offset = np.full((world_size, f_max), r_stack, dtype=np.int32)
    for s in slots:
        row_offset[s.owner, s.slot_index] = placed[
            (s.feature.table_name, s.out_offset // dim)]
    return TwGroupLayout(
        name=name, world_size=world_size, batch_size=batch_size, dim=dim,
        cap=cap, f_max=f_max, r_stack=r_stack, slots=slots,
        row_offset=row_offset, stack_assignment=stack_assignment,
        feature_slots=feature_slots, feature_order=[f.name for f in features],
        qcomms=qcomms,
    )


def tw_params_from_tables(
    layout: TwGroupLayout,
    table_weights: Mapping[str, WeightLike],  # table -> [R, full dim]
    dtype: torch.dtype = torch.float32,
    device=None,
    rank: Optional[int] = None,
) -> torch.Tensor:
    """Copy full per-table weights into the group's stacks, cast to
    ``dtype`` (padding rows zero; a column shard takes its columns):
    rank ``rank``'s ``[r_stack, dim]``, or with ``rank=None`` every
    rank's, ``[N * r_stack, dim]``.  Inverse of
    :func:`tw_tables_from_params`."""
    L = layout.r_stack
    ranks = range(layout.world_size) if rank is None else [rank]
    out = torch.zeros((len(ranks) * L, layout.dim), dtype=dtype,
                      device=device)
    for i, owner in enumerate(ranks):
        for tname, off, rows, col_off in layout.stack_assignment[owner]:
            w = torch.as_tensor(table_weights[tname])
            out[i * L + off: i * L + off + rows] = (
                w[:, col_off: col_off + layout.dim].to(out.device))
    return out


def tw_tables_from_params(
    layout: TwGroupLayout,
    params: torch.Tensor,  # [N * r_stack, dim]: every rank's stack
) -> Dict[str, torch.Tensor]:
    """The stacks back as full per-table weights: views of ``params`` for
    whole tables, the column shards concatenated for split ones."""
    L = layout.r_stack
    pieces: Dict[str, List[Tuple[int, torch.Tensor]]] = {}
    for owner, entries in layout.stack_assignment.items():
        for tname, off, rows, col_off in entries:
            pieces.setdefault(tname, []).append(
                (col_off, params[owner * L + off: owner * L + off + rows]))
    return {t: p[0][1] if len(p) == 1
            else torch.cat([v for _, v in sorted(p, key=lambda x: x[0])],
                           dim=1)
            for t, p in pieces.items()}


def tw_slot_stream(
    layout: TwGroupLayout,
    kjt: KeyedJaggedTensor,
    env: Optional[ShardingEnv] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The owner's slots after the input dist: (ids ``[N*F*C]`` int32 into
    this rank's stack, weights ``[N*F*C]`` float32, lengths ``[N*F*B]``
    int32), each ``(src, slot)`` region front-packed in example order."""
    N, B, C, F = layout.world_size, layout.batch_size, layout.cap, layout.f_max
    dev = kjt.values().device
    env = resolve_env(env, N, dev)
    jts = kjt.to_dict()
    ids_send = torch.zeros((N, F, C), dtype=torch.int32, device=dev)
    w_send = torch.zeros((N, F, C), dtype=torch.float32, device=dev)
    len_send = torch.zeros((N, F, B), dtype=torch.int32, device=dev)
    for s in layout.slots:
        jt = jts[s.feature.name]
        seg = per_slot_segments(jt.lengths(), s.feature.cap)
        n = s.feature.cap
        ids_send[s.owner, s.slot_index, :n] = jt.values().to(torch.int32)
        w_send[s.owner, s.slot_index, :n] = source_weights(
            jt.weights_or_none(), seg, jt.lengths(), s.feature.pooling)
        len_send[s.owner, s.slot_index] = jt.lengths()
    tag = f"{layout.name}:id_dist"
    ids_recv = all_to_all(ids_send, env, tag)  # [N_src, F, C]
    w_recv = all_to_all(w_send, env, tag)
    len_recv = all_to_all(len_send, env, tag)
    row_off = torch.as_tensor(layout.row_offset[env.rank], device=dev)
    ids_local = ids_recv + row_off[None, :, None]
    return ids_local.reshape(-1), w_recv.reshape(-1), len_recv.reshape(-1)


def tw_regions(layout: TwGroupLayout, lengths: torch.Tensor) -> SlotRegions:
    """The ``[N, F, C]`` slots as ``N * F`` regions of cap ``C`` and ``B``
    examples each, region ``(src, slot)`` at ``(src * F + slot) * C``:
    example ``(src, slot, b)`` is row ``(src * F + slot) * B + b`` of the
    lookup's output."""
    k = layout.world_size * layout.f_max
    C = layout.cap
    return SlotRegions(lengths, tuple(i * C for i in range(k)), (C,) * k,
                       (layout.batch_size,) * k)


def tw_segments(layout: TwGroupLayout,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Each slot's segment ``(src * F + slot) * B + b`` (``N*F*B`` for
    padding), int64 ``[N*F*C]``: the segments of :func:`tw_regions`, in
    one batched search; and the segment count ``N*F*B``."""
    N, B, C, F = layout.world_size, layout.batch_size, layout.cap, layout.f_max
    seg_b = per_slot_segments(lengths.view(N * F, B), C)  # example or B
    region = torch.arange(N * F, device=lengths.device)[:, None]
    num_segments = N * F * B
    segs = torch.where(seg_b < B, region * B + seg_b, num_segments)
    return segs.reshape(-1), num_segments


def tw_forward_local(
    layout: TwGroupLayout,
    stack_local: torch.Tensor,  # [r_stack, dim]
    kjt: KeyedJaggedTensor,
    lookup_kernel: str = "tbe",
    env: Optional[ShardingEnv] = None,
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Input dist -> lookup -> output dist for one group.  Returns
    ({feature: [B, total dim]} pooled embeddings of this rank's examples
    in the table's dtype, ctx: the received ids and weights, their
    segments and regions).  ``lookup_kernel``:
    ``"tbe"`` (over the slots' regions,
    ``ops/embedding_ops.py::pooled_embedding_lookup_regions``) or
    ``"dedup"`` (``pooled_embedding_lookup``).  The segments are built
    for the backward either way."""
    ids_flat, w_flat, lengths = tw_slot_stream(layout, kjt, env)
    segs, num_segments = tw_segments(layout, lengths)
    regions = tw_regions(layout, lengths)
    if lookup_kernel == "tbe":
        pooled = pooled_embedding_lookup_regions(stack_local, ids_flat,
                                                 regions, w_flat)
    else:
        pooled = pooled_embedding_lookup(stack_local, ids_flat, segs,
                                         num_segments, w_flat,
                                         kernel=lookup_kernel)
    return (tw_output_features(layout, pooled, env),
            (ids_flat, w_flat, segs, regions))


def tw_output_features(
    layout: TwGroupLayout,
    pooled: torch.Tensor,  # [N*F*B, dim], rows (src, slot, b)
    env: Optional[ShardingEnv] = None,
) -> Dict[str, torch.Tensor]:
    """Output dist of the owner's pooled lookup: the ``[N, F, B, dim]``
    blocks back to their examples' ranks, then {feature: [B, total
    dim]}, a feature's column shards concatenated in column order."""
    N, B, F = layout.world_size, layout.batch_size, layout.f_max
    env = resolve_env(env, N, pooled.device)
    out_recv = qcomm_all_to_all(pooled.view(N, F, B, layout.dim), env,
                                layout.qcomms, "fwd",
                                tag=f"{layout.name}:out_dist")
    out: Dict[str, torch.Tensor] = {}
    for fname in layout.feature_order:
        pieces = [out_recv[s.owner, s.slot_index]
                  for s in layout.feature_slots[fname]]
        out[fname] = pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                                  dim=-1)
    return out


def tw_backward_local(
    layout: TwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],  # feature -> [B, total dim]
    env: Optional[ShardingEnv] = None,
) -> SparseSegGrad:
    """Reverse dist: each slot's block of the gradient goes to the slot's
    owner.  Returns the segment-level sparse gradient against this rank's
    stack, for ``apply_sparse_update_segments``."""
    N, B, F = layout.world_size, layout.batch_size, layout.f_max
    ids_flat, w_flat, segs = ctx[:3]
    env = resolve_env(env, N, w_flat.device)
    g_send = torch.zeros((N, F, B, layout.dim), dtype=torch.float32,
                         device=w_flat.device)
    for fname in layout.feature_order:
        for s in layout.feature_slots[fname]:
            g_send[s.owner, s.slot_index] = grad_out[fname][
                :, s.out_offset: s.out_offset + layout.dim]
    g_recv = qcomm_all_to_all(g_send, env, layout.qcomms, "bwd",
                              tag=f"{layout.name}:bwd_dist")
    g_flat = g_recv.view(N * F * B, layout.dim)  # rows (src, slot, b)
    valid = (segs < N * F * B) & (w_flat != 0)
    return SparseSegGrad(ids_flat, valid, segs, w_flat, g_flat)


def tw_sequence_forward_local(
    layout: TwGroupLayout,
    stack_local: torch.Tensor,  # [r_stack, dim]
    kjt: KeyedJaggedTensor,
    env: Optional[ShardingEnv] = None,
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Unpooled (per-id) variant: the input dist of the pooled path (ids
    and a validity mask, ``[N, F, C]``), a row gather of the received ids
    (padding rows zero), and an all-to-all of the ``[N, F, C, dim]`` rows
    back to their sources, each collective in the ledger untagged, as in
    the JAX package.  Returns ({feature: [cap_f, total dim]} in the
    stack's dtype, a feature's column shards concatenated; ctx: the
    received ids and mask)."""
    N, B, C, F = layout.world_size, layout.batch_size, layout.cap, layout.f_max
    dev = kjt.values().device
    env = resolve_env(env, N, dev)
    jts = kjt.to_dict()
    ids_send = torch.zeros((N, F, C), dtype=torch.int32, device=dev)
    valid_send = torch.zeros((N, F, C), dtype=torch.bool, device=dev)
    for s in layout.slots:
        jt = jts[s.feature.name]
        seg = per_slot_segments(jt.lengths(), s.feature.cap)
        n = s.feature.cap
        ids_send[s.owner, s.slot_index, :n] = jt.values().to(torch.int32)
        valid_send[s.owner, s.slot_index, :n] = seg < B
    ids_recv = all_to_all(ids_send, env)  # [N_src, F, C]
    valid_recv = all_to_all(valid_send, env)
    row_off = torch.as_tensor(layout.row_offset[env.rank], device=dev)
    ids_local = (ids_recv + row_off[None, :, None]).reshape(-1)
    rows = sequence_embedding_lookup(stack_local, ids_local,
                                     valid_recv.reshape(-1))
    out_recv = all_to_all(rows.view(N, F, C, layout.dim), env)
    out: Dict[str, torch.Tensor] = {}
    for fname in layout.feature_order:
        slots = layout.feature_slots[fname]
        cap_f = slots[0].feature.cap
        pieces = [out_recv[s.owner, s.slot_index, :cap_f] for s in slots]
        out[fname] = pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                                  dim=-1)
    return out, (ids_recv, valid_recv)


def tw_sequence_backward_local(
    layout: TwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],  # feature -> [cap_f, total dim]
    env: Optional[ShardingEnv] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse of the sequence output dist: each id's gradient row back to
    its owner.  Returns (ids ``[N*F*C]`` into this rank's stack, their
    validity, float32 per-id gradients ``[N*F*C, dim]``, zero on padding)."""
    N, C, F = layout.world_size, layout.cap, layout.f_max
    ids_recv, valid_recv = ctx
    dev = valid_recv.device
    env = resolve_env(env, N, dev)
    g_send = torch.zeros((N, F, C, layout.dim), dtype=torch.float32,
                         device=dev)
    for fname in layout.feature_order:
        g = grad_out[fname]
        for s in layout.feature_slots[fname]:
            g_send[s.owner, s.slot_index, :s.feature.cap] = g[
                :, s.out_offset: s.out_offset + layout.dim]
    g_recv = all_to_all(g_send, env)
    row_off = torch.as_tensor(layout.row_offset[env.rank], device=dev)
    ids_local = (ids_recv + row_off[None, :, None]).reshape(-1)
    valid = valid_recv.reshape(-1)
    row_grads = torch.where(valid[:, None],
                            g_recv.view(-1, layout.dim), 0.0)
    return ids_local, valid, row_grads
