"""Row-wise sharded execution (a subset of
``torchrec_tpu/parallel/sharding/rw.py``).

Every table of a group is split into ``N`` blocks of ``ceil(rows / N)``
rows, block ``d`` on rank ``d``, and the blocks of one rank are stacked
into one array.  Each rank runs

  input dist : :func:`~.common.moe_dispatch_batched` buckets its ids by
               owner (a stable sort) into ``[N, F, C]`` ids (local rows),
               example ids and per-id weights, sent by all-to-all;
  lookup     : the per-id lookup (``"tbe"``, B1) over its stack reads the
               received ``[N_src, F, C]`` buckets as ``F * N`` regions in
               (feature, source) order with no sort: the stable sort kept
               each (source, feature) bucket in example order, so each
               example's ids are a run of its bucket, and its length is a
               count of its example id in that bucket; the ragged dedup
               lookup (``"dedup"``, B4) takes the same slots with their
               segments (:func:`block_segments`);
  output dist: a reduce-scatter of the partial sums (``qcomm_psum_scatter``,
               a sum over sources in rank order) to the examples' ranks;

and the backward all-gathers the pooled gradients to every owner and hands
its slots to the fused update as a :class:`SparseSegGrad`.  Example
``(feature, src, b)`` is segment ``feature * (N * B) + src * B + b``, the
JAX package's order.  An id outside its table is dropped at the source.

The sequence (unpooled) variants, :func:`rw_sequence_forward_local` and
:func:`rw_sequence_backward_local`, serve the sharded
``EmbeddingCollection``: the same bucketing with each id's source
position riding along, a row gather at the owner, and an all-to-all of
the rows back, scattered to their positions.  A layout's ``qcomms``
(``parallel/qcomm.py``) sets the wire precision of the pooled
reduce-scatter and its backward all-gather; ``row_align`` rounds each
rank's stack up to a multiple (the FULLY_SHARDED 2D strategy splits it
over the replicas).

The dedup'd input dist (a layout built with ``dedup=True``;
:func:`rw_dedup_forward_local`, :func:`rw_dedup_backward_local`) ships
each distinct (feature, destination, id) once: the source sorts its
slots by (destination bucket, local row) with two stable sorts and sends
``[N, F, dedup_cap]`` distinct rows; the owner gathers those rows and
sends them back; the source pools its own slots over the returned rows
with the per-id lookup (B1) over the KJT's own key regions, so each
example's sum is the unsharded collection's slot-order sum of the same
rows.  The backward sums each distinct id's slot gradients at the
source before the wire, with the same kernel over the pooled gradients
(its sorted entry: a stable sort by send slot, then each slot's
gradients in slot order, no atomics), and the owner's update takes them
as per-id gradients (:meth:`SparseSegGrad.from_row_grads`).

A layout built with ``hier`` (a ``sharding.hier.HierTopology``) runs the
two-level ICI/DCN dist of ``sharding/hier.py`` instead, its distinct-row
DCN capacity ``hier_cap`` sized by ``hier_factor``
(:func:`~torchrec_tpu_torch.parallel.sharding.hier.hier_cap_for`);
:meth:`RwGroupLayout.id_wire_bytes` counts either dist's id payload.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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
from torchrec_tpu_torch.parallel.qcomm import (
    QCommsConfig,
    qcomm_all_gather,
    qcomm_all_to_all,
    qcomm_psum_scatter,
)
from torchrec_tpu_torch.parallel.sharding.common import (
    FeatureSpec,
    all_to_all,
    bucket_slots,
    moe_dispatch_batched,
    per_slot_segments,
    source_weights,
)
from torchrec_tpu_torch.parallel.sharding.tw import WeightLike
from torchrec_tpu_torch.sparse import KeyedJaggedTensor


@dataclasses.dataclass
class RwGroupLayout:
    """Static layout of one (ROW_WISE, dim) group."""

    name: str
    world_size: int
    batch_size: int
    dim: int
    cap: int  # uniform per-(feature, dest) capacity: the largest feature cap
    features: List[FeatureSpec]
    # per table: rows a rank holds, and their offset in the rank's stack
    block_size: Dict[str, int]
    local_offset: Dict[str, int]
    l_stack: int  # rows of a rank's stack
    qcomms: Optional[QCommsConfig] = None  # wire precision of the dists
    # the dedup'd input dist: distinct ids per (feature, destination) a
    # source ships, and the duplication factor that capacity was sized by
    dedup: bool = False
    dedup_cap: int = 0
    dedup_factor: float = 1.0
    # the two-level ICI/DCN dist (sharding/hier.py): its topology, the
    # distinct-row DCN capacity a destination slice has, and the factor
    # that capacity was sized by
    hier: object = None  # Optional[hier.HierTopology]
    hier_cap: int = 0
    hier_factor: float = 1.0

    @property
    def hier_send_cap(self) -> int:
        """The two-level dist's stage-1 capacity a (destination, feature):
        the distinct-id capacity when the source dedups, else the feature
        cap."""
        return self.dedup_cap if self.dedup else self.cap

    @property
    def hier_num_groups(self) -> int:
        return len(self.features)

    def id_wire_bytes(self) -> int:
        """A rank's id-dist payload a step, sized by the caps: plain RW
        ships three ``[N, F, cap]`` arrays (int32 ids, int32 example ids,
        float32 weights: 12 bytes a slot), the dedup'd dist one int32
        ``[N, F, dedup_cap]`` array, the two-level dist its stage-1 int32
        buffer over ICI plus the ``[S, hier_cap]`` int32 DCN request."""
        N, F = self.world_size, len(self.features)
        if self.hier is not None:
            return (N * F * self.hier_send_cap * 4
                    + self.hier.num_slices * self.hier_cap * 4)
        if self.dedup:
            return N * F * self.dedup_cap * 4
        return N * F * self.cap * 12


def dedup_cap_for(features: Sequence[FeatureSpec],
                  caps_by_feature: Mapping[str, int],
                  block_size: Mapping[str, int], dedup_factor: float) -> int:
    """The dedup'd dist's distinct-id capacity for a cap assignment:
    ``ceil(max cap / factor)``, at most the largest ``min(feature cap,
    block rows)`` (the distinct ids one (feature, destination) can hold),
    at least 1."""
    cap = max(caps_by_feature[f.name] for f in features)
    exact = max(min(caps_by_feature[f.name], block_size[f.table_name])
                for f in features)
    factor_cap = int(np.ceil(cap / max(1.0, dedup_factor)))
    return max(1, min(exact, factor_cap))


def build_rw_layout(
    name: str,
    features: Sequence[FeatureSpec],
    world_size: int,
    batch_size: int,
    qcomms: Optional[QCommsConfig] = None,
    row_align: int = 1,
    dedup: bool = False,
    dedup_factor: float = 1.0,
    hier=None,
    hier_factor: float = 1.0,
) -> RwGroupLayout:
    """Row-wise group layout: each table block-split over the ranks, the
    blocks of a rank stacked in table order (the stack rounded up to a
    multiple of ``row_align``).  ``dedup`` compiles the dedup'd input
    dist, its distinct-id capacity per (feature, destination)
    ``ceil(cap / dedup_factor)`` and never above the exactness bound,
    the largest ``min(feature cap, block rows)``: factor 1 never drops
    an id.  ``hier`` (a ``hier.HierTopology`` of ``world_size`` ranks)
    compiles the two-level dist, ``hier_factor`` sizing its distinct-row
    capacity the same way (1: exact)."""
    dim = features[0].dim
    if any(f.dim != dim for f in features):
        raise ValueError(f"group {name}: features of different dims")
    block_size: Dict[str, int] = {}
    local_offset: Dict[str, int] = {}
    off = 0
    for f in features:
        if f.table_name in block_size:
            continue
        bs = -(-f.table_rows // world_size)
        block_size[f.table_name] = bs
        local_offset[f.table_name] = off
        off += bs
    l_stack = -(-max(1, off) // row_align) * row_align
    cap = max(f.cap for f in features)
    dedup_cap = (dedup_cap_for(features, {f.name: f.cap for f in features},
                               block_size, dedup_factor) if dedup else 0)
    hier_cap = 0
    if hier is not None:
        from torchrec_tpu_torch.parallel.sharding.hier import hier_cap_for

        if hier.world_size != world_size:
            raise ValueError(f"{name}: a {hier.num_slices} x "
                             f"{hier.ici_size} topology for {world_size} "
                             "ranks")
        hier_cap = hier_cap_for(hier.ici_size, len(features),
                                dedup_cap if dedup else cap, l_stack,
                                hier_factor)
    return RwGroupLayout(
        name=name, world_size=world_size, batch_size=batch_size, dim=dim,
        cap=cap, features=list(features),
        block_size=block_size, local_offset=local_offset,
        l_stack=l_stack, qcomms=qcomms, dedup=dedup, dedup_cap=dedup_cap,
        dedup_factor=max(1.0, float(dedup_factor)), hier=hier,
        hier_cap=hier_cap, hier_factor=max(1.0, float(hier_factor)),
    )


def _table_rows(layout) -> Dict[str, int]:
    return {f.table_name: f.table_rows for f in layout.features}


def rw_params_from_tables(
    layout: RwGroupLayout,
    table_weights: Mapping[str, WeightLike],
    dtype: torch.dtype = torch.float32,
    device=None,
    rank: Optional[int] = None,
) -> torch.Tensor:
    """Rank ``rank``'s stack ``[l_stack, dim]`` (every rank's, ``[N *
    l_stack, dim]``, with ``rank=None``): table ``t``'s row ``r`` is row
    ``local_offset[t] + r % block`` of rank ``r // block``."""
    L = layout.l_stack
    ranks = range(layout.world_size) if rank is None else [rank]
    out = torch.zeros((len(ranks) * L, layout.dim), dtype=dtype,
                      device=device)
    for tname, bs in layout.block_size.items():
        w = torch.as_tensor(table_weights[tname])
        lo = layout.local_offset[tname]
        for i, d in enumerate(ranks):
            rows = w[d * bs: (d + 1) * bs]
            out[i * L + lo: i * L + lo + rows.shape[0]] = rows.to(out.device)
    return out


def rw_tables_from_params(
    layout: RwGroupLayout, params: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`rw_params_from_tables` over every rank's stack
    ``[N * l_stack, dim]``."""
    N, L = layout.world_size, layout.l_stack
    out = {}
    for tname, R in _table_rows(layout).items():
        bs, lo = layout.block_size[tname], layout.local_offset[tname]
        out[tname] = torch.cat([
            params[d * L + lo: d * L + lo + min(bs, R - d * bs)]
            for d in range(N) if R - d * bs > 0])
    return out


def block_dispatch(
    layout,
    entries: Sequence[Tuple[FeatureSpec, torch.Tensor, torch.Tensor]],
    kjt: KeyedJaggedTensor,
    env: ShardingEnv,
    fill_id: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The input dist of a block-split group (RW, TWRW): ``entries`` is
    one ``(feature, dest rank, local row)`` per bucket group, the last two
    per id of the feature's KJT slots.  Buckets every group's valid ids by
    destination with one sort, then sends them.  Returns the received
    ``[N_src, G, C]`` local rows, example ids (``B`` for padding) and
    float32 weights."""
    N, B, C = layout.world_size, layout.batch_size, layout.cap
    jts = kjt.to_dict()
    ids_c, seg_c, w_c, dest_c, valid_c = [], [], [], [], []
    for f, dest, local in entries:
        jt = jts[f.name]
        seg = per_slot_segments(jt.lengths(), f.cap)
        ids = jt.values()
        ids_c.append(local.to(torch.int32))
        dest_c.append(dest)
        seg_c.append(seg.to(torch.int32))
        w_c.append(source_weights(jt.weights_or_none(), seg, jt.lengths(),
                                  f.pooling))
        valid_c.append((seg < B) & (ids >= 0) & (ids < f.table_rows))
    ids_send, b_send, w_send = moe_dispatch_batched(
        ids_c, (seg_c, w_c), dest_c, valid_c, N, C,
        fill_values=(fill_id, B, 0.0))
    tag = f"{layout.name}:id_dist"
    return (all_to_all(ids_send, env, tag), all_to_all(b_send, env, tag),
            all_to_all(w_send, env, tag))


def block_regions(layout, b_recv: torch.Tensor) -> SlotRegions:
    """The received ``[N, G, C]`` buckets as ``G * N`` regions in (group,
    source) order, region ``(g, src)`` at ``(src * G + g) * C`` with
    ``B`` examples: each example's length is the count of its example id
    in its bucket (a scatter-add, no host sync), and example ``(g, src,
    b)`` is row ``g * (N * B) + src * B + b`` of the lookup's output."""
    N, G, C = b_recv.shape
    B = layout.batch_size
    g = torch.arange(G, device=b_recv.device)[None, :, None]
    src = torch.arange(N, device=b_recv.device)[:, None, None]
    key = ((g * N + src) * (B + 1) + b_recv).reshape(-1)  # b == B: padding
    counts = torch.zeros(G * N * (B + 1), dtype=torch.int32,
                         device=b_recv.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    lengths = counts.view(G * N, B + 1)[:, :B].reshape(-1)
    order = [src_ * G + g_ for g_ in range(G) for src_ in range(N)]
    return SlotRegions(lengths, tuple(k * C for k in order), (C,) * (G * N),
                       (B,) * (G * N))


def block_segments(layout, b_recv: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Each received slot's segment ``g * (N * B) + src * B + b``
    (``G * N * B`` for padding), int64 ``[N * G * C]``, and the segment
    count."""
    N, G, _ = b_recv.shape
    B = layout.batch_size
    g = torch.arange(G, device=b_recv.device)[None, :, None]
    src = torch.arange(N, device=b_recv.device)[:, None, None]
    num_segments = G * N * B
    segs = torch.where(b_recv < B, g * (N * B) + src * B + b_recv,
                       num_segments)
    return segs.reshape(-1).to(torch.int64), num_segments


def block_lookup(layout, stack_local, ids_recv, b_recv, w_recv, env,
                 lookup_kernel: str = "tbe"):
    """The owner's lookup of a block-split group and its reduce-scatter:
    (``[G, B, dim]`` pooled sums of this rank's examples, ctx: the
    received ids and weights, their segments and regions).
    ``lookup_kernel``: ``"tbe"`` (B1 over the regions) or ``"dedup"``
    (B4 over the segments); both sum each example in slot order."""
    N, G, _ = b_recv.shape
    B = layout.batch_size
    ids_flat, w_flat = ids_recv.reshape(-1), w_recv.reshape(-1)
    regions = block_regions(layout, b_recv)
    segs, num_segments = block_segments(layout, b_recv)
    if lookup_kernel == "tbe":
        partial = pooled_embedding_lookup_regions(stack_local, ids_flat,
                                                  regions, w_flat)
    else:
        partial = pooled_embedding_lookup(stack_local, ids_flat, segs,
                                          num_segments, w_flat,
                                          kernel=lookup_kernel)
    x = partial.view(G, N, B, layout.dim).transpose(0, 1)  # [N, G, B, dim]
    pooled = qcomm_psum_scatter(x, env, layout.qcomms, "fwd",
                                tag=f"{layout.name}:out_dist")
    return pooled, (ids_flat, w_flat, segs, regions)


def block_backward(layout, ctx, g_home: torch.Tensor,
                   env: ShardingEnv) -> SparseSegGrad:
    """Reverse of the reduce-scatter: every rank's ``[G, B, dim]``
    gradient to every owner (an all-gather), then the owner's slots
    against its stack."""
    ids_flat, w_flat, segs = ctx[:3]
    G, B, D = g_home.shape
    N = layout.world_size
    g_all = qcomm_all_gather(g_home, env, layout.qcomms, "bwd",
                             tag=f"{layout.name}:bwd_dist", fanout=N)
    g_flat = g_all.transpose(0, 1).reshape(G * N * B, D)
    valid = (segs < G * N * B) & (w_flat != 0)
    return SparseSegGrad(ids_flat, valid, segs, w_flat, g_flat)


def rw_forward_local(
    layout: RwGroupLayout,
    stack_local: torch.Tensor,  # [l_stack, dim]
    kjt: KeyedJaggedTensor,
    env: Optional[ShardingEnv] = None,
    lookup_kernel: str = "tbe",
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Bucket -> all-to-all -> partial lookup (``lookup_kernel``, see
    :func:`block_lookup`) -> reduce-scatter.  Returns ({feature: [B,
    dim]}, ctx for the backward)."""
    env = resolve_env(env, layout.world_size, stack_local.device)
    jts = kjt.to_dict()
    entries = []
    for f in layout.features:
        ids = jts[f.name].values().to(torch.int64)
        bs = layout.block_size[f.table_name]
        entries.append((f, ids // bs,
                        layout.local_offset[f.table_name] + ids % bs))
    recv = block_dispatch(layout, entries, kjt, env, fill_id=0)
    pooled, ctx = block_lookup(layout, stack_local, *recv, env,
                               lookup_kernel)
    return {f.name: pooled[i] for i, f in enumerate(layout.features)}, ctx


def rw_backward_local(
    layout: RwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],
    env: Optional[ShardingEnv] = None,
) -> SparseSegGrad:
    """All-gather the gradients (the reverse of the reduce-scatter); the
    sparse gradient against this rank's stack."""
    env = resolve_env(env, layout.world_size, ctx[1].device)
    g_local = torch.stack([grad_out[f.name].to(torch.float32)
                           for f in layout.features])  # [F, B, dim]
    return block_backward(layout, ctx, g_local, env)


def rw_sequence_forward_local(
    layout: RwGroupLayout,
    stack_local: torch.Tensor,  # [l_stack, dim]
    kjt: KeyedJaggedTensor,
    env: Optional[ShardingEnv] = None,
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Unpooled row-wise: every feature's valid ids bucketed by owner with
    one sort (:func:`~.common.moe_dispatch_batched`), each id's source
    position kept here, an all-to-all of the ids, a row gather at the
    owner (padding rows zero), an all-to-all of the rows back, and each
    row written to its id's position.  Collectives untagged in the
    ledger, as in the JAX package.  Returns ({feature: [cap_f, dim]}, ctx:
    the received ids, their mask and the positions sent)."""
    N, B, C = layout.world_size, layout.batch_size, layout.cap
    F = len(layout.features)
    env = resolve_env(env, N, stack_local.device)
    jts = kjt.to_dict()
    ids_c, pos_c, dest_c, valid_c = [], [], [], []
    pos_fill = max(f.cap for f in layout.features)
    for f in layout.features:
        jt = jts[f.name]
        seg = per_slot_segments(jt.lengths(), f.cap)
        ids = jt.values().to(torch.int64)
        bs = layout.block_size[f.table_name]
        ids_c.append((layout.local_offset[f.table_name] + ids % bs)
                     .to(torch.int32))
        dest_c.append(ids // bs)
        pos_c.append(torch.arange(f.cap, dtype=torch.int32,
                                  device=ids.device))
        valid_c.append((seg < B) & (ids >= 0) & (ids < f.table_rows))
    ids_send, pos_send = moe_dispatch_batched(
        ids_c, (pos_c,), dest_c, valid_c, N, C,
        fill_values=(layout.l_stack, pos_fill))  # [N, F, C]
    ids_recv = all_to_all(ids_send, env)  # [N_src, F, C]
    valid_recv = ids_recv < layout.l_stack
    rows = sequence_embedding_lookup(stack_local, ids_recv.reshape(-1),
                                     valid_recv.reshape(-1))
    emb_back = all_to_all(rows.view(N, F, C, layout.dim), env)
    out: Dict[str, torch.Tensor] = {}
    for i, f in enumerate(layout.features):
        pos = pos_send[:, i, :].reshape(-1).to(torch.int64)
        emb = emb_back[:, i].reshape(-1, layout.dim)
        buf = emb.new_zeros((pos_fill + 1, layout.dim))
        buf[pos.clamp(max=pos_fill)] = emb  # one write a position
        out[f.name] = buf[: f.cap]
    return out, (ids_recv, valid_recv, pos_send)


def rw_sequence_backward_local(
    layout: RwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],  # feature -> [cap_f, dim]
    env: Optional[ShardingEnv] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each id's gradient row read at its source position and sent back
    along the two all-to-alls.  Returns (ids ``[N*F*C]`` into this rank's
    stack, their validity, float32 per-id gradients, zero on padding)."""
    ids_recv, valid_recv, pos_send = ctx
    env = resolve_env(env, layout.world_size, ids_recv.device)
    g_b = []
    for i, f in enumerate(layout.features):
        g = grad_out[f.name].to(torch.float32)  # [cap_f, dim]
        pos = pos_send[:, i, :].to(torch.int64)  # [N, C]
        gp = g[pos.clamp(0, f.cap - 1)]
        g_b.append(torch.where((pos < f.cap)[..., None], gp, 0.0))
    g_recv = all_to_all(torch.stack(g_b, dim=1), env)  # [N, F, C, dim]
    valid = valid_recv.reshape(-1)
    row_grads = torch.where(valid[:, None],
                            g_recv.reshape(-1, layout.dim), 0.0)
    return ids_recv.reshape(-1), valid, row_grads


def _rw_dedup_dispatch(
    layout: RwGroupLayout,
    kjt: KeyedJaggedTensor,
    drop_zero_weight: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """The source side of the dedup'd dist: one lexicographic (destination
    bucket ``dest * F + feature``, local row) order, by two stable sorts
    (the minor key, then the major one: the JAX package's order, so the
    send slots are its own), gives each distinct triple a slot of the
    ``[N, F, dedup_cap]`` id buffer.  An id outside its table is dropped
    at the source, as in the plain dist.  ``drop_zero_weight`` also drops
    the sanitizer's null slots (weight 0 and id 0) so that no remapped id
    reaches the wire or an owner's update; a user slot of weight 0 on
    another id still ships, as it does unguarded.

    Returns (ids_send ``[N, F, Cu]`` int32, fill ``l_stack``; sidx ``[T]``
    each slot's flat send index, ``N * F * Cu`` for a slot not sent;
    seg_global ``[T]`` each slot's pooled segment ``feature * B + b``,
    ``F * B`` for a slot not sent; the slots' float32 weights; overflow,
    the 0-d int32 count of distinct triples past ``dedup_cap``).  No host
    sync."""
    N, B, Cu = layout.world_size, layout.batch_size, layout.dedup_cap
    F = len(layout.features)
    jts = kjt.to_dict()
    lids_c, seg_c, w_c, d2_c = [], [], [], []
    for gi, f in enumerate(layout.features):
        jt = jts[f.name]
        seg = per_slot_segments(jt.lengths(), f.cap)
        w = source_weights(jt.weights_or_none(), seg, jt.lengths(),
                           f.pooling)
        ids = jt.values().to(torch.int64)
        bs = layout.block_size[f.table_name]
        valid = (seg < B) & (ids >= 0) & (ids < f.table_rows)
        if drop_zero_weight:
            valid = valid & ((w != 0) | (ids != 0))
        lids_c.append((layout.local_offset[f.table_name] + ids % bs)
                      .to(torch.int32))
        d2_c.append(torch.where(valid, (ids // bs) * F + gi, N * F))
        seg_c.append(torch.where(valid, gi * B + seg.to(torch.int64),
                                 F * B).to(torch.int32))
        w_c.append(w)
    sidx, ids_send, overflow = bucket_slots(
        torch.cat(d2_c), torch.cat(lids_c), N * F, Cu, True, layout.l_stack)
    return (ids_send.view(N, F, Cu), sidx, torch.cat(seg_c), torch.cat(w_c),
            overflow)


def _source_regions(layout, kjt: KeyedJaggedTensor) -> SlotRegions:
    """The group's features' KJT slots as regions, in feature order: the
    slot stream :func:`_rw_dedup_dispatch` concatenates."""
    jts = kjt.to_dict()
    lens, starts, start = [], [], 0
    for f in layout.features:
        lens.append(jts[f.name].lengths())
        starts.append(start)
        start += f.cap
    return SlotRegions(torch.cat(lens), tuple(starts),
                       tuple(f.cap for f in layout.features),
                       (layout.batch_size,) * len(layout.features))


def rw_dedup_forward_local(
    layout: RwGroupLayout,
    stack_local: torch.Tensor,  # [l_stack, dim]
    kjt: KeyedJaggedTensor,
    env: Optional[ShardingEnv] = None,
    drop_zero_weight: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Dedup dispatch -> distinct-id all-to-all -> the owner's row gather
    -> an all-to-all of the rows back (at the layout's forward wire
    precision) -> pooling at the source: the per-id lookup (B1) over the
    returned rows, one zero row appended for the slots not sent, each
    slot reading row ``sidx`` with its own weight, over the KJT's key
    regions.  The sums are the unsharded collection's, slot by slot.
    Returns ({feature: [B, dim]}, ctx: the received ids and their mask,
    sidx, seg_global, the weights and the overflow count)."""
    N, B, Cu = layout.world_size, layout.batch_size, layout.dedup_cap
    D = layout.dim
    env = resolve_env(env, N, stack_local.device)
    ids_send, sidx, seg_global, w_all, overflow = _rw_dedup_dispatch(
        layout, kjt, drop_zero_weight)
    ids_recv = all_to_all(ids_send, env, f"{layout.name}:id_dist")
    valid_recv = ids_recv < layout.l_stack
    rows = sequence_embedding_lookup(stack_local, ids_recv.reshape(-1),
                                     valid_recv.reshape(-1))
    emb_back = qcomm_all_to_all(
        rows.view(N, len(layout.features), Cu, D), env, layout.qcomms, "fwd",
        tag=f"{layout.name}:out_dist")  # the stack's dtype at float32 wires
    emb = torch.cat([emb_back.reshape(-1, D), emb_back.new_zeros((1, D))])
    pooled = pooled_embedding_lookup_regions(
        emb, sidx, _source_regions(layout, kjt), w_all)
    out = {f.name: pooled[i * B:(i + 1) * B]
           for i, f in enumerate(layout.features)}
    return out, (ids_recv, valid_recv, sidx, seg_global, w_all, overflow)


def rw_dedup_backward_local(
    layout: RwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],
    env: Optional[ShardingEnv] = None,
) -> SparseSegGrad:
    """Each slot's gradient (its example's times its weight), summed over
    a source's duplicates of each sent id before the wire (B1 over the
    pooled gradients, slot order), an all-to-all back to the owners (at
    the backward wire precision), and the owner's per-id gradients
    against its stack (:meth:`SparseSegGrad.from_row_grads`)."""
    N, Cu, D = layout.world_size, layout.dedup_cap, layout.dim
    ids_recv, valid_recv, sidx, seg_global, w_all, _ = ctx
    env = resolve_env(env, N, ids_recv.device)
    g_cat = torch.cat([grad_out[f.name].to(torch.float32)
                       for f in layout.features])  # [F * B, dim]
    sent = N * len(layout.features) * Cu
    # g_send[s] = sum of g_cat[seg_global[t]] * w_all[t] over the slots t
    # with sidx[t] == s, in slot order from zero: the per-id lookup's
    # sorted entry (B1: a stable sort by sidx, then each row's slots in
    # order, multiplies and adds rounded apart), JAX's segment_sum of the
    # row gradients bit for bit, with no atomics and no host sync
    g_send = pooled_embedding_lookup(g_cat, seg_global, sidx, sent, w_all)
    g_recv = qcomm_all_to_all(
        g_send.view(N, len(layout.features), Cu, D), env, layout.qcomms,
        "bwd", tag=f"{layout.name}:bwd_dist")
    return SparseSegGrad.from_row_grads(
        ids_recv.reshape(-1), valid_recv.reshape(-1), g_recv.reshape(sent, D))
