"""Two-level (ICI/DCN) sparse dists for the pooled path (the port of
``torchrec_tpu/parallel/sharding/hier.py``).

On a world of ``S`` slices of ``L`` ranks (``comm.ShardingEnv`` with
``num_slices``; global rank ``slice * L + local``) the flat row-wise and
block-shard dists ship every id and every returned row across the whole
world, so most of their payload crosses a slice boundary.  The two-level
dist splits both into legs by link class:

1. a slice-local id all-to-all over the ICI group, keyed by the
   destination's local rank: afterwards rank ``(s, l)`` holds every id its
   slice wants from local rank ``l`` of any slice;
2. a slice-level dedup there: each distinct (destination slice, stack row)
   gets one slot, so a row crosses the DCN once per requesting slice;
3. one cross-slice exchange over the DCN group: int32 distinct rows out,
   the owner's rows back through the qcomm codecs (int8 row-wise where
   the layout's ``qcomms`` asks; the ICI legs stay float32);
4. the rows copied back to each stage-1 slot, returned over ICI, and
   pooled at the source by the per-id lookup (B1) over the KJT's own key
   regions, each slot reading its row with its own weight: the flat
   dedup'd dist's pooling (``rw.rw_dedup_forward_local``) over the same
   row copies in the same slot order, so an unquantized two-level RW
   forward is bitwise that dist's, itself bitwise the unsharded
   collection's.

The backward mirrors it: each slot's gradient summed onto its stage-1
slot at the source, sent over ICI, summed again per distinct (slice, row)
at the aggregator, and sent over the DCN once per row at the backward
wire precision to the owner, whose fused update takes them as per-id
gradients.  Both sums are B1's sorted entry (a stable sort by slot, then
each slot's rows in order): deterministic, no float atomics.

Every sort is two stable sorts, by the minor key then the major one, the
JAX package's order, so the send slots are its own (``common.
bucket_slots``, which the flat dedup'd dist shares).  Distinct rows past a
capacity (``send_cap`` a (destination, group) at stage 1, ``hier_cap`` a
destination slice at stage 2) are dropped and counted in the ctx's
overflow, which ``dedup_overflow`` reports.  RW and TWRW/GRID differ only
in how an id gives its (destination rank, destination stack row), so both
wrappers feed one exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from torchrec_tpu_torch.ops.embedding_ops import (
    SlotRegions,
    pooled_embedding_lookup,
    pooled_embedding_lookup_regions,
    sequence_embedding_lookup,
)
from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.qcomm import qcomm_all_to_all
from torchrec_tpu_torch.parallel.sharding.common import (
    all_to_all,
    bucket_slots,
    per_slot_segments,
    source_weights,
)


@dataclasses.dataclass(frozen=True)
class HierTopology:
    """The two-level world a layout's dists run over: ``num_slices``
    slices of ``ici_size`` ranks, global rank ``slice * ici_size +
    local`` (dcn-major, as ``comm.ShardingEnv`` numbers a two-level
    world)."""

    num_slices: int
    ici_size: int

    @property
    def world_size(self) -> int:
        return self.num_slices * self.ici_size


def hier_cap_for(ici_size: int, num_groups: int, send_cap: int,
                 l_stack: int, factor: float = 1.0) -> int:
    """The distinct-row capacity a destination slice has in the DCN
    exchange: the aggregator receives at most ``ici_size * num_groups *
    send_cap`` slots for one slice and a rank holds ``l_stack`` rows, so
    the exact bound is their minimum; ``factor`` shrinks the buffer by the
    expected duplication (rows past it are dropped and counted)."""
    exact = min(ici_size * num_groups * send_cap, l_stack)
    sized = int(-(-ici_size * num_groups * send_cap // max(1.0, factor)))
    return max(1, min(exact, sized))


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[n, D]`` and one zero row after it: the row a sentinel
    index ``n`` reads."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def hier_exchange_forward(
    topo: HierTopology,
    stack_local: torch.Tensor,  # [l_stack, dim]
    rows: torch.Tensor,  # [T] destination-local stack rows
    dest: torch.Tensor,  # [T] destination global rank; world_size: not sent
    gidx: torch.Tensor,  # [T] group (feature or slot) index
    num_groups: int,
    send_cap: int,
    hier_cap: int,
    unique: bool,
    qcomms,
    name: str,
    env: ShardingEnv,
) -> Tuple[torch.Tensor, Tuple]:
    """The two-level exchange (module docstring).  Returns (the stage-1
    slots' rows back at the source, ``[M + 1, dim]`` with a zero last row,
    each element reading row ``sidx``; ctx: the requests this rank served
    and their mask, ``(sidx, sidx2)``, and the overflow count)."""
    S, L = topo.num_slices, topo.ici_size
    G, C1, Cu2 = num_groups, send_cap, hier_cap
    l_stack, dim = stack_local.shape
    ici, dcn = env.ici_env, env.dcn_env
    dest = dest.to(torch.int64)
    bucket1 = torch.where(dest < topo.world_size,
                          ((dest % L) * S + dest // L) * G + gidx,
                          L * S * G)
    sidx, ids_send, overflow1 = bucket_slots(bucket1, rows.to(torch.int32),
                                             L * S * G, C1, unique, l_stack)
    # [L_src, S_dest, G, C1]: everything bound for this local rank
    ids_ici = all_to_all(ids_send.view(L, S, G, C1), ici, f"{name}:id_dist")
    flat = ids_ici.reshape(-1)
    M = L * S * G * C1
    s_of = torch.arange(S, device=flat.device).view(1, S, 1, 1).expand(
        L, S, G, C1).reshape(-1)
    bucket2 = torch.where(flat < l_stack, s_of, S)
    sidx2, ids2_send, overflow2 = bucket_slots(bucket2, flat, S, Cu2, True,
                                               l_stack)
    # [S_src, Cu2]: the distinct rows each slice asks this rank for
    ids2 = all_to_all(ids2_send.view(S, Cu2), dcn, f"{name}:id_dist")
    valid_own = ids2 < l_stack
    rows_own = sequence_embedding_lookup(stack_local, ids2.reshape(-1),
                                         valid_own.reshape(-1))
    emb2 = qcomm_all_to_all(rows_own.view(S, Cu2, dim), dcn, qcomms, "fwd",
                            tag=f"{name}:out_dist")
    # copies only from here: each stage-1 slot its row, back over ICI
    e1 = _with_zero_row(emb2.reshape(S * Cu2, dim))[sidx2.to(torch.int64)]
    emb1 = all_to_all(e1.view(L, S, G, C1, dim), ici, f"{name}:out_dist")
    ctx = (ids2, valid_own, (sidx, sidx2), None, None,
           overflow1 + overflow2)
    return _with_zero_row(emb1.reshape(M, dim)), ctx


def hier_exchange_backward(
    topo: HierTopology,
    ctx: Tuple,
    g_cat: torch.Tensor,  # [num_segments, dim] the pooled gradients
    num_groups: int,
    send_cap: int,
    hier_cap: int,
    dim: int,
    qcomms,
    name: str,
    env: ShardingEnv,
) -> SparseSegGrad:
    """The exchange reversed: each element's gradient (its example's
    times its weight) summed onto its stage-1 slot at the source, the
    slots over ICI, summed per distinct (slice, row) at the aggregator,
    then over the DCN at the backward wire precision; the owner's per-id
    gradients (:meth:`SparseSegGrad.from_row_grads`).  Both sums are B1's
    sorted entry, in slot order."""
    S, L = topo.num_slices, topo.ici_size
    G, C1, Cu2 = num_groups, send_cap, hier_cap
    ids2, valid_own, (sidx, sidx2), seg_global, w_all, _ = ctx
    M = L * S * G * C1
    g1 = pooled_embedding_lookup(g_cat, seg_global, sidx, M, w_all)
    g1r = all_to_all(g1.view(L, S, G, C1, dim), env.ici_env,
                     f"{name}:bwd_dist")
    slots = torch.arange(M, dtype=torch.int32, device=g1r.device)
    g2 = pooled_embedding_lookup(g1r.reshape(M, dim), slots, sidx2,
                                 S * Cu2)
    g_own = qcomm_all_to_all(g2.view(S, Cu2, dim), env.dcn_env, qcomms,
                             "bwd", tag=f"{name}:bwd_dist")
    return SparseSegGrad.from_row_grads(
        ids2.reshape(-1), valid_own.reshape(-1), g_own.reshape(S * Cu2, dim))


# ---------------------------------------------------------------------------
# the RW and TWRW/GRID element streams and wrappers
# ---------------------------------------------------------------------------


def _rw_element_stream(layout, kjt, drop_zero_weight: bool):
    """The concatenated per-element (rows, dest, seg_global, w, gidx) of a
    row-wise layout, and its source regions: the flat dedup'd dispatch's
    derivation (an id outside its table, and with ``drop_zero_weight`` a
    sanitizer's null slot, not sent)."""
    N, B = layout.world_size, layout.batch_size
    F = len(layout.features)
    jts = kjt.to_dict()
    rows_c, dest_c, seg_c, w_c, g_c, lens, starts = [], [], [], [], [], [], []
    start = 0
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
        rows_c.append(layout.local_offset[f.table_name] + ids % bs)
        dest_c.append(torch.where(valid, ids // bs, N))
        seg_c.append(torch.where(valid, gi * B + seg.to(torch.int64),
                                 F * B).to(torch.int32))
        w_c.append(w)
        g_c.append(torch.full(seg.shape, gi, dtype=torch.int64,
                              device=seg.device))
        lens.append(jt.lengths())
        starts.append(start)
        start += f.cap
    regions = SlotRegions(torch.cat(lens), tuple(starts),
                          tuple(f.cap for f in layout.features), (B,) * F)
    return (torch.cat(rows_c), torch.cat(dest_c), torch.cat(seg_c),
            torch.cat(w_c), torch.cat(g_c), regions)


def _twrw_element_stream(layout, kjt, drop_zero_weight: bool):
    """The per-element stream of a TWRW/GRID layout, one group a slot
    (feature x column shard): the destination is the slot's node rank
    that holds the id's block, the row pre-offset by that rank's stack
    offset for the slot."""
    N, B = layout.world_size, layout.batch_size
    G = len(layout.slots)
    jts = kjt.to_dict()
    rows_c, dest_c, seg_c, w_c, g_c, lens, starts = [], [], [], [], [], [], []
    start = 0
    for si, s in enumerate(layout.slots):
        f = s.feature
        jt = jts[f.name]
        seg = per_slot_segments(jt.lengths(), f.cap)
        w = source_weights(jt.weights_or_none(), seg, jt.lengths(),
                           f.pooling)
        ids = jt.values().to(torch.int64)
        dest = s.node_devices[0] + ids // s.block_size
        valid = ((seg < B) & (ids >= 0) & (ids < f.table_rows)
                 & (dest >= 0) & (dest < N))
        if drop_zero_weight:
            valid = valid & ((w != 0) | (ids != 0))
        doff = torch.as_tensor(layout.dest_offset[si], dtype=torch.int64,
                               device=ids.device)
        rows_c.append(doff[dest.clamp(0, N - 1)] + ids % s.block_size)
        dest_c.append(torch.where(valid, dest, N))
        seg_c.append(torch.where(valid, si * B + seg.to(torch.int64),
                                 G * B).to(torch.int32))
        w_c.append(w)
        g_c.append(torch.full(seg.shape, si, dtype=torch.int64,
                              device=seg.device))
        lens.append(jt.lengths())
        starts.append(start)
        start += f.cap
    regions = SlotRegions(torch.cat(lens), tuple(starts),
                          tuple(s.feature.cap for s in layout.slots),
                          (B,) * G)
    return (torch.cat(rows_c), torch.cat(dest_c), torch.cat(seg_c),
            torch.cat(w_c), torch.cat(g_c), regions)


def _hier_pooled_forward(layout, stream, stack_local: torch.Tensor,
                         env: ShardingEnv) -> Tuple[torch.Tensor, Tuple]:
    """The exchange, then pooling at the source: B1 over the returned
    rows at ``sidx`` with each element's weight, over the KJT's key
    regions (``[G * B, dim]``)."""
    rows, dest, seg_global, w_all, gidx, regions = stream
    emb, ctx = hier_exchange_forward(
        layout.hier, stack_local, rows, dest, gidx, layout.hier_num_groups,
        layout.hier_send_cap, layout.hier_cap, layout.dedup, layout.qcomms,
        layout.name, env)
    sidx = ctx[2][0]
    pooled = pooled_embedding_lookup_regions(emb, sidx, regions, w_all)
    return pooled, ctx[:3] + (seg_global, w_all) + ctx[5:]


def _check_env(layout, env: Optional[ShardingEnv]) -> ShardingEnv:
    topo = layout.hier
    if env is None or env.num_slices != topo.num_slices or (
            env.world_size != topo.world_size):
        raise ValueError(f"{layout.name}: a two-level layout of "
                         f"{topo.num_slices} x {topo.ici_size} ranks needs "
                         "that two-level ShardingEnv")
    return env


def rw_hier_forward_local(layout, stack_local: torch.Tensor, kjt,
                          env: Optional[ShardingEnv] = None,
                          drop_zero_weight: bool = False
                          ) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """The two-level row-wise pooled forward: ({feature: [B, dim]},
    ctx: the requests served and their mask, ``(sidx, sidx2)``,
    seg_global, the weights and the overflow count)."""
    env = _check_env(layout, env)
    B = layout.batch_size
    pooled, ctx = _hier_pooled_forward(
        layout, _rw_element_stream(layout, kjt, drop_zero_weight),
        stack_local, env)
    return {f.name: pooled[i * B:(i + 1) * B]
            for i, f in enumerate(layout.features)}, ctx


def twrw_hier_forward_local(layout, stack_local: torch.Tensor, kjt,
                            env: Optional[ShardingEnv] = None,
                            drop_zero_weight: bool = False
                            ) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """The two-level TWRW/GRID pooled forward: the source pools each
    slot itself (it holds every row of its ids after the exchange), where
    the flat path reduce-scatters node partials; a feature's column
    shards are concatenated."""
    env = _check_env(layout, env)
    B = layout.batch_size
    pooled, ctx = _hier_pooled_forward(
        layout, _twrw_element_stream(layout, kjt, drop_zero_weight),
        stack_local, env)
    index = {id(s): i for i, s in enumerate(layout.slots)}
    out: Dict[str, torch.Tensor] = {}
    for fname in layout.feature_order:
        pieces = [pooled[index[id(s)] * B:(index[id(s)] + 1) * B]
                  for s in layout.feature_slots[fname]]
        out[fname] = pieces[0] if len(pieces) == 1 else torch.cat(pieces, -1)
    return out, ctx


def _hier_pooled_backward(layout, ctx, g_cat: torch.Tensor,
                          env: ShardingEnv) -> SparseSegGrad:
    return hier_exchange_backward(
        layout.hier, ctx, g_cat, layout.hier_num_groups,
        layout.hier_send_cap, layout.hier_cap, layout.dim, layout.qcomms,
        layout.name, env)


def rw_hier_backward_local(layout, ctx, grad_out, env=None
                           ) -> SparseSegGrad:
    """The two-level row-wise backward: the sparse gradient against this
    rank's stack."""
    env = _check_env(layout, env)
    g_cat = torch.cat([grad_out[f.name].to(torch.float32)
                       for f in layout.features])  # [F * B, dim]
    return _hier_pooled_backward(layout, ctx, g_cat, env)


def twrw_hier_backward_local(layout, ctx, grad_out, env=None
                             ) -> SparseSegGrad:
    """The two-level TWRW/GRID backward: each slot's gradient read off its
    feature's columns, then the exchange reversed."""
    env = _check_env(layout, env)
    dim = layout.dim
    g_cat = torch.cat([
        grad_out[s.feature.name][:, s.out_offset:s.out_offset + dim].to(
            torch.float32)
        for s in layout.slots])  # [G * B, dim]
    return _hier_pooled_backward(layout, ctx, g_cat, env)
