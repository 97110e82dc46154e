"""Shared machinery for sharded embedding execution (a subset of
``torchrec_tpu/parallel/sharding/common.py``): the (feature, table)
bindings of a group, the slot -> example map of a front-packed region and
the per-id weights computed at the source, the bucketing of ids by
destination rank (:func:`moe_dispatch`, the row-wise dists' input) and
the raw all-to-all of the input dists.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.qcomm import record_wire_bytes


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One (feature, table) binding inside a group."""

    name: str
    table_name: str
    table_rows: int
    dim: int  # output dim this feature contributes
    pooling: PoolingType
    cap: int  # static per-batch id capacity of this feature


def feature_specs_for_tables(
    configs: Sequence[EmbeddingBagConfig],
    caps: Dict[str, int],
) -> List[FeatureSpec]:
    """One :class:`FeatureSpec` per feature of each table, in table
    order."""
    return [
        FeatureSpec(
            name=f,
            table_name=c.name,
            table_rows=c.num_embeddings,
            dim=c.embedding_dim,
            pooling=getattr(c, "pooling", PoolingType.NONE),
            cap=caps[f],
        )
        for c in configs
        for f in c.feature_names
    ]


def per_slot_segments(lengths: torch.Tensor, cap: int) -> torch.Tensor:
    """Map buffer positions to example indices for one front-packed region.

    lengths : ``[..., B]`` per-example counts; returns ``[..., cap]`` int64
    with the example index in ``[0, B)`` for valid positions and ``B`` for
    padding."""
    B = lengths.shape[-1]
    offs = torch.cumsum(lengths.to(torch.int64), dim=-1)
    offs = torch.cat([torch.zeros_like(offs[..., :1]), offs], dim=-1)
    flat = offs.reshape(-1, B + 1)
    pos = torch.arange(cap, device=lengths.device, dtype=torch.int64)
    pos = pos.expand(flat.shape[0], cap).contiguous()
    b = torch.searchsorted(flat, pos, right=True) - 1
    segs = torch.where(pos < flat[:, B : B + 1], b, B)
    return segs.reshape(lengths.shape[:-1] + (cap,))


def source_weights(
    jt_weights: Optional[torch.Tensor],
    seg: torch.Tensor,
    lengths: torch.Tensor,
    pooling: PoolingType,
) -> torch.Tensor:
    """Per-id float32 weights computed at the source: SUM -> the given
    weights (or 1), MEAN -> (weights or 1) / length.  Padding positions
    (``seg == B``) get 0, so they vanish from the lookup and the
    gradient."""
    B = lengths.shape[-1]
    w = (
        torch.ones(seg.shape, dtype=torch.float32, device=seg.device)
        if jt_weights is None
        else jt_weights.to(torch.float32)
    )
    if pooling == PoolingType.MEAN:
        denom = lengths[seg.clamp(0, B - 1)].clamp(min=1).to(torch.float32)
        w = w / denom
    return torch.where(seg < B, w, 0.0)


def moe_dispatch(
    ids: torch.Tensor,
    payload: Tuple[torch.Tensor, ...],
    dest: torch.Tensor,
    valid: torch.Tensor,
    num_dest: int,
    cap: int,
    fill_values: Tuple,
) -> Tuple[torch.Tensor, ...]:
    """Sort-based bucketing by destination (the MoE dispatch): ``ids``
    and each payload go to a ``[num_dest, cap]`` buffer whose bucket
    ``d`` holds, front-packed and in their input order (a stable sort),
    the valid entries with ``dest == d``; the rest of a bucket holds its
    array's fill value.  Entries past ``cap`` in one bucket, and entries
    with a destination outside ``[0, num_dest)``, are dropped, as in the
    JAX package (callers size ``cap`` at the worst case for exactness).
    Returns ``(ids_out, *payload_out)``.  No host sync."""
    V = ids.shape[0]
    dev = ids.device
    d = torch.where(valid & (dest >= 0), dest.to(torch.int64), num_dest)
    d = d.clamp(max=num_dest)
    order = torch.argsort(d, stable=True)
    sd = d[order]
    counts = torch.zeros(num_dest + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, sd, torch.ones_like(sd))  # a bincount, no sync
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(V, device=dev) - starts[sd]
    slot = torch.where((sd < num_dest) & (rank < cap), sd * cap + rank,
                       num_dest * cap)
    outs = []
    for src, fill in zip((ids,) + tuple(payload), fill_values):
        # one spare element past the buckets takes every dropped entry
        buf = torch.full((num_dest * cap + 1,), fill, dtype=src.dtype,
                         device=dev)
        buf[slot] = src[order]
        outs.append(buf[:-1].view(num_dest, cap))
    return tuple(outs)


def moe_dispatch_batched(
    ids_per_group: Sequence[torch.Tensor],
    payload_per_group: Sequence[Sequence[torch.Tensor]],
    dest_per_group: Sequence[torch.Tensor],
    valid_per_group: Sequence[torch.Tensor],
    num_dest: int,
    cap: int,
    fill_values: Tuple,
) -> Tuple[torch.Tensor, ...]:
    """:func:`moe_dispatch` of many groups (features or slots) with one
    sort: group ``g``'s entries go to bucket ``dest * G + g``.  Outputs
    are ``[num_dest, G, cap]``, each ``(dest, group)`` bucket
    front-packed in the group's input order."""
    G = len(ids_per_group)
    dev = ids_per_group[0].device
    group_idx = torch.cat([
        torch.full((a.shape[0],), g, dtype=torch.int64, device=dev)
        for g, a in enumerate(ids_per_group)])
    dest = torch.cat([d.to(torch.int64) for d in dest_per_group])
    # an entry bound outside [0, num_dest) stays outside after the flattening
    d2 = torch.where((dest >= 0) & (dest < num_dest), dest * G + group_idx,
                     -1)
    outs = moe_dispatch(
        torch.cat(list(ids_per_group)),
        tuple(torch.cat(list(p)) for p in payload_per_group),
        d2, torch.cat(list(valid_per_group)), num_dest * G, cap,
        fill_values)
    return tuple(o.view(num_dest, G, cap) for o in outs)


def all_to_all(x: torch.Tensor, env: "comm.ShardingEnv",
               tag: Optional[str] = None) -> torch.Tensor:
    """``[N, ...]`` -> ``[N, ...]``: block ``j`` of the result is the
    block rank ``j`` sent this rank.  ``tag`` labels the payload in the
    wire-byte ledger (its raw bytes, split by link class with the env's
    ``dcn_fraction``)."""
    record_wire_bytes(tag or "all_to_all:raw", x.numel() * x.element_size(),
                      env.dcn_fraction)
    return comm.all_to_all(x, env)


def bucket_slots(bucket: torch.Tensor, rows: torch.Tensor,
                  num_buckets: int, cap: int, unique: bool, fill: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A send slot in a ``[num_buckets, cap]`` buffer for each element:
    the lexicographic (bucket, row) order by two stable sorts (the row,
    then the bucket: the JAX package's order, so the slots are its own).
    ``unique``: equal (bucket, row) pairs share one slot; else every
    element has its own.  ``bucket == num_buckets``
    marks an element not sent.  Returns (slot ``[T]`` int32,
    ``num_buckets * cap`` for an element not sent; the rows buffer
    ``[num_buckets * cap]`` int32, ``fill`` where empty; the 0-d int32
    count of groups past ``cap``).  No host sync."""
    T, dev = rows.shape[0], rows.device
    bucket = bucket.to(torch.int64)
    ord1 = torch.sort(rows, stable=True).indices
    order = ord1[torch.sort(bucket[ord1], stable=True).indices]
    sd, sid = bucket[order], rows[order]
    if unique:
        is_start = torch.ones((T,), dtype=torch.bool, device=dev)
        if T > 1:
            is_start[1:] = (sd[1:] != sd[:-1]) | (sid[1:] != sid[:-1])
    else:
        is_start = torch.ones((T,), dtype=torch.bool, device=dev)
    grp = torch.cumsum(is_start.to(torch.int64), 0) - 1
    per_bucket = torch.zeros(num_buckets + 1, dtype=torch.int64, device=dev)
    per_bucket.index_add_(0, sd, is_start.to(torch.int64))
    gstart = torch.cumsum(per_bucket, 0) - per_bucket
    rank = grp - gstart[sd]
    sent = num_buckets * cap
    slot_sorted = torch.where((sd < num_buckets) & (rank < cap),
                              sd * cap + rank, sent)
    slot = torch.empty((T,), dtype=torch.int32, device=dev)
    slot[order] = slot_sorted.to(torch.int32)
    # the elements of one group write the same row; the spare last element
    # takes every element not sent
    buf = torch.full((sent + 1,), fill, dtype=torch.int32, device=dev)
    buf[slot_sorted] = sid.to(torch.int32)
    overflow = (is_start & (sd < num_buckets) & (rank >= cap)).sum().to(
        torch.int32)
    return slot, buf[:sent], overflow
