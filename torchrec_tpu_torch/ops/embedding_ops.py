"""Pooling weights and the sort-based dedup scaffold (the serving subset
of ``torchrec_tpu/ops/embedding_ops.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mean_pooling_weights(
    segments: torch.Tensor,
    lengths: torch.Tensor,
    base_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slot float32 weights implementing MEAN pooling as weighted SUM.

    lengths : ``[num_segments]`` per-example id counts.  Slots of padding
    (``segments >= num_segments``) get weight 0."""
    num_segments = lengths.shape[0]
    inv = torch.where(
        lengths > 0, 1.0 / lengths.clamp(min=1).to(torch.float32), 0.0
    )
    seg_clipped = segments.clamp(0, num_segments - 1)
    w = torch.where(segments < num_segments, inv[seg_clipped], 0.0)
    if base_weights is not None:
        w = w * base_weights
    return w


def dedup_ids(
    ids: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based duplicate grouping (a ``unique`` of static shape).

    Returns (order, unique_slot, slot_rows):
      order       : ``[V]`` stable permutation sorting ids, invalid slots
                    last;
      unique_slot : ``[V]`` for each *sorted* position, the index of its
                    unique-id group (0..n_unique-1);
      slot_rows   : ``[V]`` for each unique group index, the row id (the
                    dtype's max for groups beyond n_unique and for the
                    invalid-id group)."""
    V = ids.shape[0]
    big = torch.iinfo(ids.dtype).max
    keyed = torch.where(valid, ids, big)
    order = torch.argsort(keyed, stable=True)
    sids = keyed[order]
    is_start = torch.ones((V,), dtype=torch.bool, device=ids.device)
    if V > 1:
        is_start[1:] = sids[1:] != sids[:-1]
    unique_slot = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    slot_rows = torch.full((V,), big, dtype=ids.dtype, device=ids.device)
    # every position of a group writes the same row id, so the scatter's
    # order among duplicates does not matter
    slot_rows[unique_slot] = sids
    return order, unique_slot, slot_rows


def dedup_inverse(order: torch.Tensor, unique_slot: torch.Tensor) -> torch.Tensor:
    """Inverse map of :func:`dedup_ids`: for each ORIGINAL slot, the index
    of its unique-id group."""
    inv = torch.zeros(order.shape, dtype=torch.int64, device=order.device)
    inv[order] = unique_slot
    return inv
