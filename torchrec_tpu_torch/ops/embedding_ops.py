"""Embedding ops (a subset of ``torchrec_tpu/ops/embedding_ops.py``): the
pooled lookup behind the kernel of ``ops/tbe.py``, pooling weights and the
sort-based dedup scaffold.

Left out: the process-wide kernel switches (``set_pooled_lookup_kernel``,
``trace_kernels``; the port picks its kernel by the tensors' device), the
``xla_dedup``/``pallas_dedup`` lookups and their custom VJPs, with
``embedding_row_grads`` and ``aggregate_duplicate_rows`` (ROADMAP A7),
``sanitize_ids`` (the traced sanitizer is not ported) and
``sequence_embedding_lookup``.  The train step needs none of them: the
fused update of ``ops/tbe_backward.py`` takes the segment gradient.
"""

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


def pooled_embedding_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted-sum pooled lookup: ``[num_segments, D]`` in the table's
    dtype (float32 or bfloat16), accumulated in float32 in slot order.
    Ids clip to the table; slots whose segment lies outside
    ``[0, num_segments)`` are dropped.  On CUDA tensors this is the
    hand-written kernel of ``ops/tbe.py::pooled_lookup`` (the port of the
    JAX package's Pallas TBE forward); on CPU tensors its plain version."""
    from torchrec_tpu_torch.ops.tbe import pooled_lookup

    if weights is not None:
        weights = weights.to(torch.float32)
    return pooled_lookup(table, ids, segments, num_segments, weights)
