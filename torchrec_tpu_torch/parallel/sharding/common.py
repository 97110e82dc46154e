"""Shared machinery for sharded embedding execution (a subset of
``torchrec_tpu/parallel/sharding/common.py``): the (feature, table)
bindings of a group, the slot -> example map of a front-packed region and
the per-id weights computed at the source.

Left out: ``moe_dispatch``/``moe_dispatch_batched`` (row-wise dists) and
``all_to_all`` (multi-GPU sharding, ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)


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
