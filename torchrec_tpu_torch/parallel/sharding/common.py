"""Slot -> example mapping for a front-packed region (``per_slot_segments``
of ``torchrec_tpu/parallel/sharding/common.py``)."""

from __future__ import annotations

import torch


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
