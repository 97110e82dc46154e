"""Quantized collectives and the wire-byte ledger (a subset of
``torchrec_tpu/parallel/qcomm.py``).

A :class:`QCommsConfig` picks the wire precision of the forward and
backward collectives: float32, a cast to float16 / bfloat16 around the
collective, or a row-wise int8 / fp8 (e4m3) code whose float16 scales
travel beside it (one scale per trailing-dim row, the JAX package's
codec).  ``loss_scale`` multiplies backward payloads before a lossy code
and divides after it.

The ledger (:func:`wire_accounting`, kept in ``parallel/comm.py`` and
re-exported here) records the logical payload of each collective per tag
as the JAX package's does while it traces.

The reduce-scatter is an all-to-all of the ``[N, ...]`` blocks followed
by a sum over sources in rank order (``comm.sum_over_ranks``), at every
precision: a backend's reduce-scatter sums in its own order, NCCL's and
gloo's differ, and the rank-order sum gives the same bits on both.

Every record also lands under the link classes ``LINK_ICI`` /
``LINK_DCN``, split by the collective's ``dcn_fraction``: the env's own
(``comm.ShardingEnv.dcn_fraction``: ``(S - 1) / S`` over a world of S
slices, 0 on a flat one) unless the caller gives one.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

from torchrec_tpu_torch.parallel.comm import (  # noqa: F401 - re-exported
    LINK_DCN,
    LINK_ICI,
    LINK_TAGS,
    ShardingEnv,
    all_gather,
    all_to_all,
    cross_slice_fraction,
    record_wire_bytes,
    sum_over_ranks,
    wire_accounting,
)

class CommType(str, enum.Enum):
    """Wire precision of a quantized collective."""

    FP32 = "fp32"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8 = "fp8"  # e4m3
    INT8 = "int8"


_CAST_DTYPES = {CommType.FP16: torch.float16, CommType.BF16: torch.bfloat16}
_QMAX = {CommType.INT8: 127.0, CommType.FP8: 448.0}  # e4m3 finite max


@dataclasses.dataclass(frozen=True)
class QCommsConfig:
    """Forward and backward wire precisions; ``loss_scale`` multiplies
    backward payloads before a lossy code and divides after it."""

    forward_precision: CommType = CommType.FP32
    backward_precision: CommType = CommType.FP32
    loss_scale: Optional[float] = None

    def precision(self, which: str) -> CommType:
        if which not in ("fwd", "bwd"):
            raise ValueError(which)
        return CommType(self.forward_precision if which == "fwd"
                        else self.backward_precision)


def _precision(qcomms: Optional[QCommsConfig], which: str) -> CommType:
    return qcomms.precision(which) if qcomms is not None else CommType.FP32


def rowwise_quantize(x: torch.Tensor,
                     prec: CommType) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., D]`` float32 -> (``[..., D]`` int8 or float8_e4m3fn,
    ``[..., 1]`` float16 scales)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    qmax = _QMAX[prec]
    scale = torch.where(amax > 0, amax / qmax, 1.0)
    y = x / scale
    if prec == CommType.INT8:
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(y, -qmax, qmax).to(torch.float8_e4m3fn)
    return q, scale.to(torch.float16)


def rowwise_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)


def wire_bytes_per_f32(qcomms: Optional[QCommsConfig], which: str,
                       row_dim: int) -> float:
    """Wire bytes per float32 element under the configured precision
    (4.0 = float32)."""
    prec = _precision(qcomms, which)
    if prec == CommType.FP32:
        return 4.0
    if prec in _CAST_DTYPES:
        return 2.0
    return 1.0 + 2.0 / max(row_dim, 1)  # payload + a float16 scale per row


def _record_payload(tag: Optional[str], default: str, x: torch.Tensor,
                    qcomms: Optional[QCommsConfig], which: str,
                    fanout: int = 1, dcn_fraction: float = 0.0) -> None:
    """``fanout`` scales a buffer replicated to every peer (an all-gather
    broadcasts its input N ways); ``dcn_fraction`` splits the record into
    the link classes."""
    wpf = wire_bytes_per_f32(qcomms, which, x.shape[-1] if x.dim() else 1)
    record_wire_bytes(tag or f"{default}:{which}", x.numel() * wpf * fanout,
                      dcn_fraction)


def _a2a(x: torch.Tensor, env: ShardingEnv) -> torch.Tensor:
    if x.dtype == torch.float8_e4m3fn:  # crosses the wire as its bytes
        return _a2a(x.view(torch.uint8), env).view(x.dtype)
    return all_to_all(x, env)


def _gather(x: torch.Tensor, env: ShardingEnv) -> torch.Tensor:
    if x.dtype == torch.float8_e4m3fn:
        return _gather(x.view(torch.uint8), env).view(x.dtype)
    return all_gather(x, env)


def _coded(x: torch.Tensor, qcomms: Optional[QCommsConfig], which: str,
           collective) -> torch.Tensor:
    """``collective`` (a2a or gather) of ``x`` at the wire precision,
    decoded to float32."""
    prec = _precision(qcomms, which)
    if prec == CommType.FP32:
        return collective(x)
    ls = qcomms.loss_scale if which == "bwd" else None
    y = x * ls if ls else x
    if prec in _CAST_DTYPES:
        out = collective(y.to(_CAST_DTYPES[prec])).to(torch.float32)
    else:
        q, scale = rowwise_quantize(y, prec)
        out = rowwise_dequantize(collective(q), collective(scale))
    return out / ls if ls else out


def qcomm_all_to_all(x: torch.Tensor, env: ShardingEnv,
                     qcomms: Optional[QCommsConfig], which: str,
                     tag: Optional[str] = None) -> torch.Tensor:
    """All-to-all of ``[N, ...]`` float32 blocks at the configured wire
    precision."""
    _record_payload(tag, "all_to_all", x, qcomms, which,
                    dcn_fraction=env.dcn_fraction)
    return _coded(x, qcomms, which, lambda v: _a2a(v, env))


def qcomm_psum_scatter(x: torch.Tensor, env: ShardingEnv,
                       qcomms: Optional[QCommsConfig], which: str,
                       tag: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter: ``x`` ``[N, ...]`` holds this rank's contribution
    to each rank; returns the sum over ranks of this rank's block, the
    blocks shipped at the wire precision by all-to-all and summed on
    arrival in rank order."""
    _record_payload(tag, "psum_scatter", x, qcomms, which,
                    dcn_fraction=env.dcn_fraction)
    return sum_over_ranks(_coded(x, qcomms, which, lambda v: _a2a(v, env)))


def qcomm_all_gather(x: torch.Tensor, env: ShardingEnv,
                     qcomms: Optional[QCommsConfig], which: str,
                     tag: Optional[str] = None,
                     fanout: int = 1) -> torch.Tensor:
    """All-gather (a new leading rank axis) at the configured wire
    precision.  ``fanout`` (the world size) scales the ledger's record to
    the N-fold broadcast."""
    _record_payload(tag, "all_gather", x, qcomms, which, fanout=fanout,
                    dcn_fraction=env.dcn_fraction)
    return _coded(x, qcomms, which, lambda v: _gather(v, env))
