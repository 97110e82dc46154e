"""Row-wise int8/int4/int2 quantization and the quantized pooled lookups
(``torchrec_tpu/ops/quant_ops.py``).

Rows are stored as uint8 codes (int4/int2 packed two/four per byte) with a
float32 scale and bias per row; ``dequant = code * scale + bias``.  The
codes, scales and biases are bit-equal to the JAX package's (``torch.round``
rounds half to even, as ``jnp.round`` does).

The lookups dispatch to the kernels of ``ops/tbe.py``; the caller passes
``kernel``: ``"tbe"`` (the int8 per-id kernel, B3, in the role of
``"pallas"``) or ``"dedup"`` (the dedup kernel for every packed width, B5,
in the role of ``"pallas_dedup"``).  The JAX package's process-wide
``set_quant_lookup_kernel`` is here with its names (:data:`QUANT_KERNELS`,
under ``embedding_ops.TRACE_KERNEL_LOCK``, its options kept and inert), read
when a ``QuantEmbeddingBagCollection`` is built with no kernel of its own
(:func:`resolve_quant_kernel`): ``"xla"`` and ``"pallas"`` are B3 for int8
(and B5 for int4/int2, which B3 does not read), the dedup names B5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchrec_tpu_torch.ops.embedding_ops import TRACE_KERNEL_LOCK
from torchrec_tpu_torch.ops.tbe import (
    dedup_quant_pooled_lookup,
    quant_pooled_lookup_int8,
    unpack_rows,
)

LOOKUP_KERNELS = ("tbe", "dedup")
# the JAX package's quantized-lookup kernel names and the port kernel of
# each (for int8, fp16 and bf16 tables; int4/int2 always take "dedup")
QUANT_KERNELS = ("xla", "xla_dedup", "pallas", "pallas_dedup")
QUANT_KERNEL_MAP = {"xla": "tbe", "pallas": "tbe", "xla_dedup": "dedup",
                    "pallas_dedup": "dedup"}
_QUANT_KERNEL = "xla"
_QUANT_PALLAS_OPTS = {"chunk": 1024, "group": 16, "interpret": False}
_QUANT_DEDUP_OPTS = {"id_cap": None, "u_cap": None}


def set_quant_lookup_kernel(
    kind: str,
    chunk: int = 1024,
    group: int = 16,
    interpret: bool = False,
    id_cap: Optional[int] = None,
    u_cap: Optional[int] = None,
) -> None:
    """Select the quantized pooled-lookup kernel process-wide by its JAX
    name (one of :data:`QUANT_KERNELS`); the options are kept and do
    nothing in the port.  Thread-safe (``TRACE_KERNEL_LOCK``)."""
    global _QUANT_KERNEL
    if kind not in QUANT_KERNELS:
        raise ValueError(f"unknown quant lookup kernel {kind!r}")
    with TRACE_KERNEL_LOCK:
        _QUANT_KERNEL = kind
        _QUANT_PALLAS_OPTS.update(chunk=chunk, group=group,
                                  interpret=interpret)
        _QUANT_DEDUP_OPTS.update(id_cap=id_cap, u_cap=u_cap)


def get_quant_lookup_kernel() -> str:
    """The process-wide quantized pooled-lookup kernel."""
    return _QUANT_KERNEL


def resolve_quant_kernel(kernel: Optional[str]) -> Optional[str]:
    """The port's kernel (:data:`LOOKUP_KERNELS`) for ``kernel``: itself
    when it names one; for None the process-wide selection's: ``"dedup"``
    under a JAX dedup name, and None under ``"xla"``/``"pallas"``, the
    per-table default (B3 for int8, B1 for fp16/bf16, B5 for int4/int2).
    An explicit kernel takes the port's names only."""
    if kernel is None:
        with TRACE_KERNEL_LOCK:
            if _QUANT_KERNEL in ("xla", "pallas"):
                return None
            return QUANT_KERNEL_MAP[_QUANT_KERNEL]
    if kernel not in LOOKUP_KERNELS:
        raise ValueError(f"unknown quant lookup kernel {kernel!r}")
    return kernel


def _quantize_rowwise(
    w: torch.Tensor, levels: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-row quantization to codes in ``[0, levels]``."""
    w = w.to(torch.float32)
    lo = w.min(dim=1).values
    hi = w.max(dim=1).values
    scale = torch.clamp(hi - lo, min=1e-8) / float(levels)
    q = torch.clamp(torch.round((w - lo[:, None]) / scale[:, None]), 0, levels)
    return q.to(torch.uint8), scale, lo


def quantize_rowwise_int8(
    w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-row int8: ``q = round((w - min) / scale)`` in
    ``[0, 255]`` as uint8.  Returns (q [R, D], scale [R], bias [R]) with
    bias the row minimum."""
    return _quantize_rowwise(w, 255)


def quantize_rowwise_int4(
    w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row asymmetric int4, two codes per byte (element ``2k`` in the
    low nibble of byte ``k``).  Returns (packed [R, D // 2], scale, bias)."""
    if w.shape[1] % 2:
        raise ValueError(f"int4 packing needs an even dim, got {w.shape[1]}")
    q, scale, lo = _quantize_rowwise(w, 15)
    return q[:, 0::2] | (q[:, 1::2] << 4), scale, lo


def quantize_rowwise_int2(
    w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row asymmetric int2, four codes per byte, low bits first.
    Returns (packed [R, D // 4], scale, bias)."""
    if w.shape[1] % 4:
        raise ValueError(
            f"int2 packing needs a dim divisible by 4, got {w.shape[1]}"
        )
    q, scale, lo = _quantize_rowwise(w, 3)
    packed = q[:, 0::4] | (q[:, 1::4] << 2) | (q[:, 2::4] << 4) | (q[:, 3::4] << 6)
    return packed, scale, lo


def dequantize_rowwise_int8(q: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rowwise_int8` (per-row scale and
    offset): ``q * scale + bias`` in float32."""
    return q.to(torch.float32) * scale[:, None] + bias[:, None]


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[R, D // 2] uint8 -> [R, D] uint8 (interleaved low/high nibbles)."""
    return unpack_rows(packed, 4)


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    """[R, D // 4] uint8 -> [R, D] uint8 (interleaved 2-bit lanes)."""
    return unpack_rows(packed, 2)


def quantized_pooled_lookup(
    q: torch.Tensor,  # [R, D] uint8
    scale: torch.Tensor,  # [R] float32
    bias: torch.Tensor,  # [R] float32
    ids: torch.Tensor,  # [V]
    segments: torch.Tensor,  # [V]; outside [0, num_segments) is padding
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    kernel: str = "tbe",
) -> torch.Tensor:
    """Pooled int8 lookup with on-the-fly dequantization through the
    ``kernel`` of :data:`LOOKUP_KERNELS`.  Returns [num_segments, D]."""
    if kernel == "tbe":
        return quant_pooled_lookup_int8(
            q, scale, bias, ids, segments, num_segments, weights
        )
    if kernel == "dedup":
        return dedup_quant_pooled_lookup(
            q, scale, bias, ids, segments, num_segments, weights, bits=8
        )
    raise ValueError(f"unknown quant lookup kernel {kernel!r}")


def quantized_pooled_lookup_int4(
    packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pooled lookup over int4-packed rows (the dedup kernel, which
    unpacks each distinct row once)."""
    return dedup_quant_pooled_lookup(
        packed, scale, bias, ids, segments, num_segments, weights, bits=4
    )


def quantized_pooled_lookup_int2(
    packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pooled lookup over int2-packed rows (the dedup kernel)."""
    return dedup_quant_pooled_lookup(
        packed, scale, bias, ids, segments, num_segments, weights, bits=2
    )
