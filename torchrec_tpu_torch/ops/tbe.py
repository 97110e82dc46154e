"""Pooled-lookup kernels for Hopper, their wrappers and their plain
PyTorch versions.

Replaces, from the JAX package's ``torchrec_tpu/ops/pallas_tbe.py``:

* ``tbe_pooled_forward_sorted`` (kernel body ``_tbe_body``, input
  preparation ``_sort_pad_inputs``, wrapper
  ``pallas_pooled_embedding_lookup``) by :func:`pooled_lookup`, over
  float32 and bfloat16 tables (``csrc/tbe_float.cu``);
* ``pallas_quantized_pooled_lookup`` (kernel body ``_tbe_kernel_q8``, input
  preparation ``_sort_pad_inputs``) by :func:`quant_pooled_lookup_int8`;
* ``pallas_ragged_dedup_quantized_lookup`` (kernel body
  ``_dedup_kernel_q``, ``_unpack_lanes``, input preparation
  ``_dedup_prepare_inputs``) by :func:`dedup_quant_pooled_lookup`;
* ``pallas_ragged_dedup_lookup`` (kernel body ``_dedup_body``, input
  preparation ``_dedup_prepare_inputs``) by :func:`dedup_pooled_lookup`,
  over float32 and bfloat16 tables.  Its ``id_cap``/``u_cap`` knobs size
  the TPU kernel's grid and VMEM buffer and have no counterpart: the
  port's scratch is sized by the batch (``csrc/tbe_dedup.cu``).

The kernels are CUDA C++ in ``torchrec_tpu_torch/csrc/tbe_float.cu``,
``tbe_quant.cu`` and ``tbe_dedup.cu`` (their headers say what bounds them
and how they are laid out), built and loaded by ``ops/_native.py``, which
also keeps the launch counts that this module re-exports.  Each wrapper:

* checks devices, dtypes, shapes and contiguity;
* on CPU tensors runs its plain version (``*_plain``) and launches
  nothing; on CUDA tensors launches the kernel or raises — there is no
  fallback;
* adds one to its count in :data:`LAUNCHES` for every call that launches
  (the dedup wrappers' two launches, gather and pool, count as one); a
  call with no segments launches nothing and returns an empty output.

The plain versions sum each segment in slot order with separately rounded
multiplies and adds, exactly as the kernels do, so on the card a kernel
and its plain version are bitwise equal (``torch.equal``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.ops._native import (  # noqa: F401 (re-exported)
    FLOAT_DTYPES,
    LAUNCHES,
    count_launch,
    launch_counts,
    reset_launch_counts,
)
from torchrec_tpu_torch.ops.embedding_ops import (
    dedup_ids,
    dedup_inverse,
    run_sums,
)

_SOURCE = "tbe_quant.cu"
_FLOAT_SOURCE = "tbe_float.cu"
_DEDUP_SOURCE = "tbe_dedup.cu"
_INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# input checks and preparation (shared by kernels and plain versions)
# ---------------------------------------------------------------------------


def _check_inputs(
    table: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
) -> torch.device:
    """Validate a quantized lookup's arguments; returns their common
    device."""
    if table.dtype != torch.uint8 or table.dim() != 2:
        raise TypeError(f"table must be 2-D uint8, got {table.dtype} "
                        f"{tuple(table.shape)}")
    R = table.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (R,):
            raise TypeError(f"{name} must be float32 [{R}], got {t.dtype} "
                            f"{tuple(t.shape)}")
    return _check_slots(table, ids, segments, weights, scale, bias)


def _check_float_inputs(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
) -> torch.device:
    """Validate a float lookup's arguments; returns their common device."""
    if table.dtype not in FLOAT_DTYPES or table.dim() != 2:
        raise TypeError(f"table must be 2-D float32 or bfloat16, got "
                        f"{table.dtype} {tuple(table.shape)}")
    return _check_slots(table, ids, segments, weights)


def _check_slots(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    *extra: torch.Tensor,
) -> torch.device:
    """The checks every lookup shares: one device, equal 1-D integer ids
    and segments, float32 weights of their shape, int32-sized rows and
    slots, contiguous buffers."""
    tensors = [table, ids, segments, *extra]
    if weights is not None:
        tensors.append(weights)
    dev = table.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(
                f"lookup inputs span devices {dev} and {t.device}"
            )
    if ids.dim() != 1 or segments.shape != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and segments "
                         f"{tuple(segments.shape)} must be equal 1-D shapes")
    if ids.dtype.is_floating_point or segments.dtype.is_floating_point:
        raise TypeError("ids and segments must be integer tensors")
    if weights is not None and (
        weights.dtype != torch.float32 or weights.shape != ids.shape
    ):
        raise TypeError(f"weights must be float32 {tuple(ids.shape)}")
    if table.shape[0] > _INT32_MAX or ids.shape[0] > _INT32_MAX:
        raise ValueError("rows and ids must each fit in int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lookup inputs must be contiguous")
    return dev


def _valid_key(segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment per slot with every invalid slot (negative or
    ``>= num_segments``) moved to the sentinel ``num_segments``."""
    valid = (segments >= 0) & (segments < num_segments)
    return torch.where(valid, segments, num_segments)


def _csr_offsets(sorted_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[S+1] start of each segment in a segment-sorted stream (the last
    entry is the number of valid slots; sentinel slots lie past it)."""
    bounds = torch.arange(
        num_segments + 1, device=sorted_key.device, dtype=sorted_key.dtype
    )
    return torch.searchsorted(sorted_key, bounds)


def sort_by_segment(
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_segments: int,
    num_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_sort_pad_inputs`` of the JAX package: a stable sort by segment
    with invalid slots last, ids clipped to ``[0, num_rows - 1]``.
    Returns (sorted ids, sorted weights, CSR offsets [S+1]); no host sync.
    Slots past ``offsets[-1]`` are invalid and never read."""
    key = _valid_key(segments, num_segments)
    order = torch.argsort(key, stable=True)
    sids = ids.clamp(0, num_rows - 1)[order]
    w = (
        torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
        if weights is None
        else weights
    )
    return sids, w[order], _csr_offsets(key[order], num_segments)


def dedup_prepare(
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_segments: int,
    num_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_dedup_prepare_inputs`` of the JAX package: the valid slots, a
    sorted unique with inverse over their ids, then a stable segment sort
    that carries each slot's unique index.

    Returns (unique row ids [U] clipped to ``[0, num_rows - 1]``, unique
    index per sorted slot [n], sorted weights [n], CSR offsets [S+1]).
    Boolean masking and ``torch.unique`` synchronise with the host on
    CUDA; the dedup lookup accepts that for its smaller gather."""
    valid = (segments >= 0) & (segments < num_segments)
    vseg = segments[valid]
    uids, inv = torch.unique(ids[valid], sorted=True, return_inverse=True)
    order = torch.argsort(vseg, stable=True)
    w = (
        torch.ones(vseg.shape, dtype=torch.float32, device=ids.device)
        if weights is None
        else weights[valid]
    )
    return (
        uids.clamp(0, num_rows - 1),
        inv[order],
        w[order],
        _csr_offsets(vseg[order], num_segments),
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def unpack_rows(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """[N, Dp] uint8 -> [N, Dp * 8 // bits] uint8 codes in the
    interleaved low-bits-first order of ``quant_ops.unpack_int4`` /
    ``unpack_int2`` (element ``k * (8 // bits) + j`` is bits
    ``[j * bits, (j + 1) * bits)`` of byte ``k``)."""
    if bits == 8:
        return packed
    if bits not in (4, 2):
        raise ValueError(f"unsupported packed width {bits}")
    mask = (1 << bits) - 1
    per = 8 // bits
    parts = [(packed >> (j * bits)) & mask for j in range(per)]
    # explicit width: a -1 cannot be inferred for an empty batch of rows
    return torch.stack(parts, dim=-1).reshape(
        packed.shape[0], packed.shape[1] * per)


def _dequant(codes: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """q * scale + bias per row, as two separately rounded ops."""
    return codes.to(torch.float32) * scale[:, None] + bias[:, None]


def pool_slot_order(
    vals: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Sum the segment-sorted rows ``vals[offsets[s]:offsets[s+1]]`` of
    each segment in slot order (``embedding_ops.run_sums``: every add is
    the kernels' ``acc = acc + v`` in their order, on ``[segments still
    open, D]``, so a few long segments cost no padding).  Empty segments
    give zeros."""
    return run_sums(vals, offsets[:-1], offsets[1:] - offsets[:-1])


def pooled_lookup_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`pooled_lookup`: gather, widen to float32,
    weight, pool in slot order, round once to the table's dtype."""
    sids, sw, offsets = sort_by_segment(
        ids, segments, weights, num_segments, table.shape[0]
    )
    n = int(offsets[-1])  # the valid slots sort first
    vals = table[sids[:n]].to(torch.float32) * sw[:n, None]
    return pool_slot_order(vals, offsets).to(table.dtype)


def dedup_pooled_lookup_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`dedup_pooled_lookup`: each distinct valid
    row is gathered and widened to float32 once, re-expanded per slot
    through the inverse index, weighted and pooled in slot order, and the
    sum rounded once to the table's dtype."""
    uids, suidx, sw, offsets = dedup_prepare(
        ids, segments, weights, num_segments, table.shape[0]
    )
    rows = table[uids].to(torch.float32)
    vals = rows[suidx] * sw[:, None]
    return pool_slot_order(vals, offsets).to(table.dtype)


def quant_pooled_lookup_int8_plain(
    q: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`quant_pooled_lookup_int8`: gather and
    dequantize per slot, weight, pool in slot order."""
    sids, sw, offsets = sort_by_segment(
        ids, segments, weights, num_segments, q.shape[0]
    )
    vals = _dequant(q[sids], scale[sids], bias[sids]) * sw[:, None]
    return pool_slot_order(vals, offsets)


def dedup_quant_pooled_lookup_plain(
    packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    bits: int = 8,
) -> torch.Tensor:
    """Plain version of :func:`dedup_quant_pooled_lookup`, after the JAX
    package's ``quant_ops._dedup_dequant_rows``: each distinct row is
    unpacked and dequantized once (``dedup_ids``), re-expanded per slot
    through the inverse index, weighted and pooled in slot order."""
    R = packed.shape[0]
    valid = (segments >= 0) & (segments < num_segments)
    order, unique_slot, slot_rows = dedup_ids(ids, valid)
    rows_c = slot_rows.clamp(0, R - 1)
    u_vals = _dequant(unpack_rows(packed[rows_c], bits), scale[rows_c],
                      bias[rows_c])
    per_slot = u_vals[dedup_inverse(order, unique_slot)]
    key = _valid_key(segments, num_segments)
    sorder = torch.argsort(key, stable=True)
    w = (
        torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
        if weights is None
        else weights
    )
    vals = per_slot[sorder] * w[sorder][:, None]
    return pool_slot_order(vals, _csr_offsets(key[sorder], num_segments))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _stream_ptr(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _require_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(
            f"the lookup kernels run on CUDA tensors (CPU tensors take the "
            f"plain versions); got {dev}"
        )


def launch_pooled(
    table: torch.Tensor,
    sids: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
) -> torch.Tensor:
    """Launch the float pooled kernel on prepared inputs (the output of
    :func:`sort_by_segment`); returns [S, D] in the table's dtype."""
    S, D = offsets.shape[0] - 1, table.shape[1]
    if S == 0:
        return table.new_empty((0, D))
    lib = _native.load_library(_FLOAT_SOURCE)
    ids32 = sids.to(torch.int32).contiguous()
    off32 = offsets.to(torch.int32).contiguous()
    sw = sw.contiguous()
    out = torch.empty((S, D), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        err = lib.tbe_pooled(
            table.data_ptr(), ids32.data_ptr(), sw.data_ptr(),
            off32.data_ptr(), out.data_ptr(), S, D,
            FLOAT_DTYPES[table.dtype], _stream_ptr(table.device),
        )
    _native.check_launch("tbe_pooled", err)
    count_launch("pooled_lookup")
    return out


def pooled_lookup(
    table: torch.Tensor,  # [R, D] float32 or bfloat16
    ids: torch.Tensor,  # [V] integer
    segments: torch.Tensor,  # [V] integer; invalid outside [0, S)
    num_segments: int,
    weights: Optional[torch.Tensor] = None,  # [V] float32
) -> torch.Tensor:
    """Pooled lookup ``out[s] = sum_i w_i * table[id_i]`` over the valid
    slots of segment ``s`` in slot order, accumulated in float32; ids clip
    to the table, slots whose segment lies outside ``[0, num_segments)``
    add nothing.  Returns [num_segments, D] in the table's dtype."""
    dev = _check_float_inputs(table, ids, segments, weights)
    if dev.type == "cpu":
        return pooled_lookup_plain(table, ids, segments, num_segments,
                                   weights)
    _require_cuda(dev)
    sids, sw, offsets = sort_by_segment(
        ids, segments, weights, num_segments, table.shape[0]
    )
    return launch_pooled(table, sids, sw, offsets)


def launch_q8_pooled(
    q: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    sids: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
) -> torch.Tensor:
    """Launch the int8 pooled kernel on prepared inputs (the output of
    :func:`sort_by_segment`); returns the [S, D] float32 output."""
    S, D = offsets.shape[0] - 1, q.shape[1]
    if S == 0:
        return torch.empty((0, D), dtype=torch.float32, device=q.device)
    lib = _native.load_library(_SOURCE)
    if D % 4 == 0 and q.data_ptr() % 4:
        raise ValueError("int8 table rows must be 4-byte aligned")
    ids32 = sids.to(torch.int32).contiguous()
    off32 = offsets.to(torch.int32).contiguous()
    sw = sw.contiguous()
    out = torch.empty((S, D), dtype=torch.float32, device=q.device)
    # the launch goes to the current device: make it the tensors' own
    with torch.cuda.device(q.device):
        err = lib.tbe_q8_pooled(
            q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            ids32.data_ptr(), sw.data_ptr(), off32.data_ptr(),
            out.data_ptr(), S, D, _stream_ptr(q.device),
        )
    _native.check_launch("tbe_q8_pooled", err)
    count_launch("quant_pooled_lookup_int8")
    return out


def quant_pooled_lookup_int8(
    q: torch.Tensor,  # [R, D] uint8
    scale: torch.Tensor,  # [R] float32
    bias: torch.Tensor,  # [R] float32
    ids: torch.Tensor,  # [V] integer
    segments: torch.Tensor,  # [V] integer; invalid outside [0, S)
    num_segments: int,
    weights: Optional[torch.Tensor] = None,  # [V] float32
) -> torch.Tensor:
    """Pooled int8 lookup with dequantization fused into the walk:
    ``out[s] = sum_i w_i * (q[id_i] * scale[id_i] + bias[id_i])`` over the
    valid slots of segment ``s`` in slot order; ids clip to the table.
    Returns [num_segments, D] float32."""
    dev = _check_inputs(q, scale, bias, ids, segments, weights)
    if dev.type == "cpu":
        return quant_pooled_lookup_int8_plain(
            q, scale, bias, ids, segments, num_segments, weights
        )
    _require_cuda(dev)
    sids, sw, offsets = sort_by_segment(
        ids, segments, weights, num_segments, q.shape[0]
    )
    return launch_q8_pooled(q, scale, bias, sids, sw, offsets)


def launch_dedup_q(
    packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    uids: torch.Tensor,
    suidx: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
    bits: int,
) -> torch.Tensor:
    """Launch the dedup gather and pool kernels on prepared inputs (the
    output of :func:`dedup_prepare`); returns [S, D] float32."""
    S, Dp = offsets.shape[0] - 1, packed.shape[1]
    D = Dp * (8 // bits)
    if S == 0:
        return torch.empty((0, D), dtype=torch.float32, device=packed.device)
    lib = _native.load_library(_SOURCE)
    U = uids.shape[0]
    dev = packed.device
    uids32 = uids.to(torch.int32).contiguous()
    idx32 = suidx.to(torch.int32).contiguous()
    off32 = offsets.to(torch.int32).contiguous()
    sw = sw.contiguous()
    rows = torch.empty((U, D), dtype=torch.float32, device=dev)
    out = torch.empty((S, D), dtype=torch.float32, device=dev)
    stream = _stream_ptr(dev)
    with torch.cuda.device(dev):
        err = lib.dedup_q_gather(
            packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            uids32.data_ptr(), rows.data_ptr(), U, D, Dp, bits, stream,
        )
        _native.check_launch("dedup_q_gather", err)
        err = lib.dedup_pool(
            rows.data_ptr(), idx32.data_ptr(), sw.data_ptr(),
            off32.data_ptr(), out.data_ptr(), S, D, stream,
        )
        _native.check_launch("dedup_pool", err)
    count_launch("dedup_quant_pooled_lookup")
    return out


def dedup_quant_pooled_lookup(
    packed: torch.Tensor,  # [R, D * bits // 8] uint8
    scale: torch.Tensor,  # [R] float32
    bias: torch.Tensor,  # [R] float32
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    bits: int = 8,
) -> torch.Tensor:
    """Dedup pooled lookup over int8/int4/int2 packed rows with
    dequant-at-gather: each distinct row is unpacked and dequantized once,
    then pooled per segment through the inverse index (same function as
    :func:`quant_pooled_lookup_int8` for ``bits=8``).  Returns
    [num_segments, D] float32."""
    if bits not in (8, 4, 2):
        raise ValueError(f"unsupported packed width {bits}")
    dev = _check_inputs(packed, scale, bias, ids, segments, weights)
    if dev.type == "cpu":
        return dedup_quant_pooled_lookup_plain(
            packed, scale, bias, ids, segments, num_segments, weights, bits
        )
    _require_cuda(dev)
    uids, suidx, sw, offsets = dedup_prepare(
        ids, segments, weights, num_segments, packed.shape[0]
    )
    return launch_dedup_q(packed, scale, bias, uids, suidx, sw, offsets, bits)


def launch_dedup_pooled(
    table: torch.Tensor,
    uids: torch.Tensor,
    suidx: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
) -> torch.Tensor:
    """Launch the float dedup gather and pool kernels on prepared inputs
    (the output of :func:`dedup_prepare`); returns [S, D] in the table's
    dtype (the float32 pool rounded once)."""
    S, D = offsets.shape[0] - 1, table.shape[1]
    if S == 0:
        return table.new_empty((0, D))
    lib = _native.load_library(_DEDUP_SOURCE)
    dev = table.device
    uids32 = uids.to(torch.int32).contiguous()
    idx32 = suidx.to(torch.int32).contiguous()
    off32 = offsets.to(torch.int32).contiguous()
    sw = sw.contiguous()
    # the distinct rows widened to float32: device memory, no budget (the
    # TPU kernel's 8 MiB VMEM budget has no counterpart; csrc/tbe_dedup.cu)
    rows = torch.empty((uids32.shape[0], D), dtype=torch.float32, device=dev)
    out = torch.empty((S, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dedup_pooled(
            table.data_ptr(), uids32.data_ptr(), idx32.data_ptr(),
            sw.data_ptr(), off32.data_ptr(), rows.data_ptr(), out.data_ptr(),
            uids32.shape[0], S, D, FLOAT_DTYPES[table.dtype],
            _stream_ptr(dev),
        )
    _native.check_launch("dedup_pooled", err)
    count_launch("dedup_pooled_lookup")
    return out.to(table.dtype)


def dedup_pooled_lookup(
    table: torch.Tensor,  # [R, D] float32 or bfloat16
    ids: torch.Tensor,  # [V] integer
    segments: torch.Tensor,  # [V] integer; invalid outside [0, S)
    num_segments: int,
    weights: Optional[torch.Tensor] = None,  # [V] float32
) -> torch.Tensor:
    """Ragged dedup pooled lookup: the same function as
    :func:`pooled_lookup` (bitwise, for float32 tables), computed by
    reading each distinct valid row once into a float32 scratch and
    pooling every segment through the inverse index.  Returns
    [num_segments, D] in the table's dtype.  The sort-unique synchronises
    with the host on CUDA."""
    dev = _check_float_inputs(table, ids, segments, weights)
    if dev.type == "cpu":
        return dedup_pooled_lookup_plain(table, ids, segments, num_segments,
                                         weights)
    _require_cuda(dev)
    uids, suidx, sw, offsets = dedup_prepare(
        ids, segments, weights, num_segments, table.shape[0]
    )
    return launch_dedup_pooled(table, uids, suidx, sw, offsets)
