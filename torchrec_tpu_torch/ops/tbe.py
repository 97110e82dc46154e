"""Pooled-lookup kernels for Hopper, their wrappers and their plain
PyTorch versions.

Replaces, from the JAX package's ``torchrec_tpu/ops/pallas_tbe.py``:

* ``tbe_pooled_forward_sorted`` (kernel body ``_tbe_body``, input
  preparation ``_sort_pad_inputs``, wrapper
  ``pallas_pooled_embedding_lookup``) by :func:`pooled_lookup_regions`
  over a slot stream in its producer's layout (:class:`SlotRegions`: the
  table-wise ``[N, F, C]`` slots, a KeyedJaggedTensor's keys; no sort),
  and by :func:`pooled_lookup` over a stream in any order (a stable
  segment sort first), over float32, bfloat16 and float16 tables, into
  the table's dtype or, from a 16-bit table, float32
  (``csrc/tbe_float.cu``); for every feature of a served batch by
  :func:`float_pooled_lookup_grouped` (one launch a feature, into its
  columns of the KeyedTensor's buffer);
* ``pallas_quantized_pooled_lookup`` (kernel body ``_tbe_kernel_q8``, input
  preparation ``_sort_pad_inputs``) by :func:`quant_pooled_lookup_int8`,
  and for all the features of a served batch at once by
  :func:`quant_pooled_lookup_int8_grouped`;
* ``pallas_ragged_dedup_quantized_lookup`` (kernel body
  ``_dedup_kernel_q``, ``_unpack_lanes``, input preparation
  ``_dedup_prepare_inputs``, whose sized sort-unique is
  :func:`sized_unique`) by :func:`dedup_quant_pooled_lookup` and
  :func:`dedup_quant_pooled_lookup_grouped`;
* ``pallas_ragged_dedup_lookup`` (kernel body ``_dedup_body``, input
  preparation ``_dedup_prepare_inputs``) by :func:`dedup_pooled_lookup`,
  over the same dtypes as B1 (and grouped the same way).  Its ``id_cap``/``u_cap`` knobs size
  the TPU kernel's grid and VMEM buffer and have no counterpart: the
  port's kernel keeps no copy of the distinct rows and reads each slot's
  row from the table (``csrc/tbe_dedup.cu``).

The kernels are CUDA C++ in ``torchrec_tpu_torch/csrc/tbe_float.cu``,
``tbe_quant.cu`` and ``tbe_dedup.cu`` (their headers say what bounds them
and how they are laid out), built and loaded by ``ops/_native.py``, which
also keeps the launch counts that this module re-exports.  The serving
path's grouped lookups (B3, B5 and the grouped float B1 and B4) and the
per-table B3/B5 launch through the ``trt::`` operators of
``ops/custom_ops.py`` (``csrc/torch_ops.cpp``), so that eager calls and an
exported program (``inference/predict_factory.py::export_native``) run one
code path to the same kernels; under ``torch.export`` on the CPU their
plain versions trace with static shapes.  Each wrapper:

* checks devices, dtypes, shapes and contiguity;
* on CPU tensors runs its plain version (``*_plain``) and launches
  nothing; on CUDA tensors launches the kernel or raises — there is no
  fallback;
* adds one to its count in :data:`LAUNCHES` for every call that launches
  (the quantized dedup wrappers' launches, gather and pool, and for a
  group also the keys, count as one; a grouped call counts one for all
  its features); a call with no segments launches nothing and returns an
  empty output.

The plain versions sum each segment in slot order with separately rounded
multiplies and adds, exactly as the kernels do, so on the card a kernel
and its plain version are bitwise equal (``torch.equal``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from torchrec_tpu_torch.ops import _native, custom_ops
from torchrec_tpu_torch.ops._native import (  # noqa: F401 (re-exported)
    FLOAT_DTYPES,
    LAUNCHES,
    LOOKUP_DTYPES,
    count_launch,
    launch_counts,
    reset_launch_counts,
)
from torchrec_tpu_torch.ops.embedding_ops import (  # noqa: F401
    SlotRegions,
    dedup_ids,
    dedup_inverse,
    run_sums,
)

_FLOAT_SOURCE = "tbe_float.cu"
# the regions one float-lookup launch takes (kMaxRegions in tbe_float.cu)
_MAX_REGIONS = 128
_DEDUP_SOURCE = "tbe_dedup.cu"
_INT32_MAX = 2**31 - 1
# the index types the float lookup's kernel reads as they come
_INDEX_DTYPES = (torch.int32, torch.int64)
# the dedup keys: ``feature << 32 | id + 2**31`` for a valid slot (ids
# clipped to int32 first), the int64 maximum for every other slot
_ID_BIAS = 2**31
SENTINEL = torch.iinfo(torch.int64).max
# the most features one grouped launch takes (the kernels' Group parameter
# must stay under the 4 KB kernel-parameter limit, csrc/tbe_quant.cu)
MAX_GROUP_FEATURES = 48


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
    _check_float_table(table)
    return _check_slots(table, ids, segments, weights)


def _check_float_table(table: torch.Tensor) -> None:
    if table.dtype not in LOOKUP_DTYPES or table.dim() != 2:
        raise TypeError(f"table must be 2-D float32, bfloat16 or float16, "
                        f"got {table.dtype} {tuple(table.shape)}")


def _output_dtype(table: torch.Tensor,
                    out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """A float lookup's output dtype: the table's (``out_dtype`` None),
    or float32 for any table."""
    if out_dtype is None or out_dtype == table.dtype:
        return table.dtype
    if out_dtype != torch.float32:
        raise TypeError(f"a {table.dtype} table pools into {table.dtype} or "
                        f"float32, not {out_dtype}")
    return out_dtype


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


def _check_regions(
    table: torch.Tensor,
    ids: torch.Tensor,
    regions: SlotRegions,
    weights: Optional[torch.Tensor],
) -> torch.device:
    """Validate a float lookup over slot regions; returns the common
    device."""
    _check_float_table(table)
    lengths = regions.lengths
    tensors = [table, ids, lengths] + ([] if weights is None else [weights])
    dev = table.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"lookup inputs span devices {dev} and "
                             f"{t.device}")
    if ids.dim() != 1 or ids.dtype.is_floating_point:
        raise TypeError("ids must be a 1-D integer tensor")
    if lengths.dim() != 1 or lengths.dtype.is_floating_point:
        raise TypeError("lengths must be a 1-D integer tensor")
    V, S = ids.shape[0], regions.num_segments
    if not len(regions.starts) == len(regions.caps) == len(regions.counts):
        raise ValueError("starts, caps and counts must be of one length")
    if lengths.shape[0] != S:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs {S} examples "
                         f"in the regions")
    for start, cap, count in zip(regions.starts, regions.caps,
                                 regions.counts):
        if min(start, cap, count) < 0 or start + cap > V:
            raise ValueError(f"region ({start}, {cap}, {count}) outside "
                             f"{V} slots")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != ids.shape):
        raise TypeError(f"weights must be float32 {tuple(ids.shape)}")
    if max(table.shape[0], V, S) > _INT32_MAX:
        raise ValueError("rows, slots and segments must each fit in int32")
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
    CUDA: the plain version of the float dedup lookup (B4) prepares with
    it, the kernels with :func:`dedup_prepare_sized`."""
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


def unique_keys(
    ids: torch.Tensor, valid: torch.Tensor, feature: int = 0
) -> torch.Tensor:
    """The dedup key of each slot: ``feature << 32 | id + 2**31`` where
    ``valid`` (ids clipped to int32 first, so the keys of one feature sort
    as its ids do), :data:`SENTINEL` elsewhere."""
    key = ids.to(torch.int64).clamp(-_ID_BIAS, _ID_BIAS - 1) + (
        _ID_BIAS + (feature << 32))
    return torch.where(valid, key, SENTINEL)


def key_rows(ukeys: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The table row of each dedup key (its id clipped to
    ``[0, num_rows - 1]``)."""
    return ((ukeys & 0xFFFFFFFF) - _ID_BIAS).clamp(0, num_rows - 1)


def sized_unique(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sized sort-unique of ``_dedup_prepare_inputs``, with no host
    sync: one sort of ``keys`` [N] int64, boundary flags and a cumsum.

    Returns (ukeys [N]: the distinct keys in ascending order, then
    :data:`SENTINEL`; inv [N] int64: each slot's index into ukeys).  The
    number of distinct valid keys, :func:`num_unique`, stays on the device:
    the kernels stop at the first sentinel instead."""
    N = keys.shape[0]
    skeys, order = torch.sort(keys, stable=True)
    start = torch.ones((N,), dtype=torch.bool, device=keys.device)
    start[1:] = skeys[1:] != skeys[:-1]
    suid = torch.cumsum(start, dim=0) - 1
    inv = torch.empty_like(suid).scatter_(0, order, suid)
    # every position of a group writes the same key
    ukeys = torch.full_like(skeys, SENTINEL).scatter_(0, suid, skeys)
    return ukeys, inv


def num_unique(ukeys: torch.Tensor) -> torch.Tensor:
    """The distinct valid keys of a :func:`sized_unique`, as a 0-d device
    tensor."""
    return (ukeys != SENTINEL).sum()


def dedup_prepare_sized(
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dedup_prepare` with static shapes and no host sync: a
    stable segment sort with invalid slots last, then
    :func:`sized_unique` over the sorted slots' keys.

    Returns (ukeys [V], unique index per sorted slot [V], sorted weights
    [V], CSR offsets [S+1]); ``key_rows(ukeys[:U], R)`` are
    :func:`dedup_prepare`'s unique rows, with ``U = num_unique(ukeys)``,
    and the first ``offsets[-1]`` indices its per-slot indices."""
    if num_segments >= _INT32_MAX:
        raise ValueError("num_segments must fit in int32")
    # int32 segment keys: the radix sort takes half the passes of int64
    key = _valid_key(segments, num_segments).to(torch.int32)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    ukeys, inv = sized_unique(unique_keys(ids[order], skey < num_segments))
    w = (
        torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
        if weights is None
        else weights
    )
    return ukeys, inv, w[order], _csr_offsets(skey, num_segments)


class GroupFeature(NamedTuple):
    """One feature of a grouped lookup: its table, the index of its key in
    the KeyedJaggedTensor, its first column in the [B, sum D] output, and
    whether it pools by MEAN."""

    q: torch.Tensor  # [R, Dp] uint8
    scale: torch.Tensor  # [R] float32
    bias: torch.Tensor  # [R] float32
    key: int
    col: int
    mean: bool = False


def _check_group(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[GroupFeature],
    out: torch.Tensor,
    bits: int,
) -> Tuple[torch.device, int]:
    """Validate a grouped lookup's arguments; returns their device and the
    output width D of every feature."""
    if not features or len(features) > MAX_GROUP_FEATURES:
        raise ValueError(f"a group has 1 to {MAX_GROUP_FEATURES} features, "
                         f"got {len(features)}")
    if bits not in (8, 4, 2):
        raise ValueError(f"unsupported packed width {bits}")
    if out.dtype != torch.float32 or out.dim() != 2 or out.stride(1) != 1:
        raise TypeError(f"out must be a row-major 2-D float32 buffer, got "
                        f"{out.dtype} {tuple(out.shape)}")
    B, K = out.shape[0], len(cap_offsets) - 1
    if values.dim() != 1 or values.dtype.is_floating_point:
        raise TypeError("values must be a 1-D integer tensor")
    if values.shape[0] != cap_offsets[-1] or values.shape[0] > _INT32_MAX:
        raise ValueError(f"values {tuple(values.shape)} vs regions ending at "
                         f"{cap_offsets[-1]}")
    if lengths.dim() != 1 or lengths.shape[0] != K * B or (
            lengths.dtype.is_floating_point):
        raise ValueError(f"lengths must be [{K} keys * {B}] integers, got "
                         f"{tuple(lengths.shape)}")
    Dp = features[0].q.shape[1]
    D = Dp * (8 // bits)
    dev = out.device
    if values.device != dev or lengths.device != dev:
        raise ValueError(f"lookup inputs span devices {dev}, {values.device} "
                         f"and {lengths.device}")
    if not (values.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("values and lengths must be contiguous")
    # a served batch checks every table: keep each check to a few
    # attribute reads
    for f in features:
        q, scale, bias = f.q, f.scale, f.bias
        R = q.shape[0]
        if q.dtype != torch.uint8 or q.dim() != 2:
            raise TypeError(f"table must be 2-D uint8, got {q.dtype} "
                            f"{tuple(q.shape)}")
        if scale.dtype != torch.float32 or bias.dtype != torch.float32 or (
                scale.shape != (R,) or bias.shape != (R,)):
            raise TypeError(f"scale and bias must be float32 [{R}]")
        if q.shape[1] != Dp:
            raise ValueError("a group's tables share one row width")
        if not 0 <= f.key < K or not 0 <= f.col <= out.shape[1] - D:
            raise ValueError(f"feature key {f.key} or column {f.col} out of "
                             f"range")
        if q.device != dev or scale.device != dev or bias.device != dev:
            raise ValueError(f"lookup inputs span devices {dev} and "
                             f"{q.device}")
        if R > _INT32_MAX:
            raise ValueError("rows must fit in int32")
        if not (q.is_contiguous() and scale.is_contiguous()
                and bias.is_contiguous()):
            raise ValueError("lookup inputs must be contiguous")
    return dev, D


def group_ends(lengths: torch.Tensor, num_keys: int, B: int) -> torch.Tensor:
    """[num_keys, B] int32 running sums of each key's lengths: example
    ``b`` of key ``k`` holds the slots ``[ends[k, b-1], ends[k, b])`` of
    the key's region (one cumsum, no sort)."""
    return torch.cumsum(lengths.view(num_keys, B), dim=1, dtype=torch.int32)


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
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of :func:`pooled_lookup`: gather, widen to float32,
    weight, pool in slot order, round once to the output's dtype."""
    odt = _output_dtype(table, out_dtype)
    sids, sw, offsets = sort_by_segment(
        ids, segments, weights, num_segments, table.shape[0]
    )
    n = int(offsets[-1])  # the valid slots sort first
    vals = table[sids[:n]].to(torch.float32) * sw[:n, None]
    return pool_slot_order(vals, offsets).to(odt)


def pooled_lookup_regions_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    regions: SlotRegions,
    weights: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of :func:`pooled_lookup_regions`: each segment's
    slot range gathered in slot order, then the operations of
    :func:`pooled_lookup_plain` (widen, weight, pool in slot order, round
    once to the output's dtype)."""
    odt = _output_dtype(table, out_dtype)
    first, size = regions.ranges()
    offsets = torch.cat([size.new_zeros(1), torch.cumsum(size, 0)])
    n = int(offsets[-1])
    pos = torch.repeat_interleave(first - offsets[:-1], size,
                                  output_size=n) + torch.arange(
                                      n, device=ids.device)
    sids = ids[pos].clamp(0, table.shape[0] - 1)
    sw = (torch.ones((n,), dtype=torch.float32, device=ids.device)
          if weights is None else weights[pos])
    vals = table[sids].to(torch.float32) * sw[:, None]
    return pool_slot_order(vals, offsets).to(odt)


def dedup_pooled_lookup_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of :func:`dedup_pooled_lookup`: each distinct valid
    row is gathered and widened to float32 once, re-expanded per slot
    through the inverse index, weighted and pooled in slot order, and the
    sum rounded once to the output's dtype."""
    odt = _output_dtype(table, out_dtype)
    uids, suidx, sw, offsets = dedup_prepare(
        ids, segments, weights, num_segments, table.shape[0]
    )
    rows = table[uids].to(torch.float32)
    vals = rows[suidx] * sw[:, None]
    return pool_slot_order(vals, offsets).to(odt)


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


def _grouped_pool_plain(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[GroupFeature],
    out: torch.Tensor,
    slot_rows,
) -> torch.Tensor:
    """The grouped lookups' plain pooling: segment (f, b) is
    ``[ends[b-1], ends[b])`` of feature f's region clipped to its cap (no
    sort), weighted by ``1/len`` for MEAN features, summed in slot order
    over all ``F * B`` segments at once and written to ``out[:, col_f :
    col_f + D]``.  ``slot_rows(i, f, pos)`` gives the dequantized rows of
    feature ``i``'s valid slots at positions ``pos`` of ``values``."""
    B, K = out.shape[0], len(cap_offsets) - 1
    if B == 0:
        return out
    ends = group_ends(lengths, K, B).to(torch.int64)
    vals, starts, lens, n = [], [], [], 0
    for i, f in enumerate(features):
        cap = cap_offsets[f.key + 1] - cap_offsets[f.key]
        e = ends[f.key].clamp(max=cap)
        b0 = torch.cat([e.new_zeros(1), e[:-1]])
        total = int(e[-1])
        pos = cap_offsets[f.key] + torch.arange(total, device=values.device)
        v = slot_rows(i, f, pos)
        if f.mean:
            # 1/len of each example (the kernel's __fdiv_rn), over its
            # clipped slots
            f_len = lengths[f.key * B:(f.key + 1) * B]
            inv = torch.where(
                f_len > 0, 1.0 / f_len.clamp(min=1).to(torch.float32), 0.0)
            w = torch.repeat_interleave(inv, e - b0, output_size=total)
            v = v * w[:, None]
        vals.append(v)
        starts.append(n + b0)
        lens.append(e - b0)
        n += total
    pooled = run_sums(torch.cat(vals), torch.cat(starts), torch.cat(lens))
    D = pooled.shape[1]
    for i, f in enumerate(features):
        out[:, f.col:f.col + D] = pooled[i * B:(i + 1) * B]
    return out


def _grouped_pool_static(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence,
    out: torch.Tensor,
    slot_rows,
) -> torch.Tensor:
    """The grouped plain versions as ``torch.export`` traces them: static
    shapes and no host read.  Every slot of a feature's region is a row of
    ``slot_rows(i, f, pos)`` (MEAN features weighted by ``1/len``), added
    by ``index_add_`` to the row of the example that owns it; row ``B``
    collects the slots no example owns.  The same function as
    :func:`_grouped_pool_plain`, its sums in the order of ``index_add_``
    (not bitwise the kernels': the card path compiles the kernels'
    operators instead)."""
    B, K = out.shape[0], len(cap_offsets) - 1
    ends = group_ends(lengths, K, B).to(torch.int64)
    for i, f in enumerate(features):
        lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
        b = _slot_examples(ends[f.key], hi - lo)
        v = slot_rows(i, f, torch.arange(lo, hi, device=values.device))
        if f.mean:
            f_len = lengths[f.key * B:(f.key + 1) * B]
            inv = torch.where(
                f_len > 0, 1.0 / f_len.clamp(min=1).to(torch.float32), 0.0)
            v = v * torch.cat([inv, inv.new_zeros(1)])[b][:, None]
        pooled = v.new_zeros((B + 1, v.shape[1])).index_add_(0, b, v)
        out[:, f.col:f.col + v.shape[1]] = pooled[:B]
    return out


def quant_pooled_lookup_int8_grouped_plain(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[GroupFeature],
    out: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`quant_pooled_lookup_int8_grouped`: each
    valid slot dequantized, pooled per example in slot order."""

    def slot_rows(i, f, pos):
        r = values[pos].to(torch.int64).clamp(0, f.q.shape[0] - 1)
        return _dequant(f.q[r], f.scale[r], f.bias[r])

    pool = (_grouped_pool_static if torch.compiler.is_compiling()
            else _grouped_pool_plain)
    return pool(values, lengths, cap_offsets, features, out, slot_rows)


def group_keys_plain(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[GroupFeature],
    B: int,
) -> torch.Tensor:
    """Plain version of the ``dedup_q_keys`` kernel: each slot of
    ``values`` keyed by (feature index in the group, id) where it is a
    valid slot of a feature of the group, :data:`SENTINEL` elsewhere."""
    keys = torch.full(values.shape, SENTINEL, dtype=torch.int64,
                      device=values.device)
    if B == 0:
        return keys
    ends = group_ends(lengths, len(cap_offsets) - 1, B)
    for i, f in enumerate(features):
        lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
        total = min(int(ends[f.key, -1]), hi - lo)
        region = values[lo:hi]
        valid = torch.arange(hi - lo, device=values.device) < total
        keys[lo:hi] = unique_keys(region, valid, feature=i)
    return keys


def dedup_quant_pooled_lookup_grouped_plain(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[GroupFeature],
    out: torch.Tensor,
    bits: int = 8,
) -> torch.Tensor:
    """Plain version of :func:`dedup_quant_pooled_lookup_grouped`: the
    sized sort-unique over (feature, id) keys, each distinct row unpacked
    and dequantized once, re-expanded per slot through the inverse index
    and pooled per example in slot order.  Traced (``torch.export``), each
    slot's row is unpacked and dequantized where it stands: the same
    values, with static shapes."""
    if torch.compiler.is_compiling():
        def slot_row(i, f, pos):
            r = values[pos].to(torch.int64).clamp(0, f.q.shape[0] - 1)
            return _dequant(unpack_rows(f.q[r], bits), f.scale[r], f.bias[r])

        return _grouped_pool_static(values, lengths, cap_offsets, features,
                                    out, slot_row)
    keys = group_keys_plain(values, lengths, cap_offsets, features,
                            out.shape[0])
    ukeys, inv = sized_unique(keys)
    ukeys = ukeys[:int(num_unique(ukeys))]
    feat = ukeys >> 32
    D = features[0].q.shape[1] * (8 // bits)
    urows = torch.empty((ukeys.shape[0], D), dtype=torch.float32,
                        device=values.device)
    for i, f in enumerate(features):
        mine = feat == i
        r = key_rows(ukeys[mine], f.q.shape[0])
        urows[mine] = _dequant(unpack_rows(f.q[r], bits), f.scale[r],
                               f.bias[r])

    def slot_rows(i, f, pos):
        return urows[inv[pos]]

    return _grouped_pool_plain(values, lengths, cap_offsets, features, out,
                               slot_rows)


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


def region_ends(lengths: torch.Tensor) -> torch.Tensor:
    """The float kernel's ``ends`` of a :class:`SlotRegions`: the running
    sums of its lengths, one cumsum in their own type (int32 or int64)."""
    return torch.cumsum(lengths, 0, dtype=lengths.dtype)


def _output(table: torch.Tensor, S: int, out_dtype: Optional[torch.dtype],
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """The [S, D] output of a float lookup: ``out`` (checked: that shape
    and the output dtype, rows of stride >= D, columns contiguous, on the
    table's device), or a new tensor."""
    odt = _output_dtype(table, out_dtype)
    D = table.shape[1]
    if out is None:
        return torch.empty((S, D), dtype=odt, device=table.device)
    if (out.dtype != odt or tuple(out.shape) != (S, D)
            or out.device != table.device
            or (S > 1 and out.stride(0) < D) or (D > 1 and out.stride(1) != 1)):
        raise ValueError(f"out must be [{S}, {D}] {odt} on {table.device} "
                         f"with contiguous rows, got {out.dtype} "
                         f"{tuple(out.shape)} strides {out.stride()}")
    return out


def launch_pooled(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    ends: torch.Tensor,
    starts: Sequence[int],
    caps: Sequence[int],
    counts: Sequence[int],
    out_dtype: Optional[torch.dtype] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the float pooled kernel on prepared inputs: ``ids`` and
    ``ends`` int32 or int64 as they come, float32 ``weights`` or None
    (every weight 1), and the regions (``starts``, ``caps``, ``counts``)
    whose examples' running ends ``ends`` holds, :func:`region_ends` of a
    :class:`SlotRegions`'s lengths or, for a segment-sorted stream
    (:func:`sort_by_segment`), its CSR offsets past the first, one region
    of all its slots and segments.  One launch per ``_MAX_REGIONS``
    regions that hold an example, each counted.  Returns [sum(counts), D]
    in ``out_dtype`` (the table's dtype by default; float32 from any
    table), written into ``out`` when given (a view whose rows may be
    wider, e.g. one feature's columns of a KeyedTensor buffer); allocates
    at most the output; no host sync."""
    S, D = sum(counts), table.shape[1]
    out = _output(table, S, out_dtype, out)
    if S == 0:
        return out
    for name, t in (("ids", ids), ("ends", ends)):
        if t.dtype not in _INDEX_DTYPES or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32 or int64, got "
                            f"{t.dtype}")
    if ends.shape != (S,):
        raise ValueError(f"ends {tuple(ends.shape)} vs {S} segments")
    if weights is not None and (weights.dtype != torch.float32
                                or not weights.is_contiguous()):
        raise TypeError("weights must be contiguous float32")
    facts, base = [], 0
    for start, cap, count in zip(starts, caps, counts):
        facts.append((start, cap, base, count))
        base += count
    lib = _native.load_library(_FLOAT_SOURCE)
    dev = table.device
    ld = out.stride(0) if S > 1 else D
    with torch.cuda.device(dev):
        for r0 in range(0, len(facts), _MAX_REGIONS):
            chunk = facts[r0:r0 + _MAX_REGIONS]
            if not any(f[3] for f in chunk):
                continue  # no example: nothing to write, no launch
            flat = [v for f in chunk for v in f]
            err = lib.tbe_pooled(
                table.data_ptr(), ids.data_ptr(),
                int(ids.dtype == torch.int64),
                None if weights is None else weights.data_ptr(),
                ends.data_ptr(), int(ends.dtype == torch.int64),
                (ctypes.c_longlong * len(flat))(*flat), len(chunk),
                out.data_ptr(), D, table.shape[0], LOOKUP_DTYPES[table.dtype],
                LOOKUP_DTYPES[out.dtype], ld, _stream_ptr(dev),
            )
            _native.check_launch("tbe_pooled", err)
            count_launch("pooled_lookup")
    return out


def pooled_kernel_info(dtype: torch.dtype, runs: bool, vec: bool,
                       ids_dtype: torch.dtype,
                       ends_dtype: torch.dtype,
                       out_dtype: Optional[torch.dtype] = None,
                       ) -> Dict[str, int]:
    """What the float pooled kernel's instantiation for a table of
    ``dtype`` pooling into ``out_dtype`` (the table's by default), the
    runs kernel (``runs``: several segments a warp) or the segments one,
    the 4-column (``vec``) or one-column path and the index types takes
    on the current card (builds the kernel): its ``registers`` a thread
    and ``blocks_per_sm`` resident."""
    lib = _native.load_library(_FLOAT_SOURCE)
    out = (ctypes.c_int * 2)()
    odt = dtype if out_dtype is None else out_dtype
    err = lib.tbe_pooled_info(LOOKUP_DTYPES[dtype], LOOKUP_DTYPES[odt],
                              int(runs), int(vec),
                              int(ids_dtype == torch.int64),
                              int(ends_dtype == torch.int64), out)
    if err:
        raise RuntimeError(f"tbe_pooled_info failed: CUDA error {err}")
    return dict(zip(("registers", "blocks_per_sm"), out))


def pooled_lookup(
    table: torch.Tensor,  # [R, D] float32, bfloat16 or float16
    ids: torch.Tensor,  # [V] integer
    segments: torch.Tensor,  # [V] integer; invalid outside [0, S)
    num_segments: int,
    weights: Optional[torch.Tensor] = None,  # [V] float32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Pooled lookup ``out[s] = sum_i w_i * table[id_i]`` over the valid
    slots of segment ``s`` in slot order, accumulated in float32; ids clip
    to the table, slots whose segment lies outside ``[0, num_segments)``
    add nothing.  Returns [num_segments, D] in ``out_dtype`` (the table's
    dtype by default; float32 from any table).  The segments may come in
    any order, so the card path sorts the slots first (no host sync); a
    stream in its producer's layout takes :func:`pooled_lookup_regions`
    and no sort."""
    dev = _check_float_inputs(table, ids, segments, weights)
    if dev.type == "cpu":
        return pooled_lookup_plain(table, ids, segments, num_segments,
                                   weights, out_dtype)
    _require_cuda(dev)
    sids, sw, offsets = sort_by_segment(
        ids, segments, weights, num_segments, table.shape[0]
    )
    if sids.dtype not in _INDEX_DTYPES:
        sids = sids.to(torch.int64)
    return launch_pooled(table, sids, sw, offsets[1:], (0,),
                         (ids.shape[0],), (num_segments,), out_dtype)


def pooled_lookup_regions(
    table: torch.Tensor,  # [R, D] float32, bfloat16 or float16
    ids: torch.Tensor,  # [V] integer
    regions: SlotRegions,
    weights: Optional[torch.Tensor] = None,  # [V] float32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The function of :func:`pooled_lookup` over a slot stream in its
    producer's layout: ``out[e]`` is the weighted sum of example ``e``'s
    slots (:class:`SlotRegions`) in slot order, ids clipped to the table.
    Returns [regions.num_segments, D] in ``out_dtype`` (the table's dtype
    by default; float32 from any table).  On the card: one cumsum of the
    lengths and one launch, ids and weights read as they come, no sort
    and no host sync."""
    dev = _check_regions(table, ids, regions, weights)
    if dev.type == "cpu":
        return pooled_lookup_regions_plain(table, ids, regions, weights,
                                           out_dtype)
    _require_cuda(dev)
    if regions.lengths.dtype not in _INDEX_DTYPES:
        raise TypeError("lengths must be int32 or int64 on the card")
    return launch_pooled(table, ids, weights, region_ends(regions.lengths),
                         regions.starts, regions.caps, regions.counts,
                         out_dtype)


def _count(name: str) -> None:
    """Count a launch of an eager call; a traced call (``torch.export``)
    launches nothing."""
    if not torch.compiler.is_compiling():
        count_launch(name)


def _tables(features: Sequence) -> Tuple[list, list, list]:
    return ([f.q for f in features], [f.scale for f in features],
            [f.bias for f in features])


def _slot_stream(q, scale, bias) -> Tuple[GroupFeature]:
    """A per-table call as a group of one: its segment-sorted slot stream
    is the one region, ``ends`` its CSR offsets past the first."""
    return (GroupFeature(q, scale, bias, key=0, col=0),)


def _launch_q8(features, cap_offsets, ids, w, ends, out) -> None:
    """B3 through ``trt::q8_pooled``: ``ends`` [K, B] int32."""
    custom_ops.load_ops()
    torch.ops.trt.q8_pooled(out, ids, w, ends, *_tables(features),
                            custom_ops.quant_facts(features, cap_offsets))
    _count("quant_pooled_lookup_int8")


def launch_q8_pooled(
    q: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    sids: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
) -> torch.Tensor:
    """Launch the int8 pooled kernel on prepared inputs (the output of
    :func:`sort_by_segment`), as a group of one; returns the [S, D]
    float32 output."""
    S, D = offsets.shape[0] - 1, q.shape[1]
    if S == 0:
        return torch.empty((0, D), dtype=torch.float32, device=q.device)
    V = sids.shape[0]
    out = torch.empty((S, D), dtype=torch.float32, device=q.device)
    _launch_q8(_slot_stream(q, scale, bias), (0, V),
               sids.to(torch.int64).contiguous(), sw.contiguous(),
               offsets[1:].to(torch.int32).view(1, S), out)
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
    Returns [num_segments, D] float32.  Segments may come in any order,
    so the card path sorts the slots first (no host sync)."""
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


def quant_pooled_lookup_int8_grouped(
    values: torch.Tensor,  # [sum caps] KJT values, per-key regions
    lengths: torch.Tensor,  # [K * B] key-major
    cap_offsets: Sequence[int],  # [K + 1] region bounds
    features: Sequence[GroupFeature],
    out: torch.Tensor,  # [B, sum D] float32, written in place
) -> torch.Tensor:
    """The int8 pooled lookup of every feature of a group in one launch:
    ``out[b, col_f : col_f + D]`` is example ``b`` of feature ``f`` (its
    region of the KeyedJaggedTensor's values, front-packed in example
    order; MEAN features weigh each id by ``1/len``).  Returns ``out``;
    no host sync."""
    dev, D = _check_group(values, lengths, cap_offsets, features, out, 8)
    if dev.type == "cpu":
        return quant_pooled_lookup_int8_grouped_plain(
            values, lengths, cap_offsets, features, out)
    _require_cuda(dev)
    B = out.shape[0]
    if B == 0:
        return out
    return launch_q8_grouped(features, cap_offsets, values.to(torch.int64),
                             group_ends(lengths, len(cap_offsets) - 1, B),
                             out)


def launch_q8_grouped(
    features: Sequence[GroupFeature],
    cap_offsets: Sequence[int],
    ids: torch.Tensor,
    ends: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """Launch the int8 pooled kernel for a group on prepared inputs (int64
    values and the :func:`group_ends` of the lengths); returns ``out``."""
    _launch_q8(features, cap_offsets, ids, None, ends, out)
    return out


def _launch_dedup_q(features, cap_offsets, bits, ukeys, inv, w, ends,
                    out) -> None:
    """Dedup launches 2 and 3 through ``trt::dedup_q_gather`` (the
    distinct rows into a scratch) and ``trt::dedup_q_pool`` (pooled
    through the inverse index); ``ends`` [K, B] int32."""
    custom_ops.load_ops()
    tables = _tables(features)
    facts = custom_ops.quant_facts(features, cap_offsets)
    rows = torch.ops.trt.dedup_q_gather(ukeys, *tables, facts, bits)
    torch.ops.trt.dedup_q_pool(out, inv, w, ends, rows, *tables, facts)
    _count("dedup_quant_pooled_lookup")


def launch_dedup_q(
    packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ukeys: torch.Tensor,
    inv: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
    bits: int,
) -> torch.Tensor:
    """Launch the dedup gather and pool kernels on prepared inputs (the
    output of :func:`dedup_prepare_sized`), as a group of one; returns
    [S, D] float32."""
    S, Dp = offsets.shape[0] - 1, packed.shape[1]
    D = Dp * (8 // bits)
    if S == 0:
        return torch.empty((0, D), dtype=torch.float32, device=packed.device)
    V = ukeys.shape[0]
    out = torch.empty((S, D), dtype=torch.float32, device=packed.device)
    _launch_dedup_q(_slot_stream(packed, scale, bias), (0, V), bits, ukeys,
                    inv, sw.contiguous(),
                    offsets[1:].to(torch.int32).view(1, S), out)
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
    [num_segments, D] float32; no host sync."""
    if bits not in (8, 4, 2):
        raise ValueError(f"unsupported packed width {bits}")
    dev = _check_inputs(packed, scale, bias, ids, segments, weights)
    if dev.type == "cpu":
        return dedup_quant_pooled_lookup_plain(
            packed, scale, bias, ids, segments, num_segments, weights, bits
        )
    _require_cuda(dev)
    ukeys, inv, sw, offsets = dedup_prepare_sized(
        ids, segments, weights, num_segments)
    return launch_dedup_q(packed, scale, bias, ukeys, inv, sw, offsets, bits)


def dedup_prepare_grouped(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[GroupFeature],
    B: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouped dedup lookup's preparation on the card: the ``ends``
    of :func:`group_ends`, the ``dedup_q_keys`` kernel's key per slot of
    ``values``, and :func:`sized_unique` over them.  Returns (ends, ukeys,
    inv); no host sync."""
    custom_ops.load_ops()
    ends = group_ends(lengths, len(cap_offsets) - 1, B)
    keys = torch.ops.trt.dedup_q_keys(
        values.to(torch.int64), ends, *_tables(features),
        custom_ops.quant_facts(features, cap_offsets))
    return (ends, *sized_unique(keys))


def launch_dedup_q_grouped(
    features: Sequence[GroupFeature],
    cap_offsets: Sequence[int],
    ends: torch.Tensor,
    ukeys: torch.Tensor,
    inv: torch.Tensor,
    out: torch.Tensor,
    bits: int,
) -> torch.Tensor:
    """Launch the dedup gather and pool kernels of a group on prepared
    inputs (the output of :func:`dedup_prepare_grouped`); returns
    ``out``."""
    _launch_dedup_q(features, cap_offsets, bits, ukeys, inv, None, ends, out)
    return out


def dedup_quant_pooled_lookup_grouped(
    values: torch.Tensor,  # [sum caps] KJT values, per-key regions
    lengths: torch.Tensor,  # [K * B] key-major
    cap_offsets: Sequence[int],  # [K + 1] region bounds
    features: Sequence[GroupFeature],
    out: torch.Tensor,  # [B, sum D] float32, written in place
    bits: int = 8,
) -> torch.Tensor:
    """The dedup lookup of every feature of a group in one grouped call
    (keys, gather and pool launches): the function of
    :func:`quant_pooled_lookup_int8_grouped` over int8/int4/int2 packed
    tables, each distinct (feature, id) row unpacked and dequantized once.
    Returns ``out``; no host sync."""
    dev, _ = _check_group(values, lengths, cap_offsets, features, out, bits)
    if dev.type == "cpu":
        return dedup_quant_pooled_lookup_grouped_plain(
            values, lengths, cap_offsets, features, out, bits)
    _require_cuda(dev)
    B = out.shape[0]
    if B == 0:
        return out
    ends, ukeys, inv = dedup_prepare_grouped(values, lengths, cap_offsets,
                                             features, B)
    return launch_dedup_q_grouped(features, cap_offsets, ends, ukeys, inv,
                                  out, bits)


def launch_dedup_pooled(
    table: torch.Tensor,
    ukeys: torch.Tensor,
    inv: torch.Tensor,
    sw: torch.Tensor,
    offsets: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the float dedup lookup kernel on prepared inputs (the output
    of :func:`dedup_prepare_sized`: int64 keys, indices and offsets,
    float32 weights; ``offsets`` may be any contiguous run of the CSR
    offsets, the segments it spans); returns [S, D] in ``out_dtype`` (the
    table's dtype by default; float32 from any table), rounded once in the
    kernel, written into ``out`` when given (rows may be wider).
    Allocates at most the output; no host sync."""
    S, D = offsets.shape[0] - 1, table.shape[1]
    out = _output(table, S, out_dtype, out)
    if S == 0:
        return out
    for name, t, dtype in (("ukeys", ukeys, torch.int64),
                           ("inv", inv, torch.int64),
                           ("offsets", offsets, torch.int64),
                           ("weights", sw, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dtype}, got "
                            f"{t.dtype}")
    lib = _native.load_library(_DEDUP_SOURCE)
    dev = table.device
    with torch.cuda.device(dev):
        err = lib.dedup_pooled(
            table.data_ptr(), ukeys.data_ptr(), inv.data_ptr(),
            sw.data_ptr(), offsets.data_ptr(), out.data_ptr(), S, D,
            table.shape[0], LOOKUP_DTYPES[table.dtype],
            LOOKUP_DTYPES[out.dtype], out.stride(0) if S > 1 else D,
            _stream_ptr(dev),
        )
    _native.check_launch("dedup_pooled", err)
    count_launch("dedup_pooled_lookup")
    return out


def dedup_pooled_lookup(
    table: torch.Tensor,  # [R, D] float32, bfloat16 or float16
    ids: torch.Tensor,  # [V] integer
    segments: torch.Tensor,  # [V] integer; invalid outside [0, S)
    num_segments: int,
    weights: Optional[torch.Tensor] = None,  # [V] float32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Ragged dedup pooled lookup: the same function as
    :func:`pooled_lookup` (bitwise, for every table and output dtype),
    computed over the sized sort-unique of the valid ids: every segment
    pooled through each slot's index into the distinct keys.  Returns
    [num_segments, D] in ``out_dtype`` (the table's dtype by default;
    float32 from any table).  On the card: one launch, no host sync."""
    dev = _check_float_inputs(table, ids, segments, weights)
    if dev.type == "cpu":
        return dedup_pooled_lookup_plain(table, ids, segments, num_segments,
                                         weights, out_dtype)
    _require_cuda(dev)
    ukeys, inv, sw, offsets = dedup_prepare_sized(
        ids, segments, weights, num_segments)
    return launch_dedup_pooled(table, ukeys, inv, sw, offsets, out_dtype)


# ---------------------------------------------------------------------------
# float tables grouped: every feature of a served batch
# ---------------------------------------------------------------------------


class FloatFeature(NamedTuple):
    """One feature of a grouped float lookup: its table (float32,
    bfloat16 or float16, read in place), the index of its key in the
    KeyedJaggedTensor, its first column in the [B, sum D] float32 output,
    and whether it pools by MEAN."""

    table: torch.Tensor  # [R, D]
    key: int
    col: int
    mean: bool = False


FLOAT_GROUP_KERNELS = ("tbe", "dedup")


def _check_float_group(values, lengths, cap_offsets, features, out, kernel):
    """Validate a grouped float lookup's arguments; returns their device
    and the features' common width D."""
    if kernel not in FLOAT_GROUP_KERNELS:
        raise ValueError(f"unknown float group kernel {kernel!r}")
    if not features:
        raise ValueError("a group has at least one feature")
    if out.dtype != torch.float32 or out.dim() != 2 or out.stride(1) != 1:
        raise TypeError(f"out must be a row-major 2-D float32 buffer, got "
                        f"{out.dtype} {tuple(out.shape)}")
    B, K = out.shape[0], len(cap_offsets) - 1
    if values.dim() != 1 or values.dtype not in _INDEX_DTYPES:
        raise TypeError("values must be a 1-D int32 or int64 tensor")
    if values.shape[0] != cap_offsets[-1] or values.shape[0] > _INT32_MAX:
        raise ValueError(f"values {tuple(values.shape)} vs regions ending at "
                         f"{cap_offsets[-1]}")
    if lengths.dim() != 1 or lengths.shape[0] != K * B or (
            lengths.dtype not in _INDEX_DTYPES):
        raise ValueError(f"lengths must be [{K} keys * {B}] int32 or int64, "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")
    dev, D = out.device, features[0].table.shape[1]
    for t in (values, lengths):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("values and lengths must be contiguous on the "
                             "output's device")
    for f in features:
        _check_float_table(f.table)
        if f.table.shape[1] != D:
            raise ValueError("a group's tables share one row width")
        if not 0 <= f.key < K or not 0 <= f.col <= out.shape[1] - D:
            raise ValueError(f"feature key {f.key} or column {f.col} out of "
                             f"range")
        if f.table.device != dev or not f.table.is_contiguous():
            raise ValueError("tables must be contiguous on the output's "
                             "device")
        if f.table.shape[0] > _INT32_MAX:
            raise ValueError("rows must fit in int32")
    return dev, D


def _feature_regions(lengths, cap_offsets, f, B) -> SlotRegions:
    """Feature ``f``'s key as one region of the KJT's slot stream."""
    lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
    return SlotRegions(lengths[f.key * B:(f.key + 1) * B], (lo,), (hi - lo,),
                       (B,))


def _slot_examples(ends: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] int64: the example of each slot of one key's region, whose
    examples' running ends are ``ends`` [B] int64 (example ``b`` owns the
    slots ``[ends[b-1], ends[b])``, cut at the cap); ``B`` for a slot no
    example owns.  The count of ends at or before each slot: a
    scatter-add of the ends (clipped to the cap) and a cumsum, static
    shapes and no searchsorted (whose Inductor lowering in torch 2.11
    refuses a view such as one key's row of ``ends``)."""
    marks = torch.zeros((cap + 1,), dtype=torch.int64, device=ends.device)
    marks.scatter_add_(0, ends.clamp(max=cap), torch.ones_like(ends))
    return torch.cumsum(marks[:cap], 0)


def _group_segments(values, lengths, cap_offsets, features, B):
    """[V] int64: each slot of the group's features is segment ``key * B
    + example``; every other slot is the sentinel ``K * B``."""
    K = len(cap_offsets) - 1
    ends = group_ends(lengths, K, B).to(torch.int64)
    seg = torch.full(values.shape, K * B, dtype=torch.int64,
                     device=values.device)
    for f in features:
        lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
        b = _slot_examples(ends[f.key], hi - lo)
        seg[lo:hi] = torch.where(b < B, b + f.key * B, K * B)
    return seg


def _group_mean_weights(values, lengths, cap_offsets, features, B):
    """[V] float32 slot weights, ``1/len`` of each MEAN feature's
    example (``__fdiv_rn``) and 1 elsewhere; None when no feature pools
    by MEAN."""
    means = [f for f in features if f.mean]
    if not means:
        return None
    ends = group_ends(lengths, len(cap_offsets) - 1, B).to(torch.int64)
    w = torch.ones(values.shape, dtype=torch.float32, device=values.device)
    for f in means:
        lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
        f_len = lengths[f.key * B:(f.key + 1) * B]
        inv = torch.where(f_len > 0,
                          1.0 / f_len.clamp(min=1).to(torch.float32), 0.0)
        w[lo:hi] = torch.cat([inv, inv.new_zeros(1)])[
            _slot_examples(ends[f.key], hi - lo)]
    return w


def float_pooled_lookup_grouped_plain(
    values: torch.Tensor,
    lengths: torch.Tensor,
    cap_offsets: Sequence[int],
    features: Sequence[FloatFeature],
    out: torch.Tensor,
    kernel: str = "tbe",
) -> torch.Tensor:
    """Plain version of :func:`float_pooled_lookup_grouped`: per feature
    the plain version of B1 over its key's region (``kernel="tbe"``) or of
    B4 over its slots (``"dedup"``), into float32, written to ``out[:,
    col : col + D]``.  Traced (``torch.export``), both kernels' plain
    versions are one static-shape gather and pool of each feature's slots
    (B4's function is B1's)."""
    B = out.shape[0]
    if B == 0:
        return out
    if torch.compiler.is_compiling():
        def slot_row(i, f, pos):
            r = values[pos].to(torch.int64).clamp(0, f.table.shape[0] - 1)
            return f.table[r].to(torch.float32)

        return _grouped_pool_static(values, lengths, cap_offsets, features,
                                    out, slot_row)
    w = _group_mean_weights(values, lengths, cap_offsets, features, B)
    seg = (_group_segments(values, lengths, cap_offsets, features, B)
           if kernel == "dedup" else None)
    for f in features:
        D = f.table.shape[1]
        if kernel == "tbe":
            res = pooled_lookup_regions_plain(
                f.table, values, _feature_regions(lengths, cap_offsets, f, B),
                w, torch.float32)
        else:
            res = dedup_pooled_lookup_plain(
                f.table, values, seg - f.key * B, B, w, torch.float32)
        out[:, f.col:f.col + D] = res
    return out


def float_pooled_lookup_grouped(
    values: torch.Tensor,  # [V] int32 or int64, the KJT's values
    lengths: torch.Tensor,  # [K * B] int32 or int64
    cap_offsets: Sequence[int],  # [K + 1]
    features: Sequence[FloatFeature],
    out: torch.Tensor,  # [B, W] float32
    kernel: str = "tbe",
) -> torch.Tensor:
    """Every feature of a served batch over float32 / bfloat16 / float16
    tables, each pooled (SUM, or MEAN by ``1/len`` weights) into float32
    straight into its columns ``out[:, col : col + D]`` of the
    KeyedTensor's buffer, the 16-bit tables read in place.  ``"tbe"``: one
    cumsum of the lengths for the group, then one B1 launch a feature over
    its key's region; ``"dedup"``: one sized sort-unique of the group's
    slots, then one B4 launch a feature over its segments' offsets.  No
    cast kernel and no host sync.  Returns ``out``."""
    dev, D = _check_float_group(values, lengths, cap_offsets, features, out,
                                kernel)
    if dev.type == "cpu":
        return float_pooled_lookup_grouped_plain(
            values, lengths, cap_offsets, features, out, kernel)
    _require_cuda(dev)
    B, K = out.shape[0], len(cap_offsets) - 1
    if B == 0:
        return out
    custom_ops.load_ops()
    w = _group_mean_weights(values, lengths, cap_offsets, features, B)
    if kernel == "tbe":
        ends = group_ends(lengths, K, B)
        for f in features:
            lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
            torch.ops.trt.tbe_pooled(out, f.table, values, w, ends,
                                     [lo, hi - lo, f.key, f.col])
            _count("pooled_lookup")
        return out
    seg = _group_segments(values, lengths, cap_offsets, features, B)
    ukeys, inv, sw, offsets = dedup_prepare_sized(values, seg, w, K * B)
    for f in features:
        torch.ops.trt.dedup_pooled(out, f.table, ukeys, inv, sw, offsets,
                                   [f.key, f.col])
        _count("dedup_pooled_lookup")
    return out
