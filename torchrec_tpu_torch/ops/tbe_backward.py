"""The fused embedding backward + rowwise-Adagrad kernel for Hopper, its
wrapper and its plain PyTorch version.

Replaces, from the JAX package's ``torchrec_tpu/ops/pallas_tbe_backward.py``,
``pallas_fused_sparse_update`` with ``optim="rowwise_adagrad"`` (kernel
body ``_bwd_body``, input preparation ``_sort_by_row``, noise
``_hash_bits``) by :func:`fused_sparse_update`.  The other seven
optimizers of that kernel (adagrad, sgd, lars_sgd, adam, lamb,
partial_rowwise_adam, partial_rowwise_lamb) and its dedup body
(``pallas_dedup_fused_sparse_update``) are not ported yet.

The kernel is CUDA C++ in ``torchrec_tpu_torch/csrc/tbe_backward.cu`` (its
header says what bounds it and how it is laid out), built and loaded by
``ops/_native.py``.  The wrapper checks devices, dtypes, shapes and
contiguity; on CPU tensors it runs the plain version and launches nothing;
on CUDA tensors it launches the kernel or raises (no fallback), and adds
one to ``_native.LAUNCHES["fused_sparse_update"]`` per launch.  An empty batch
is the identity and launches nothing.  Table and momentum are updated in
place (the JAX kernel aliases them to its outputs, which the caller
donates).

The plain version sums each row's gradient in slot order, reduces
``mean(g * g)`` in the kernel's fixed lane/butterfly order and rounds every
operation separately, so on the card the kernel and the plain version are
bitwise equal.  Against the JAX kernel it agrees to a tolerance: its mean
reduces in an order XLA does not pin down.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.ops._native import FLOAT_DTYPES, count_launch

_SOURCE = "tbe_backward.cu"
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_U32 = 0xFFFFFFFF
_F32_MAX = float(torch.finfo(torch.float32).max)
MAX_DIM = 512  # the kernel keeps at most 16 columns per lane in registers

Scalar = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# the stochastic-rounding noise (``_hash_bits``), in int64 arithmetic
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` without int64
    overflow: the product is split at bit 16."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def hash_bits(seed: int, rows: torch.Tensor, dim: int) -> torch.Tensor:
    """``_hash_bits`` of the JAX package: per (seed, row, column) uniform
    32-bit values, as int64 ``[len(rows), dim]`` in ``[0, 2**32)``.  The
    seed is an int32 (negative seeds wrap as uint32 does)."""
    col = torch.arange(dim, dtype=torch.int64, device=rows.device)
    s = _mul32(torch.tensor(seed & _U32, dtype=torch.int64,
                            device=rows.device), 0x9E3779B9)
    r = _mul32(rows.to(torch.int64) & _U32, 0x85EBCA6B)
    x = col[None, :] ^ s ^ r[:, None]
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def round_to_bf16(
    x: torch.Tensor, rows: torch.Tensor, sr_seed: Optional[int]
) -> torch.Tensor:
    """float32 ``[U, D]`` rows -> bfloat16.  Without a seed, round to
    nearest even; with one, add the hash noise of (seed, row, column) to
    the 16 bits that bfloat16 drops before cutting them
    (``pallas_tbe_backward.py:294-306``).  Non-finite values pass through
    and round to nearest."""
    if sr_seed is None:
        return x.to(torch.bfloat16)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    noise = hash_bits(sr_seed, rows, x.shape[1]) & 0xFFFF
    u = (bits + noise) & 0xFFFF0000
    sr = torch.where(u > _INT32_MAX, u - 2**32, u).to(torch.int32)
    sr = sr.view(torch.float32)
    return torch.where(x.abs() <= _F32_MAX, sr, x).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# input preparation (shared by the kernel and the plain version)
# ---------------------------------------------------------------------------


def sort_by_row(
    ids: torch.Tensor,
    valid: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_rows: int,
    num_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_sort_by_row`` of the JAX package, without its chunk padding: a
    slot is kept where ``valid`` holds and its segment and row lie in
    range; rows are ``where(ok, id, num_rows)``, sorted stably, and the
    segments and weights follow the same order (0 for dropped slots).
    Returns int32 rows, int32 segments and float32 weights; no host
    sync."""
    ok = (
        valid
        & (segments >= 0)
        & (segments < num_segments)
        & (ids >= 0)
        & (ids < num_rows)
    )
    rows = torch.where(ok, ids, num_rows).to(torch.int32)
    order = torch.argsort(rows, stable=True)
    w = (
        torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
        if weights is None
        else weights
    )
    ssegs = torch.where(ok, segments, 0).to(torch.int32)[order]
    sw = torch.where(ok, w, 0.0)[order]
    return rows[order], ssegs, sw


def lane_columns(dim: int, device=None) -> torch.Tensor:
    """[32, K] the columns each lane of the kernel's warp owns, in the
    order it sums them (``dim`` where a lane has none): 4 consecutive
    columns per 128-column block when ``dim % 4 == 0``, else one column
    per 32."""
    lane = torch.arange(32, device=device)[:, None]
    if dim % 4 == 0:
        k = torch.arange(((dim + 127) // 128) * 4, device=device)[None, :]
        col = (k // 4) * 128 + lane * 4 + k % 4
    else:
        k = torch.arange((dim + 31) // 32, device=device)[None, :]
        col = lane + 32 * k
    return torch.where(col < dim, col, dim)


def mean_of_squares(g: torch.Tensor) -> torch.Tensor:
    """``mean(g * g, axis=1)`` of float32 ``[U, D]`` in the kernel's order:
    each lane sums the squares of its columns in ascending order, the 32
    lane sums meet in an xor butterfly (16, 8, 4, 2, 1), and the total is
    divided by D."""
    U, D = g.shape
    sq = torch.cat([g * g, g.new_zeros((U, 1))], dim=1)
    parts = sq[:, lane_columns(D, g.device)]  # [U, 32, K]
    s = g.new_zeros((U, 32))
    for k in range(parts.shape[2]):
        s = s + parts[:, :, k]
    lane = torch.arange(32, device=g.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    # a tensor divisor: a scalar one would make the card multiply by its
    # reciprocal, which rounds differently from the kernel's division
    return s[:, 0] / torch.full_like(s[:, 0], D)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _f32(x: Scalar, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def fused_sparse_update_plain(
    table: torch.Tensor,
    momentum: torch.Tensor,
    ids: torch.Tensor,
    valid: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    grad_seg: torch.Tensor,
    learning_rate: Scalar,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    sr_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_sparse_update`.  It walks the row
    runs by position, longest runs first, so each pass adds one slot to
    every run still open and works on ``[runs open, D]`` (never a
    ``[U, Lmax, D]`` pad); one host sync reads the run lengths."""
    R, D = table.shape
    dev = table.device
    srows, ssegs, sw = sort_by_row(ids, valid, segments, weights, R,
                                   grad_seg.shape[0])
    rows = srows[srows < R]
    n = rows.shape[0]
    if n == 0:
        return table, momentum
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = rows[1:] != rows[:-1]
    starts = torch.nonzero(first).flatten()
    lengths = torch.diff(starts, append=starts.new_tensor([n]))
    order = torch.argsort(lengths, descending=True, stable=True)
    starts, lengths = starts[order], lengths[order]
    urows = rows[starts].to(torch.int64)
    open_runs = torch.bincount(lengths.cpu()).flip(0).cumsum(0).flip(0)
    g = torch.zeros((urows.shape[0], D), dtype=torch.float32, device=dev)
    for j in range(1, open_runs.shape[0]):
        k = int(open_runs[j])  # runs with more than j - 1 slots
        pos = starts[:k] + (j - 1)
        g[:k] = g[:k] + grad_seg[ssegs[pos].to(torch.int64)] * sw[pos][:, None]

    w = table[urows].to(torch.float32)
    if weight_decay:
        g = g + _f32(weight_decay, dev) * w
    m_new = momentum[urows] + mean_of_squares(g)
    scale = -_f32(learning_rate, dev) / (torch.sqrt(m_new) + _f32(eps, dev))
    new = w + scale[:, None] * g
    if table.dtype == torch.bfloat16:
        table[urows] = round_to_bf16(new, urows, sr_seed)
    else:
        table[urows] = new
    momentum[urows] = m_new
    return table, momentum


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _check_inputs(
    table: torch.Tensor,
    momentum: torch.Tensor,
    ids: torch.Tensor,
    valid: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    grad_seg: torch.Tensor,
    sr_seed: Optional[int],
) -> torch.device:
    """Validate an update's arguments; returns their common device."""
    tensors = [table, momentum, ids, valid, segments, grad_seg]
    if weights is not None:
        tensors.append(weights)
    dev = table.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"update inputs span devices {dev} and "
                             f"{t.device}")
    if table.dtype not in FLOAT_DTYPES or table.dim() != 2:
        raise TypeError(f"table must be 2-D float32 or bfloat16, got "
                        f"{table.dtype} {tuple(table.shape)}")
    R, D = table.shape
    if momentum.dtype != torch.float32 or tuple(momentum.shape) != (R,):
        raise TypeError(f"momentum must be float32 [{R}], got "
                        f"{momentum.dtype} {tuple(momentum.shape)}")
    if grad_seg.dtype != torch.float32 or grad_seg.dim() != 2 or (
        grad_seg.shape[1] != D
    ):
        raise TypeError(f"grad_seg must be float32 [S, {D}], got "
                        f"{grad_seg.dtype} {tuple(grad_seg.shape)}")
    if ids.dim() != 1 or segments.shape != ids.shape or (
        valid.shape != ids.shape
    ):
        raise ValueError("ids, valid and segments must be equal 1-D shapes")
    if ids.dtype.is_floating_point or segments.dtype.is_floating_point:
        raise TypeError("ids and segments must be integer tensors")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be a bool tensor")
    if weights is not None and (
        weights.dtype != torch.float32 or weights.shape != ids.shape
    ):
        raise TypeError(f"weights must be float32 {tuple(ids.shape)}")
    if R >= _INT32_MAX or ids.shape[0] > _INT32_MAX or (
        grad_seg.shape[0] > _INT32_MAX
    ):
        raise ValueError("rows, slots and segments must each fit in int32")
    if sr_seed is not None and not _INT32_MIN <= sr_seed <= _INT32_MAX:
        raise ValueError(f"sr_seed {sr_seed} is not an int32")
    if not table.is_contiguous() or not momentum.is_contiguous():
        raise ValueError("table and momentum are updated in place and "
                         "must be contiguous")
    return dev


def launch_fused_sparse_update(
    table: torch.Tensor,
    momentum: torch.Tensor,
    srows: torch.Tensor,
    ssegs: torch.Tensor,
    sw: torch.Tensor,
    grad_seg: torch.Tensor,
    learning_rate: Scalar,
    eps: float,
    weight_decay: float,
    sr_seed: Optional[int],
) -> None:
    """Launch the kernel on prepared inputs (the output of
    :func:`sort_by_row`, at least one slot); updates table and momentum in
    place."""
    R, D = table.shape
    if D > MAX_DIM:
        raise ValueError(f"the fused update kernel takes D <= {MAX_DIM}, "
                         f"got {D}")
    lib = _native.load_library(_SOURCE)
    grad = grad_seg.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()  # the kernel's float4 loads need 16 bytes
    srows = srows.contiguous()
    ssegs = ssegs.contiguous()
    sw = sw.contiguous()
    use_sr = table.dtype == torch.bfloat16 and sr_seed is not None
    with torch.cuda.device(table.device):
        err = lib.fused_rowwise_adagrad(
            srows.data_ptr(), ssegs.data_ptr(), sw.data_ptr(),
            grad.data_ptr(), table.data_ptr(), momentum.data_ptr(),
            srows.shape[0], R, D, float(learning_rate), float(eps),
            float(weight_decay), FLOAT_DTYPES[table.dtype], int(use_sr),
            int(sr_seed) if use_sr else 0,
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    _native.check_launch("fused_rowwise_adagrad", err)
    count_launch("fused_sparse_update")


def fused_sparse_update(
    table: torch.Tensor,  # [R, D] float32 or bfloat16, updated in place
    momentum: torch.Tensor,  # [R] float32, updated in place
    ids: torch.Tensor,  # [V] table-local row ids
    valid: torch.Tensor,  # [V] bool
    segments: torch.Tensor,  # [V] the grad_seg row each slot pooled into
    weights: Optional[torch.Tensor],  # [V] float32 or None
    grad_seg: torch.Tensor,  # [S, D] float32 upstream pooled gradient
    learning_rate: Scalar,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    sr_seed: Optional[int] = None,  # int32; bfloat16 tables only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass fused backward + rowwise Adagrad: for each distinct row
    among the kept slots (``valid``, segment in ``[0, S)``, row in
    ``[0, R)``), ``g = sum_i w_i * grad_seg[seg_i]`` in slot order (plus
    ``weight_decay * w``), ``m += mean(g * g)``, ``w += (-lr / (sqrt(m) +
    eps)) * g``.  A bfloat16 table is written back with stochastic rounding
    when ``sr_seed`` is given.  Returns ``(table, momentum)``, the inputs
    themselves, updated in place."""
    dev = _check_inputs(table, momentum, ids, valid, segments, weights,
                        grad_seg, sr_seed)
    if dev.type == "cpu":
        return fused_sparse_update_plain(
            table, momentum, ids, valid, segments, weights, grad_seg,
            learning_rate, eps, weight_decay, sr_seed,
        )
    if dev.type != "cuda":
        raise ValueError(f"the fused update kernel runs on CUDA tensors "
                         f"(CPU tensors take the plain version); got {dev}")
    if ids.shape[0] == 0:
        return table, momentum
    srows, ssegs, sw = sort_by_row(ids, valid, segments, weights,
                                   table.shape[0], grad_seg.shape[0])
    launch_fused_sparse_update(table, momentum, srows, ssegs, sw, grad_seg,
                               learning_rate, eps, weight_decay, sr_seed)
    return table, momentum
