"""The fused embedding backward + optimizer kernels for Hopper, their
wrappers and their plain PyTorch versions.

Replace, from the JAX package's ``torchrec_tpu/ops/pallas_tbe_backward.py``:

* ``pallas_fused_sparse_update`` (kernel body ``_bwd_body``, input
  preparation ``_sort_by_row``, noise ``_hash_bits``) by
  :func:`fused_sparse_update` (B2, ``csrc/tbe_backward.cu``), for all eight
  optimizers in ``_bwd_body``'s own op order.
* ``pallas_dedup_fused_sparse_update`` (``pallas_fused_sparse_update(
  dedup=True)``, kernel body ``_dedup_bwd_body``) by
  :func:`dedup_fused_sparse_update` (B6, ``csrc/tbe_dedup_backward.cu``),
  for all eight optimizers in the XLA path's op order.  Its ``id_cap``
  sizes the TPU kernel's grid and has no counterpart: the port's grid
  covers the slots it is given.

The kernels' headers say what bounds them and how they are laid out;
``ops/_native.py`` builds and loads them.  Each wrapper checks devices,
dtypes, shapes and contiguity; on CPU tensors it runs its plain version
and launches nothing; on CUDA tensors it launches the kernel or raises (no
fallback), and adds one to its count in ``_native.LAUNCHES`` per launch.
An empty batch is the identity and launches nothing.  Table and optimizer
states are updated in place (the JAX kernels alias them to their outputs,
which the caller donates).

The plain versions sum each row's gradient in slot order, reduce every
mean and norm over D in the kernels' fixed lane/butterfly order and round
every operation separately, so on the card each kernel and its plain
version are bitwise equal.  Both run the optimizer step of
:func:`update_rows`, in the op order of their JAX kernel, which differs in
two places: B2 scales rowwise Adagrad's gradient by ``(-lr) / (sqrt(m) +
eps)`` and rounds the Adam family's ``1 - beta`` in float32 from the
float32 beta, as ``_bwd_body`` does; B6 follows ``apply_sparse_update``.
B2's plain version agrees with the JAX kernel to a tolerance (its means
and norms reduce in an order XLA does not pin down); B6's is
``embedding_row_grads`` + ``aggregate_duplicate_rows`` + the optimizer
math of the JAX package's ``apply_sparse_update``.

The optimizer states may be float32, bfloat16 or float16
(``FusedOptimConfig.momentum_dtype``; :data:`STATE_DTYPES`): read and
widened to float32, stored rounded to nearest after the step has used the
float32 value, and the Adam family's ``b * m`` computed in the state's
dtype as the JAX package's XLA update does (:func:`_decay`), which is the
reference here, since its Pallas kernels take a float32 state only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.ops._native import (
    FLOAT_DTYPES,
    STATE_DTYPES,
    count_launch,
)
from torchrec_tpu_torch.ops.embedding_ops import (
    aggregate_duplicate_rows,
    embedding_row_grads,
    run_sums,
)

_SOURCE = "tbe_backward.cu"
_DEDUP_SOURCE = "tbe_dedup_backward.cu"
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_U32 = 0xFFFFFFFF
_F32_MAX = float(torch.finfo(torch.float32).max)
MAX_DIM = 512  # the kernel keeps at most 16 columns per lane in registers
# the kernels' column layouts (backward_common.cuh::Layout), by code
LAYOUTS = ("narrow", "wide", "scalar")

Scalar = Union[float, torch.Tensor]

# the fused optimizers, in the order of the B6 kernel's codes, and the
# layout of each one's state arrays: "row" is [R], "col" is [R, D]
OPTIMIZERS = (
    "sgd", "lars_sgd", "adagrad", "rowwise_adagrad", "adam",
    "partial_rowwise_adam", "lamb", "partial_rowwise_lamb",
)
STATE_LAYOUTS = {
    "sgd": (), "lars_sgd": (), "adagrad": ("col",),
    "rowwise_adagrad": ("row",),
    "adam": ("col", "col"), "lamb": ("col", "col"),
    "partial_rowwise_adam": ("col", "row"),
    "partial_rowwise_lamb": ("col", "row"),
}


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


def column_layout(dim: int) -> Tuple[str, int]:
    """The kernels' instantiation for a table of width ``dim``: its column
    layout and the columns a lane keeps in registers.  ``("narrow", 4)``
    for ``dim <= 128`` with ``dim % 4 == 0`` (one float4 a lane),
    ``("wide", 16)`` for any other ``dim % 4 == 0`` and ``("scalar", 16)``
    else; the lanes own the columns of :func:`lane_columns` in each.
    Raises for ``dim`` past :data:`MAX_DIM`."""
    if dim > MAX_DIM:
        raise ValueError(f"the fused update kernels take D <= {MAX_DIM}, "
                         f"got {dim}")
    if dim % 4:
        return "scalar", 16
    return ("narrow", 4) if dim <= 128 else ("wide", 16)


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """``sum(x * x, axis=1)`` of float32 ``[U, D]`` in the kernels' order:
    each lane sums the squares of its columns in ascending order, then
    the 32 lane sums meet in an xor butterfly (16, 8, 4, 2, 1)."""
    U, D = x.shape
    sq = torch.cat([x * x, x.new_zeros((U, 1))], dim=1)
    parts = sq[:, lane_columns(D, x.device)]  # [U, 32, K]
    s = x.new_zeros((U, 32))
    for k in range(parts.shape[2]):
        s = s + parts[:, :, k]
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    return s[:, 0]


def _div(a: torch.Tensor, b: Scalar) -> torch.Tensor:
    """``a / b`` as a division of tensors of ``a``'s shape: with a scalar
    divisor the card multiplies by its reciprocal, which rounds
    differently from the kernels' division."""
    if isinstance(b, torch.Tensor):
        return a / b.expand_as(a)
    return a / torch.full_like(a, b)


def mean_of_squares(g: torch.Tensor) -> torch.Tensor:
    """``mean(g * g, axis=1)`` of float32 ``[U, D]`` in the kernels' order:
    :func:`sum_of_squares` divided by D."""
    return _div(sum_of_squares(g), g.shape[1])


# ---------------------------------------------------------------------------
# argument checks (both wrappers)
# ---------------------------------------------------------------------------


def _check_inputs(
    table: torch.Tensor,
    states: Sequence[torch.Tensor],
    layout: Sequence[str],
    ids: torch.Tensor,
    valid: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    grad_seg: torch.Tensor,
    sr_seed: Optional[int],
) -> torch.device:
    """Validate an update's arguments (``states`` in ``layout``: "row"
    ``[R]``, "col" ``[R, D]``, all of one of :data:`STATE_DTYPES`);
    returns their common device."""
    tensors = [table, *states, ids, valid, segments, grad_seg]
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
    if len(states) != len(layout):
        raise ValueError(f"{len(states)} optimizer states, want "
                         f"{len(layout)}")
    for st, kind in zip(states, layout):
        shape = (R,) if kind == "row" else (R, D)
        if st.dtype not in STATE_DTYPES or tuple(st.shape) != shape:
            raise TypeError(f"optimizer state must be float32, bfloat16 or "
                            f"float16 {shape}, got {st.dtype} "
                            f"{tuple(st.shape)}")
        if st.dtype != states[0].dtype:
            raise TypeError(f"optimizer states of two dtypes: "
                            f"{states[0].dtype} and {st.dtype}")
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
    if not all(t.is_contiguous() for t in (table, *states)):
        raise ValueError("table and optimizer states are updated in place "
                         "and must be contiguous")
    return dev


def _require_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the fused update kernels run on CUDA tensors (CPU "
                         f"tensors take the plain versions); got {dev}")


def _aligned_grad(grad_seg: torch.Tensor) -> torch.Tensor:
    grad = grad_seg.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()  # the kernels' float4 loads need 16 bytes
    return grad


# (device index, stream handle) -> the work queue of the kernels' grid: two
# int32 counters, zeroed once; every launch leaves them at 0 again
_QUEUES: Dict[Tuple[int, int], torch.Tensor] = {}


def _work_queue(dev: torch.device) -> Tuple[int, int]:
    """(queue pointer, stream handle) for a launch on the current stream
    of ``dev``.  One queue per stream: launches on one stream never
    overlap, so the counters one leaves at 0 are the next one's start."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    q = _QUEUES.get(key)
    if q is None:
        q = _QUEUES[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return q.data_ptr(), stream


def _launch(
    source: str,
    entry: str,
    table: torch.Tensor,
    states: Sequence[torch.Tensor],
    srows: torch.Tensor,
    ssegs: torch.Tensor,
    sw: torch.Tensor,
    grad_seg: torch.Tensor,
    optim: str,
    hyper: Sequence[float],
    sr_seed: Optional[int],
) -> None:
    """Launch B2 or B6 (``entry`` of ``source``) on prepared inputs with
    the scalar ``hyper``-parameters of its C entry point."""
    R, D = table.shape
    column_layout(D)  # raises past MAX_DIM
    lib = _native.load_library(source)
    grad = _aligned_grad(grad_seg)
    srows, ssegs, sw = srows.contiguous(), ssegs.contiguous(), sw.contiguous()
    ptrs = [st.data_ptr() for st in states] + [0] * (2 - len(states))
    use_sr = table.dtype == torch.bfloat16 and sr_seed is not None
    sdtype = STATE_DTYPES[states[0].dtype] if states else 0
    with torch.cuda.device(table.device):
        queue, stream = _work_queue(table.device)
        err = getattr(lib, entry)(
            srows.data_ptr(), ssegs.data_ptr(), sw.data_ptr(),
            grad.data_ptr(), table.data_ptr(), ptrs[0], ptrs[1], queue,
            srows.shape[0], R, D, OPTIMIZERS.index(optim),
            *(float(x) for x in hyper), FLOAT_DTYPES[table.dtype], sdtype,
            int(use_sr), int(sr_seed) if use_sr else 0, stream,
        )
    _native.check_launch(entry, err)


def update_launch(kernel: str, optim: str, dtype: torch.dtype, dim: int,
                  slots: int = 0,
                  state_dtype: torch.dtype = torch.float32
                  ) -> Dict[str, object]:
    """What the launch of B2 (``kernel="fused_sparse_update"``) or B6
    (``"dedup_fused_sparse_update"``) with ``optim`` over a table of
    ``dtype`` and width ``dim``, its state of ``state_dtype``, and
    ``slots`` sorted positions takes on the current card (builds the
    kernel): the instantiation's ``registers`` a thread and column
    ``layout`` (:func:`column_layout`), the grid's ``blocks`` and the
    ``blocks_per_sm`` resident."""
    source, entry = {
        "fused_sparse_update": (_SOURCE, "fused_update_info"),
        "dedup_fused_sparse_update": (_DEDUP_SOURCE,
                                      "dedup_fused_update_info"),
    }[kernel]
    lib = _native.load_library(source)
    out = (ctypes.c_int * 4)()
    err = getattr(lib, entry)(OPTIMIZERS.index(optim), FLOAT_DTYPES[dtype],
                              STATE_DTYPES[state_dtype], int(dim),
                              int(slots), out)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return {"registers": out[0], "blocks": out[1], "blocks_per_sm": out[2],
            "layout": LAYOUTS[out[3]]}


# ---------------------------------------------------------------------------
# the optimizer step of both plain versions
# ---------------------------------------------------------------------------


def _f32(x: Scalar, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _decay(b: float, s: torch.Tensor) -> torch.Tensor:
    """``b * s`` for state values ``s`` read in their own dtype, as
    float32: the float32 product for a float32 state; for a 16-bit state
    the JAX package's arithmetic, where a weakly typed Python ``b`` times
    a bfloat16 / float16 array is computed in that dtype with ``b``
    rounded to it first (``0.999`` is ``1.0`` in bfloat16, so ``v`` never
    decays): the product of the two rounded to the state's dtype
    (``csrc/backward_common.cuh::decay``)."""
    if s.dtype == torch.float32:
        return _f32(b, s.device) * s
    return (_f32(b, s.device).to(s.dtype) * s).to(torch.float32)


def _trust_ratio(a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """``a / max(b, 1e-12)`` per row where both norms are positive, else
    1 (lars_sgd's ``||w|| / ||g||``, lamb's ``||w|| / ||dir||``)."""
    floor = torch.full_like(b_norm, 1e-12)
    return torch.where((a_norm > 0) & (b_norm > 0),
                       a_norm / torch.maximum(b_norm, floor),
                       torch.ones_like(a_norm))


def update_rows(
    optim: str,
    table: torch.Tensor,
    states: Sequence[torch.Tensor],
    rows: torch.Tensor,
    g: torch.Tensor,
    learning_rate: Scalar,
    eps: float,
    weight_decay: float,
    betas: Tuple[float, float],
    bias_corrections: Tuple[float, float],
    sr_seed: Optional[int],
    per_id: bool = False,
) -> None:
    """One optimizer step on the distinct ``rows`` [U] with their summed
    float32 gradients ``g`` [U, D], in place, with every operation
    rounded on its own (a 16-bit state read and widened, the step computed
    in float32 from the unrounded new state, which is stored rounded to
    nearest; the Adam family's ``b * m`` by :func:`_decay`): weight decay ``g + wd * w``, then the optimizer's
    math (``csrc/backward_common.cuh::update_row`` lists it), then ``w +
    delta`` written back (a bfloat16 table stochastically rounded when
    ``sr_seed`` is given).  Means and norms over D reduce in the kernels'
    order (:func:`sum_of_squares`); ``bias_corrections`` are the host's
    ``(1 - b1**t, 1 - b2**t)`` for the adam family.  The op order is the
    JAX package's ``apply_sparse_update`` (B6's), or with ``per_id`` that
    of ``_bwd_body`` (B2's): rowwise Adagrad's ``((-lr) / (sqrt(m) +
    eps)) * g`` and ``1 - beta`` rounded in float32 (``apply_sparse_update``
    rounds it from a double)."""
    dev, D = table.device, table.shape[1]
    w = table[rows].to(torch.float32)
    if weight_decay:
        g = g + _f32(weight_decay, dev) * w
    neg_lr = -_f32(learning_rate, dev)
    if optim == "sgd":
        delta = neg_lr * g
    elif optim == "lars_sgd":
        t = _trust_ratio(torch.sqrt(sum_of_squares(w)),
                         torch.sqrt(sum_of_squares(g)))
        delta = (neg_lr * t)[:, None] * g
    elif optim == "adagrad":
        m = states[0][rows] + g * g
        delta = (neg_lr * g) / (torch.sqrt(m) + _f32(eps, dev))
        states[0][rows] = m.to(states[0].dtype)
    elif optim == "rowwise_adagrad":
        m = states[0][rows] + mean_of_squares(g)
        den = torch.sqrt(m) + _f32(eps, dev)
        if per_id:
            delta = (neg_lr / den)[:, None] * g
        else:
            delta = (neg_lr * g) * _div(torch.ones_like(m), den)[:, None]
        states[0][rows] = m.to(states[0].dtype)
    else:  # the adam family
        (b1, b2), (bc1, bc2) = betas, bias_corrections
        if per_id:
            omb1 = _f32(1.0, dev) - _f32(b1, dev)
            omb2 = _f32(1.0, dev) - _f32(b2, dev)
        else:
            omb1, omb2 = _f32(1.0 - b1, dev), _f32(1.0 - b2, dev)
        m = _decay(b1, states[0][rows]) + omb1 * g
        sqbc2 = torch.sqrt(_f32(bc2, dev))
        if optim.startswith("partial_rowwise"):
            v = _decay(b2, states[1][rows]) + omb2 * mean_of_squares(g)
            vpe = _div(torch.sqrt(v), sqbc2) + _f32(eps, dev)
            direction = _div(m, bc1) / vpe[:, None].expand_as(m)
        else:
            v = _decay(b2, states[1][rows]) + (omb2 * g) * g
            vpe = _div(torch.sqrt(v), sqbc2) + _f32(eps, dev)
            direction = _div(m, bc1) / vpe
        if optim.endswith("lamb"):
            t = _trust_ratio(torch.sqrt(sum_of_squares(w)),
                             torch.sqrt(sum_of_squares(direction)))
            direction = direction * t[:, None]
        delta = neg_lr * direction
        states[0][rows] = m.to(states[0].dtype)
        states[1][rows] = v.to(states[1].dtype)
    new = w + delta
    if table.dtype == torch.bfloat16:
        table[rows] = round_to_bf16(new, rows, sr_seed)
    else:
        table[rows] = new


# ---------------------------------------------------------------------------
# B2: the per-id fused backward + optimizer, all eight optimizers
# ---------------------------------------------------------------------------


def _states_of(
    optim: str,
    momentum: Optional[torch.Tensor],
    states: Optional[Sequence[torch.Tensor]],
) -> Tuple[torch.Tensor, ...]:
    """The optimizer's state arrays in :data:`STATE_LAYOUTS` order, from
    the JAX package's arguments: ``momentum`` for the adagrads, ``states =
    (m, v)`` for the Adam family, none for sgd and lars_sgd."""
    if optim not in OPTIMIZERS:
        raise ValueError(f"unknown fused optimizer {optim!r}")
    n = len(STATE_LAYOUTS[optim])
    if n == 1:
        if momentum is None:
            raise ValueError(f"{optim} needs momentum")
        return (momentum,)
    if n == 2:
        if states is None or len(states) != 2:
            raise ValueError(f"{optim} needs states=(m, v)")
        return tuple(states)
    return ()


def fused_sparse_update_plain(
    table: torch.Tensor,
    momentum: Optional[torch.Tensor],
    ids: torch.Tensor,
    valid: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    grad_seg: torch.Tensor,
    learning_rate: Scalar,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    sr_seed: Optional[int] = None,
    optim: str = "rowwise_adagrad",
    states: Optional[Sequence[torch.Tensor]] = None,
    betas: Tuple[float, float] = (0.9, 0.999),
    bias_corrections: Tuple[float, float] = (1.0, 1.0),
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of :func:`fused_sparse_update`: the kept slots sorted
    by row, each row's weighted gradient rows summed in slot order
    (``embedding_ops.run_sums``, one host sync), then :func:`update_rows`
    in B2's op order."""
    st = _states_of(optim, momentum, states)
    R = table.shape[0]
    dev = table.device
    srows, ssegs, sw = sort_by_row(ids, valid, segments, weights, R,
                                   grad_seg.shape[0])
    rows = srows[srows < R]
    n = rows.shape[0]
    if n == 0:
        return table, st
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = rows[1:] != rows[:-1]
    starts = torch.nonzero(first).flatten()
    lengths = torch.diff(starts, append=starts.new_tensor([n]))
    urows = rows[starts].to(torch.int64)
    g = run_sums(grad_seg[ssegs[:n].to(torch.int64)] * sw[:n, None], starts,
                 lengths)
    update_rows(optim, table, st, urows, g, learning_rate, eps,
                weight_decay, betas, bias_corrections, sr_seed, per_id=True)
    return table, st


def launch_fused_sparse_update(
    table: torch.Tensor,
    states: Sequence[torch.Tensor],
    srows: torch.Tensor,
    ssegs: torch.Tensor,
    sw: torch.Tensor,
    grad_seg: torch.Tensor,
    optim: str,
    learning_rate: Scalar,
    eps: float,
    weight_decay: float,
    betas: Tuple[float, float],
    bias_corrections: Tuple[float, float],
    sr_seed: Optional[int],
) -> None:
    """Launch the B2 kernel on prepared inputs (the output of
    :func:`sort_by_row`, at least one slot); updates the table and the
    states in place."""
    (b1, b2), (bc1, bc2) = betas, bias_corrections
    _launch(_SOURCE, "fused_update", table, states, srows, ssegs, sw,
            grad_seg, optim,
            (learning_rate, eps, weight_decay, b1, b2, bc1, bc2), sr_seed)
    count_launch("fused_sparse_update")


def fused_update_registers(optim: str, dtype: torch.dtype, dim: int) -> int:
    """The registers per thread of the B2 instantiation that a table of
    ``dtype`` and width ``dim`` takes with ``optim`` (builds the kernel)."""
    return update_launch("fused_sparse_update", optim, dtype, dim)[
        "registers"]


def fused_sparse_update(
    table: torch.Tensor,  # [R, D] float32 or bfloat16, updated in place
    momentum: Optional[torch.Tensor],  # the adagrads' [R] / [R, D]
    ids: torch.Tensor,  # [V] table-local row ids
    valid: torch.Tensor,  # [V] bool
    segments: torch.Tensor,  # [V] the grad_seg row each slot pooled into
    weights: Optional[torch.Tensor],  # [V] float32 or None
    grad_seg: torch.Tensor,  # [S, D] float32 upstream pooled gradient
    learning_rate: Scalar,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    sr_seed: Optional[int] = None,  # int32; bfloat16 tables only
    optim: str = "rowwise_adagrad",
    states: Optional[Sequence[torch.Tensor]] = None,  # the Adam family's
    betas: Tuple[float, float] = (0.9, 0.999),
    bias_corrections: Tuple[float, float] = (1.0, 1.0),
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One-pass fused backward + optimizer (the JAX package's
    ``pallas_fused_sparse_update``): for each distinct row among the kept
    slots (``valid``, segment in ``[0, S)``, row in ``[0, R)``), ``g =
    sum_i w_i * grad_seg[seg_i]`` in slot order (plus ``weight_decay *
    w``), then one step of ``optim`` (one of :data:`OPTIMIZERS`) in
    ``_bwd_body``'s op order on the row and its states (float32, bfloat16
    or float16, all of one dtype: :func:`update_rows`):
    ``momentum`` (``[R]`` for rowwise Adagrad, ``[R, D]`` for Adagrad),
    ``states = (m, v)`` for the Adam family (``v`` ``[R]`` for the
    partial-rowwise pair), none for sgd and lars_sgd.  The Adam family's
    ``bias_corrections`` are ``(1 - b1**t, 1 - b2**t)`` for the caller's
    incremented step ``t``.  A bfloat16 table is written back with
    stochastic rounding when ``sr_seed`` is given.  Returns ``(table,
    state arrays)``, the inputs themselves, updated in place."""
    st = _states_of(optim, momentum, states)
    dev = _check_inputs(table, st, STATE_LAYOUTS[optim], ids, valid,
                        segments, weights, grad_seg, sr_seed)
    args = (optim, learning_rate, eps, weight_decay, betas,
            bias_corrections, sr_seed)
    if dev.type == "cpu":
        return fused_sparse_update_plain(
            table, momentum, ids, valid, segments, weights, grad_seg,
            learning_rate, eps, weight_decay, sr_seed, optim, states, betas,
            bias_corrections)
    _require_cuda(dev)
    if ids.shape[0] == 0:
        return table, st
    srows, ssegs, sw = sort_by_row(ids, valid, segments, weights,
                                   table.shape[0], grad_seg.shape[0])
    launch_fused_sparse_update(table, st, srows, ssegs, sw, grad_seg, *args)
    return table, st


# ---------------------------------------------------------------------------
# B6: the dedup fused backward + optimizer, all eight optimizers
# ---------------------------------------------------------------------------


def dedup_fused_sparse_update_plain(
    table: torch.Tensor,
    states: Sequence[torch.Tensor],
    ids: torch.Tensor,
    valid: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor],
    grad_seg: torch.Tensor,
    optim: str,
    learning_rate: Scalar,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    betas: Tuple[float, float] = (0.9, 0.999),
    bias_corrections: Tuple[float, float] = (1.0, 1.0),
    sr_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of :func:`dedup_fused_sparse_update`: the row
    gradients of the kept slots (:func:`embedding_row_grads`), summed per
    row in slot order (:func:`aggregate_duplicate_rows`), then
    :func:`update_rows`.  One host sync reads which rows were touched."""
    R, S = table.shape[0], grad_seg.shape[0]
    ok = (valid & (segments >= 0) & (segments < S) & (ids >= 0)
          & (ids < R))
    row_grads = embedding_row_grads(grad_seg, torch.where(ok, segments, S),
                                    weights)
    rows, g = aggregate_duplicate_rows(ids, ok, row_grads)
    keep = rows < R
    update_rows(optim, table, states, rows[keep].to(torch.int64), g[keep],
                learning_rate, eps, weight_decay, betas, bias_corrections,
                sr_seed)
    return table, tuple(states)


def launch_dedup_fused_sparse_update(
    table: torch.Tensor,
    states: Sequence[torch.Tensor],
    srows: torch.Tensor,
    ssegs: torch.Tensor,
    sw: torch.Tensor,
    grad_seg: torch.Tensor,
    optim: str,
    learning_rate: Scalar,
    eps: float,
    weight_decay: float,
    betas: Tuple[float, float],
    bias_corrections: Tuple[float, float],
    sr_seed: Optional[int],
) -> None:
    """Launch the B6 kernel on prepared inputs (the output of
    :func:`sort_by_row`, at least one slot); updates the table and the
    states in place."""
    (b1, b2), (bc1, bc2) = betas, bias_corrections
    _launch(_DEDUP_SOURCE, "dedup_fused_update", table, states, srows, ssegs,
            sw, grad_seg, optim,
            (learning_rate, eps, weight_decay, b1, b2, 1.0 - b1, 1.0 - b2,
             bc1, bc2), sr_seed)
    count_launch("dedup_fused_sparse_update")


def dedup_fused_update_registers(optim: str, dtype: torch.dtype,
                                 dim: int) -> int:
    """The registers per thread of the B6 instantiation that a table of
    ``dtype`` and width ``dim`` takes with ``optim`` (builds the kernel)."""
    return update_launch("dedup_fused_sparse_update", optim, dtype, dim)[
        "registers"]


def dedup_fused_sparse_update(
    table: torch.Tensor,  # [R, D] float32 or bfloat16, updated in place
    states: Sequence[torch.Tensor],  # STATE_LAYOUTS[optim], STATE_DTYPES
    ids: torch.Tensor,  # [V] table-local row ids
    valid: torch.Tensor,  # [V] bool
    segments: torch.Tensor,  # [V] the grad_seg row each slot pooled into
    weights: Optional[torch.Tensor],  # [V] float32 or None
    grad_seg: torch.Tensor,  # [S, D] float32 upstream pooled gradient
    optim: str,
    learning_rate: Scalar,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    betas: Tuple[float, float] = (0.9, 0.999),
    bias_corrections: Tuple[float, float] = (1.0, 1.0),
    sr_seed: Optional[int] = None,  # int32; bfloat16 tables only
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One-pass dedup fused backward + optimizer: for each distinct row
    among the kept slots (``valid``, segment in ``[0, S)``, row in
    ``[0, R)``), ``g = sum_i grad_seg[seg_i] * w_i`` in slot order (plus
    ``weight_decay * w``), then one step of ``optim`` (one of
    :data:`OPTIMIZERS`) on the row and its states: ``()`` for sgd and
    lars_sgd, ``(momentum,)`` for the adagrads, ``(m, v)`` for the adam
    family, whose ``bias_corrections`` are ``(1 - b1**t, 1 - b2**t)`` for
    the caller's incremented step ``t``.  A bfloat16 table is written back
    with stochastic rounding when ``sr_seed`` is given.  Returns
    ``(table, states)``, the inputs themselves, updated in place."""
    if optim not in OPTIMIZERS:
        raise ValueError(f"unknown fused optimizer {optim!r}")
    states = tuple(states)
    dev = _check_inputs(table, states, STATE_LAYOUTS[optim], ids, valid,
                        segments, weights, grad_seg, sr_seed)
    args = (optim, learning_rate, eps, weight_decay, betas,
            bias_corrections, sr_seed)
    if dev.type == "cpu":
        return dedup_fused_sparse_update_plain(
            table, states, ids, valid, segments, weights, grad_seg, *args)
    _require_cuda(dev)
    if ids.shape[0] == 0:
        return table, states
    srows, ssegs, sw = sort_by_row(ids, valid, segments, weights,
                                   table.shape[0], grad_seg.shape[0])
    launch_dedup_fused_sparse_update(table, states, srows, ssegs, sw,
                                     grad_seg, *args)
    return table, states
