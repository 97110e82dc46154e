"""Embedding ops (a subset of ``torchrec_tpu/ops/embedding_ops.py``): the
pooled lookup behind the kernels of ``ops/tbe.py`` with its gradient,
over a slot stream in any order or in its producer's layout
(:class:`SlotRegions`, read by the per-id kernel with no sort), the
sequence lookup, pooling weights, the sort-based dedup scaffold, and
the row gradients and duplicate aggregation that the dedup fused update's
plain version is built from.

The lookup's kernel is an argument, ``"tbe"`` (the per-id lookup, B1) or
``"dedup"`` (the ragged dedup lookup, B4): the port runs eagerly and takes
its kernel per call.  The JAX package's process-wide kernel registry is
here with its names (:data:`POOLED_KERNELS`, ``set_``/
``get_pooled_lookup_kernel``, :func:`trace_kernels` over this module's,
``ops/quant_ops.py``'s and ``ops/fused_update.py``'s switches, all under
the reentrant :data:`TRACE_KERNEL_LOCK`, and the environment override
``TORCHREC_TPU_POOLED_KERNEL``).  The JAX package reads it at trace time;
the port reads it at build time: a DMP, a collection or a bucketed
signature's clone built with no kernel of its own takes the selection's
port kernel (:func:`resolve_lookup_kernel`: ``"xla"`` and ``"pallas"`` are
B1, ``"xla_dedup"`` and ``"pallas_dedup"`` B4; no name selects a plain
version).  An explicit kernel argument wins.  The TPU options
(``chunk``, ``group``, ``interpret``) are kept and do nothing here, and so
are ``id_cap`` / ``u_cap``: the port's sized dedup prep bounds itself by
the stream it is given.
The gradient is a ``torch.autograd.Function`` whose backward is the JAX
package's own for its Pallas forwards (``_pallas_pooled_bwd``,
``_pallas_dedup_pooled_bwd``): a scatter-add of the row gradients into
a dense table gradient, and the weights' gradient only when they need
one.  :func:`sanitize_ids` is the null-row id remap under the traced
guardrail (``robustness/sanitize.py``).  Left out: the ``xla``/
``xla_dedup`` lookups and their custom VJPs.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple, Optional, Tuple

import torch

# the process-wide kernel selections (this module's, ``quant_ops``' and
# ``fused_update``'s) are read and written under this lock; reentrant, so a
# caller holding it across a build can still call the setters
TRACE_KERNEL_LOCK = threading.RLock()

# the port's pooled lookups: B1 and B4
LOOKUP_KERNELS = ("tbe", "dedup")
# the JAX package's pooled-lookup kernel names and the port kernel of each
POOLED_KERNELS = ("xla", "xla_dedup", "pallas", "pallas_dedup")
POOLED_KERNEL_MAP = {"xla": "tbe", "pallas": "tbe", "xla_dedup": "dedup",
                     "pallas_dedup": "dedup"}
_POOLED_KERNEL: str = os.environ.get("TORCHREC_TPU_POOLED_KERNEL", "xla")
_PALLAS_OPTS = {"chunk": 1024, "group": 16, "interpret": False}
_PALLAS_DEDUP_OPTS = {"id_cap": None, "u_cap": None}


def set_pooled_lookup_kernel(
    kind: str,
    chunk: int = 1024,
    group: int = 16,
    interpret: bool = False,
    id_cap: Optional[int] = None,
    u_cap: Optional[int] = None,
) -> None:
    """Select the pooled-lookup kernel process-wide by its JAX name (one
    of :data:`POOLED_KERNELS`); what is built afterwards with no kernel of
    its own takes it.  The options are kept and do nothing in the port.
    Thread-safe (:data:`TRACE_KERNEL_LOCK`)."""
    global _POOLED_KERNEL
    if kind not in POOLED_KERNELS:
        raise ValueError(f"unknown pooled-lookup kernel {kind!r}")
    with TRACE_KERNEL_LOCK:
        _POOLED_KERNEL = kind
        _PALLAS_OPTS.update(chunk=chunk, group=group, interpret=interpret)
        _PALLAS_DEDUP_OPTS.update(id_cap=id_cap, u_cap=u_cap)


def get_pooled_lookup_kernel() -> str:
    """The process-wide pooled-lookup kernel (one of
    :data:`POOLED_KERNELS`)."""
    return _POOLED_KERNEL


def resolve_lookup_kernel(kernel: Optional[str]) -> str:
    """The port's pooled lookup (:data:`LOOKUP_KERNELS`) for ``kernel``:
    itself when it names one; for None the process-wide selection's,
    through :data:`POOLED_KERNEL_MAP`.  An explicit kernel takes the
    port's names only."""
    if kernel is None:
        with TRACE_KERNEL_LOCK:
            return POOLED_KERNEL_MAP[_POOLED_KERNEL]
    if kernel not in LOOKUP_KERNELS:
        raise ValueError(f"unknown pooled-lookup kernel {kernel!r}")
    return kernel


@contextlib.contextmanager
def trace_kernels(pooled: Optional[str] = None, quant: Optional[str] = None,
                  update: Optional[str] = None, **opts):
    """Scoped kernel selection under :data:`TRACE_KERNEL_LOCK`: select
    the pooled, quantized and sparse-update kernels (JAX names; None
    leaves a family as it is) for the body, then restore every family's
    previous selection and options.  ``opts`` go to each selected
    family's setter (``chunk``, ``group``, ``interpret``, ``id_cap``,
    ``u_cap`` as it takes them).  What the body builds with no kernel of
    its own takes these (an explicit kernel argument keeps the port's
    names, ``"tbe"`` or ``"dedup"``)."""
    from torchrec_tpu_torch.ops import fused_update as _fu
    from torchrec_tpu_torch.ops import quant_ops as _qo

    lookup_opts = ("chunk", "group", "interpret", "id_cap", "u_cap")
    with TRACE_KERNEL_LOCK:
        prev_pool = (_POOLED_KERNEL, dict(_PALLAS_OPTS),
                     dict(_PALLAS_DEDUP_OPTS))
        prev_quant = (_qo.get_quant_lookup_kernel(),
                      dict(_qo._QUANT_PALLAS_OPTS),
                      dict(_qo._QUANT_DEDUP_OPTS))
        prev_update = (_fu.get_sparse_update_kernel(),
                       dict(_fu._UPDATE_PALLAS_OPTS),
                       dict(_fu._UPDATE_DEDUP_OPTS))
        try:
            if pooled is not None:
                set_pooled_lookup_kernel(pooled, **{
                    k: v for k, v in opts.items() if k in lookup_opts})
            if quant is not None:
                _qo.set_quant_lookup_kernel(quant, **{
                    k: v for k, v in opts.items() if k in lookup_opts})
            if update is not None:
                _fu.set_sparse_update_kernel(update, **{
                    k: v for k, v in opts.items()
                    if k in ("chunk", "group", "interpret", "id_cap")})
            yield
        finally:
            set_pooled_lookup_kernel(prev_pool[0], **prev_pool[1])
            _PALLAS_DEDUP_OPTS.update(prev_pool[2])
            _qo.set_quant_lookup_kernel(prev_quant[0], **prev_quant[1])
            _qo._QUANT_DEDUP_OPTS.update(prev_quant[2])
            _fu.set_sparse_update_kernel(prev_update[0], **prev_update[1])
            _fu._UPDATE_DEDUP_OPTS.update(prev_update[2])


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


def embedding_row_grads(
    grad_pooled: torch.Tensor,
    segments: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward of the pooled lookup with respect to the gathered rows:
    each slot receives its segment's output gradient times its weight
    (zero for slots whose segment is ``>= num_segments``).
    ``grad_pooled`` ``[num_segments, D]``; returns ``[V, D]``."""
    num_segments = grad_pooled.shape[0]
    g = grad_pooled[segments.clamp(0, num_segments - 1)]
    g = torch.where((segments < num_segments)[:, None], g, 0.0)
    if weights is not None:
        g = g * weights[:, None].to(g.dtype)
    return g


def run_sums(vals: torch.Tensor, starts: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
    """``[len(starts), D]`` sums of the runs ``vals[starts[u] :
    starts[u] + lengths[u]]``, each in position order from zero
    (``acc = acc + v``, one rounding per add, the kernels' order).  The
    walk goes by position: pass ``j`` adds the ``j``-th element of every
    run longer than ``j``, on ``[runs open, D]`` (one host sync reads the
    run lengths)."""
    part = vals.new_zeros((starts.shape[0],) + tuple(vals.shape[1:]))
    if starts.shape[0] == 0:
        return part
    # longest runs first, so the runs open at pass j are a prefix
    order = torch.argsort(lengths, descending=True, stable=True)
    starts_o = starts[order]
    open_runs = torch.bincount(lengths.cpu()).flip(0).cumsum(0).flip(0)
    for j in range(1, open_runs.shape[0]):
        k = int(open_runs[j])  # runs with at least j elements
        part[:k] = part[:k] + vals[starts_o[:k] + (j - 1)]
    out = torch.empty_like(part)
    out[order] = part
    return out


def aggregate_duplicate_rows(
    ids: torch.Tensor,
    valid: torch.Tensor,
    row_grads: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum per-slot row gradients over duplicate ids, each group in the
    order of a stable sort by id (slot order within a row).

    Returns (rows ``[V]``, grads ``[V, D]``): entry ``u`` is the summed
    gradient of row ``rows[u]``; unused entries carry the dtype's max as
    their row (dropped by the caller) and zero gradients.  The group of
    the invalid slots (row = the dtype's max) is not summed and keeps a
    zero gradient: every caller drops that row, and its run can hold most
    of the slots (one host sync counts the valid ones)."""
    order, unique_slot, slot_rows = dedup_ids(ids, valid)
    agg = row_grads.new_zeros(row_grads.shape)
    n = int(valid.sum())  # the valid slots sort first
    if n == 0:
        return slot_rows, agg
    first = torch.ones((n,), dtype=torch.bool, device=ids.device)
    first[1:] = unique_slot[1:n] != unique_slot[: n - 1]
    starts = torch.nonzero(first).flatten()
    lengths = torch.diff(starts, append=starts.new_tensor([n]))
    agg[: starts.shape[0]] = run_sums(row_grads[order[:n]], starts, lengths)
    return slot_rows, agg


class SlotRegions(NamedTuple):
    """A slot stream as its producer laid it out: region ``k`` is the
    slots ``[starts[k], starts[k] + caps[k])``, front-packed in example
    order by its ``counts[k]`` examples, whose lengths are the next
    ``counts[k]`` entries of ``lengths`` (regions in the order of
    ``lengths``).  Example ``e``, an index into ``lengths``, is segment
    ``e`` of a pooled lookup and owns the slots its region's running
    lengths give it, cut at the cap: the slots that
    ``parallel/sharding/common.py::per_slot_segments`` and
    ``KeyedJaggedTensor.segment_ids`` give it.  The table-wise ``[N, F,
    C]`` layout is ``N * F`` regions of cap ``C``; a KeyedJaggedTensor's
    keys are regions at its ``cap_offsets()``.  Lengths are non-negative
    and, on the card, sum to less than ``2**31`` in int32."""

    lengths: torch.Tensor  # [sum(counts)] int32 or int64
    starts: Tuple[int, ...]
    caps: Tuple[int, ...]
    counts: Tuple[int, ...]

    @property
    def num_segments(self) -> int:
        return sum(self.counts)

    def _region_ends(self):
        """Per region: (start, cap, base, the running ends of its
        lengths, int64)."""
        lens = self.lengths.to(torch.int64)
        base = 0
        for start, cap, count in zip(self.starts, self.caps, self.counts):
            yield start, cap, base, torch.cumsum(lens[base:base + count], 0)
            base += count

    def ranges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(first slot, slot count) of every segment, int64 ``[S]``."""
        firsts, sizes = [], []
        for start, cap, _, ends in self._region_ends():
            lo = torch.cat([ends.new_zeros(1), ends])[:-1].clamp(0, cap)
            hi = torch.maximum(ends.clamp(0, cap), lo)
            firsts.append(start + lo)
            sizes.append(hi - lo)
        if not firsts:
            empty = self.lengths.new_zeros((0,), dtype=torch.int64)
            return empty, empty
        return torch.cat(firsts), torch.cat(sizes)

    def segment_ids(self, num_slots: int) -> torch.Tensor:
        """``[num_slots]`` int64: each slot's segment, or
        :attr:`num_segments` for a slot no example owns (as
        ``per_slot_segments``: a searchsorted per region, no host
        sync)."""
        S = self.num_segments
        dev = self.lengths.device
        seg = torch.full((num_slots,), S, dtype=torch.int64, device=dev)
        for start, cap, base, ends in self._region_ends():
            offs = torch.cat([ends.new_zeros(1), ends])
            pos = torch.arange(cap, dtype=torch.int64, device=dev)
            b = torch.searchsorted(offs, pos, right=True) - 1
            seg[start:start + cap] = torch.where(pos < offs[-1], base + b, S)
        return seg


# the most spare rows the lookup's backward scatters invalid slots to
_SPARE_ROWS = 1024


def pooled_embedding_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    weights: Optional[torch.Tensor] = None,
    kernel: str = "tbe",
) -> torch.Tensor:
    """Weighted-sum pooled lookup: ``[num_segments, D]`` in the table's
    dtype (float32 or bfloat16), accumulated in float32 in slot order.
    Ids clip to the table; slots whose segment lies outside
    ``[0, num_segments)`` are dropped.  ``kernel``: ``"tbe"`` runs
    ``ops/tbe.py::pooled_lookup`` (the port of the JAX package's Pallas
    TBE forward), ``"dedup"`` runs ``ops/tbe.py::dedup_pooled_lookup``
    (the port of its ragged dedup lookup, ``"pallas_dedup"``); both give
    the same float32 result.  CUDA tensors launch the kernel, CPU tensors
    take its plain version.  Differentiable in ``table`` and ``weights``
    (:class:`_PooledLookup`)."""
    if kernel not in LOOKUP_KERNELS:
        raise ValueError(f"unknown pooled-lookup kernel {kernel!r}")
    if weights is not None:
        weights = weights.to(torch.float32)
    return _PooledLookup.apply(table, ids, segments, weights, num_segments,
                               kernel)


class _PooledLookup(torch.autograd.Function):
    """:func:`pooled_embedding_lookup` with a gradient for the table and
    the weights.  The forward is the kernel's wrapper.  The backward, for
    either kernel, is the JAX package's ``_pallas_pooled_bwd``: ``d_table``
    ``[R, D]`` (the table's dtype) is the scatter-add of the valid slots'
    row gradients (:func:`embedding_row_grads`) at their clipped ids, and
    ``d_weights`` the row times its segment's gradient, summed over the
    columns, computed only when the weights need a gradient.  Its
    ``_pallas_dedup_pooled_bwd`` first sums each distinct row's slot
    gradients in the order of a stable sort by id, which is slot order:
    the same sums, so one backward serves both.  (For an id outside the
    table that VJP differs: it drops an id at or past the table and wraps
    a negative one, where both forwards read the clipped row; here the
    gradient goes to the row the forward read, as ``_pallas_pooled_bwd``
    sends it.)  The scatter-add is
    ``index_put_(accumulate=True)``, which sorts by row and adds each
    row's slots in slot order on the card (no float atomics), so two
    backward calls give the same bits."""

    @staticmethod
    def forward(ctx, table, ids, segments, weights, num_segments, kernel):
        from torchrec_tpu_torch.ops.tbe import (
            dedup_pooled_lookup,
            pooled_lookup,
        )

        fn = pooled_lookup if kernel == "tbe" else dedup_pooled_lookup
        ctx.num_segments = num_segments
        ctx.save_for_backward(table, ids, segments, weights)
        return fn(table, ids, segments, num_segments, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, segments, weights = ctx.saved_tensors
        d_table, d_w = _lookup_grads(g, table, ids, segments, weights,
                                     ctx.num_segments,
                                     ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[3])
        return d_table, None, None, d_w, None, None


def _lookup_grads(g, table, ids, segments, weights, S, want_table,
                  want_weights):
    """The pooled lookups' backward (``_pallas_pooled_bwd``, see
    :class:`_PooledLookup`): (``d_table`` or None, ``d_weights`` or
    None)."""
    R, D = table.shape
    valid = (segments >= 0) & (segments < S)
    ids_c = ids.clamp(0, R - 1).to(torch.int64)
    d_table = d_w = None
    if want_table:
        row_g = embedding_row_grads(g.to(torch.float32),
                                    torch.where(valid, segments, S), weights)
        # invalid slots land on spare rows past the table, spread over up
        # to _SPARE_ROWS of them: the scatter adds a row's slots one after
        # another, so one spare row would serialise them all
        V = ids.shape[0]
        spare = max(1, min(V, _SPARE_ROWS))
        pos = torch.arange(V, device=ids.device)
        acc = torch.zeros((R + spare, D), dtype=torch.float32,
                          device=table.device)
        acc.index_put_((torch.where(valid, ids_c, R + pos % spare),), row_g,
                       accumulate=True)
        d_table = acc[:R].to(table.dtype)
    if weights is not None and want_weights:
        rows = table[ids_c].to(torch.float32)
        gs = g[segments.clamp(0, S - 1)].to(torch.float32)
        d_w = torch.where(valid, (gs * rows).sum(dim=-1), 0.0)
    return d_table, d_w


def pooled_embedding_lookup_regions(
    table: torch.Tensor,
    ids: torch.Tensor,
    regions: SlotRegions,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`pooled_embedding_lookup` with the ``"tbe"`` kernel over a
    stream in its producer's layout: ``[regions.num_segments, D]``, segment
    ``e`` the weighted sum of example ``e``'s slots
    (``ops/tbe.py::pooled_lookup_regions``: on the card one launch, no
    sort).  Differentiable in ``table`` and ``weights``; the backward
    derives each slot's segment (:meth:`SlotRegions.segment_ids`) and is
    :class:`_PooledLookup`'s."""
    if weights is not None:
        weights = weights.to(torch.float32)
    return _RegionLookup.apply(table, ids, weights, regions)


class _RegionLookup(torch.autograd.Function):
    """:func:`pooled_embedding_lookup_regions` with a gradient for the
    table and the weights."""

    @staticmethod
    def forward(ctx, table, ids, weights, regions):
        from torchrec_tpu_torch.ops.tbe import pooled_lookup_regions

        ctx.regions = regions
        ctx.save_for_backward(table, ids, weights)
        return pooled_lookup_regions(table, ids, regions, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        regions = ctx.regions
        d_table, d_w = _lookup_grads(g, table, ids,
                                     regions.segment_ids(ids.shape[0]),
                                     weights, regions.num_segments,
                                     ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[2])
        return d_table, None, d_w, None


def sanitize_ids(
    ids: torch.Tensor,
    num_rows: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Null-row id sanitization: invalid ids (negative or ``>= num_rows``)
    become row 0 with weight 0, so their pooled contribution is exactly
    ``+0.0`` and no gradient reaches row 0 through them (every backward
    multiplies by the slot's weight).  ``weights`` default to float32
    ones.  Returns ``(safe_ids, weights, invalid_mask)``; on valid ids the
    returned tensors hold the inputs' bits (a ``where`` with an all-False
    mask).  No host sync."""
    invalid = (ids < 0) | (ids >= num_rows)
    safe = torch.where(invalid, torch.zeros_like(ids), ids)
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32,
                             device=ids.device)
    w = torch.where(invalid, torch.zeros_like(weights), weights)
    return safe, w, invalid


def sequence_embedding_lookup(
    table: torch.Tensor,
    ids: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-id (unpooled) lookup of ``EmbeddingCollection``: ``[V]`` ->
    ``[V, D]`` rows at the ids clipped to the table, the rows of invalid
    slots zero when ``valid`` is given.  A plain gather, outside any
    kernel in the JAX package too."""
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    if valid is not None:
        rows = torch.where(valid[:, None], rows, rows.new_zeros(()))
    return rows
