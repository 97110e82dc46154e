"""Table-wise sharded execution (a subset of
``torchrec_tpu/parallel/sharding/tw.py``).

A TW group stacks every table of one embedding dim row-wise into one
array and keeps the JAX package's uniform ``[N, F, C]`` slot geometry: N
devices, F slots per device, C ids per slot.  The lookup pools slot
``(src, slot, b)`` into segment ``slot * (N * B) + src * B + b`` of one
pooled lookup over the local stack (a kernel of ``ops/tbe.py``, by the
caller's ``lookup_kernel``: the per-id ``"tbe"`` lookup reads the
``[N, F, C]`` slots as ``N * F`` regions with no sort, the ragged
``"dedup"`` one takes each slot's segment), and the backward hands the
same slot layout to the fused update as a :class:`SparseSegGrad`.

This port runs one device.  Its dists are the identity there; at
``world_size > 1`` the forward and backward raise ``NotImplementedError``
(multi-GPU sharding is ROADMAP A6) instead of pretending to exchange.
Left out: column-wise shards, qcomms, the wire-byte ledger and the
sequence (unpooled) variants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from torchrec_tpu_torch.ops.embedding_ops import (
    SlotRegions,
    pooled_embedding_lookup,
    pooled_embedding_lookup_regions,
)
from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
from torchrec_tpu_torch.parallel.sharding.common import (
    FeatureSpec,
    per_slot_segments,
    source_weights,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

WeightLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class TwSlot:
    """One table-wise slot: a table placed whole on one rank within a
    stacked same-dim group."""

    feature: FeatureSpec
    owner: int
    slot_index: int  # slot position on owner
    out_offset: int  # column offset into the feature's embedding
    out_feature: str  # the feature this slot contributes to


@dataclasses.dataclass
class TwGroupLayout:
    """Static layout of one (TABLE_WISE, dim) group."""

    name: str
    world_size: int
    batch_size: int  # per-device batch
    dim: int
    cap: int  # uniform per-slot id capacity
    f_max: int  # slots per device (padded)
    r_stack: int  # rows per device stack (padded)
    slots: List[TwSlot]
    # row offset of slot j's table within owner's stack: [N, F_max]
    row_offset: np.ndarray
    # owner -> [(table_name, stack_row_offset, rows, col_offset)]
    stack_assignment: Dict[int, List[Tuple[str, int, int, int]]]
    feature_slots: Dict[str, List[TwSlot]]
    feature_order: List[str]

    @property
    def param_shape(self) -> Tuple[int, int]:
        """Flat row-stacked shape: row r of device d is row
        ``d * r_stack + r``."""
        return (self.world_size * self.r_stack, self.dim)


def build_tw_layout(
    name: str,
    features: Sequence[FeatureSpec],
    table_owner: Dict[str, List[int]],  # table -> [owner rank]
    world_size: int,
    batch_size: int,
) -> TwGroupLayout:
    """Compile a TW group: assign one slot per feature on its table's
    owner, stack each owner's tables, pad to uniform sizes."""
    dim = features[0].dim
    if any(f.dim != dim for f in features):
        raise ValueError(f"group {name}: features of different dims")
    cap = max(f.cap for f in features)
    stack_assignment: Dict[int, List[Tuple[str, int, int, int]]] = {
        d: [] for d in range(world_size)
    }
    placed: Dict[str, int] = {}  # table -> stack row offset on its owner
    for f in features:
        owners = table_owner[f.table_name]
        if len(owners) != 1:
            raise NotImplementedError(
                f"{f.table_name}: column-wise shards are not ported")
        owner = owners[0]
        if f.table_name not in placed:
            off = sum(r for (_, _, r, _) in stack_assignment[owner])
            stack_assignment[owner].append((f.table_name, off, f.table_rows,
                                            0))
            placed[f.table_name] = off

    slots: List[TwSlot] = []
    next_slot = {d: 0 for d in range(world_size)}
    feature_slots: Dict[str, List[TwSlot]] = {}
    for f in features:
        owner = table_owner[f.table_name][0]
        s = TwSlot(feature=f, owner=owner, slot_index=next_slot[owner],
                   out_offset=0, out_feature=f.name)
        next_slot[owner] += 1
        slots.append(s)
        feature_slots[f.name] = [s]

    f_max = max(1, max(next_slot.values()))
    r_stack = max(
        1, max(sum(r for (_, _, r, _) in v) for v in stack_assignment.values())
    )
    row_offset = np.full((world_size, f_max), r_stack, dtype=np.int32)
    for s in slots:
        row_offset[s.owner, s.slot_index] = placed[s.feature.table_name]
    return TwGroupLayout(
        name=name, world_size=world_size, batch_size=batch_size, dim=dim,
        cap=cap, f_max=f_max, r_stack=r_stack, slots=slots,
        row_offset=row_offset, stack_assignment=stack_assignment,
        feature_slots=feature_slots, feature_order=[f.name for f in features],
    )


def tw_params_from_tables(
    layout: TwGroupLayout,
    table_weights: Mapping[str, WeightLike],  # table -> [R, dim]
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Copy full per-table weights into the group's stack
    ``[N * r_stack, dim]`` (padding rows zero), cast to ``dtype``.
    Inverse of :func:`tw_tables_from_params`."""
    N, L = layout.world_size, layout.r_stack
    out = torch.zeros((N * L, layout.dim), dtype=dtype, device=device)
    for owner, entries in layout.stack_assignment.items():
        for tname, off, rows, col_off in entries:
            w = torch.as_tensor(table_weights[tname])
            out[owner * L + off: owner * L + off + rows] = (
                w[:, col_off: col_off + layout.dim].to(out.device))
    return out


def tw_tables_from_params(
    layout: TwGroupLayout,
    params: torch.Tensor,  # [N * r_stack, dim]
) -> Dict[str, torch.Tensor]:
    """The stack back as full per-table weights (views of ``params``)."""
    L = layout.r_stack
    return {
        tname: params[owner * L + off: owner * L + off + rows]
        for owner, entries in layout.stack_assignment.items()
        for tname, off, rows, _ in entries
    }


def _require_one_device(layout: TwGroupLayout) -> None:
    if layout.world_size != 1:
        raise NotImplementedError(
            f"group {layout.name}: table-wise execution across "
            f"{layout.world_size} devices needs the all-to-all dists of "
            "multi-GPU sharding, which are not ported yet"
        )


def tw_slot_stream(
    layout: TwGroupLayout, kjt: KeyedJaggedTensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The group's slots after the input dist: (ids ``[N*F*C]`` int32
    into the local stack, weights ``[N*F*C]`` float32, lengths ``[N*F*B]``
    int32), each ``(src, slot)`` region front-packed in example order."""
    _require_one_device(layout)
    N, B, C, F = layout.world_size, layout.batch_size, layout.cap, layout.f_max
    dev = kjt.values().device
    jts = kjt.to_dict()
    ids_send = torch.zeros((N, F, C), dtype=torch.int32, device=dev)
    w_send = torch.zeros((N, F, C), dtype=torch.float32, device=dev)
    len_send = torch.zeros((N, F, B), dtype=torch.int32, device=dev)
    for s in layout.slots:
        jt = jts[s.feature.name]
        seg = per_slot_segments(jt.lengths(), s.feature.cap)
        n = s.feature.cap
        ids_send[s.owner, s.slot_index, :n] = jt.values().to(torch.int32)
        w_send[s.owner, s.slot_index, :n] = source_weights(
            jt.weights_or_none(), seg, jt.lengths(), s.feature.pooling)
        len_send[s.owner, s.slot_index] = jt.lengths()
    # input dist: on one device the all-to-all is the identity
    ids_recv, w_recv, len_recv = ids_send, w_send, len_send
    row_off = torch.as_tensor(layout.row_offset[0], device=dev)
    ids_local = ids_recv + row_off[None, :, None]
    return ids_local.reshape(-1), w_recv.reshape(-1), len_recv.reshape(-1)


def tw_regions(layout: TwGroupLayout, lengths: torch.Tensor) -> SlotRegions:
    """The ``[N, F, C]`` slots as ``N * F`` regions of cap ``C`` and ``B``
    examples each, region ``(src, slot)`` at ``(src * F + slot) * C``:
    example ``(src, slot, b)`` is row ``(src * F + slot) * B + b`` of the
    lookup's output."""
    k = layout.world_size * layout.f_max
    C = layout.cap
    return SlotRegions(lengths, tuple(i * C for i in range(k)), (C,) * k,
                       (layout.batch_size,) * k)


def tw_segments(layout: TwGroupLayout,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Each slot's segment ``slot * (N * B) + src * B + b`` (``F*N*B`` for
    padding), int64 ``[N*F*C]``, and the segment count ``F*N*B``."""
    N, B, C, F = layout.world_size, layout.batch_size, layout.cap, layout.f_max
    dev = lengths.device
    seg_b = per_slot_segments(lengths.view(N, F, B), C)  # example or B
    src = torch.arange(N, device=dev)[:, None, None]
    slot = torch.arange(F, device=dev)[None, :, None]
    num_segments = F * N * B
    segs = torch.where(seg_b < B, slot * (N * B) + src * B + seg_b,
                       num_segments)
    return segs.reshape(-1), num_segments


def tw_forward_local(
    layout: TwGroupLayout,
    stack_local: torch.Tensor,  # [r_stack, dim]
    kjt: KeyedJaggedTensor,
    lookup_kernel: str = "tbe",
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Input dist -> lookup -> output dist for one group.  Returns
    ({feature: [B, dim]} pooled embeddings in the table's dtype, ctx for
    the backward).  ``lookup_kernel``: ``"tbe"`` (over the slots' regions,
    ``ops/embedding_ops.py::pooled_embedding_lookup_regions``) or
    ``"dedup"`` (``pooled_embedding_lookup``).  The segments are built for
    the backward either way."""
    ids_flat, w_flat, lengths = tw_slot_stream(layout, kjt)
    segs, num_segments = tw_segments(layout, lengths)
    if lookup_kernel == "tbe":
        N, B, F = layout.world_size, layout.batch_size, layout.f_max
        pooled = pooled_embedding_lookup_regions(
            stack_local, ids_flat, tw_regions(layout, lengths), w_flat)
        # rows (src, slot, b) -> segments (slot, src, b)
        pooled = pooled.view(N, F, B, layout.dim).transpose(0, 1).reshape(
            num_segments, layout.dim)
    else:
        pooled = pooled_embedding_lookup(stack_local, ids_flat, segs,
                                         num_segments, w_flat,
                                         kernel=lookup_kernel)
    return tw_output_features(layout, pooled), (ids_flat, w_flat, segs)


def tw_output_features(
    layout: TwGroupLayout, pooled: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Output dist of the pooled lookup ``[F*N*B, dim]``: {feature: [B,
    dim]} (the identity exchange on one device)."""
    N, B, F = layout.world_size, layout.batch_size, layout.f_max
    out_recv = pooled.reshape(F, N, B, layout.dim).transpose(0, 1)
    return {
        fname: out_recv[layout.feature_slots[fname][0].owner,
                        layout.feature_slots[fname][0].slot_index]
        for fname in layout.feature_order
    }


def tw_backward_local(
    layout: TwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],  # feature -> [B, dim]
) -> SparseSegGrad:
    """Reverse dist; returns the segment-level sparse gradient against the
    local stack, for ``apply_sparse_update_segments``."""
    _require_one_device(layout)
    N, B, F = layout.world_size, layout.batch_size, layout.f_max
    ids_flat, w_flat, segs = ctx
    g_send = torch.zeros((N, F, B, layout.dim), dtype=torch.float32,
                         device=w_flat.device)
    for fname in layout.feature_order:
        s = layout.feature_slots[fname][0]
        g_send[s.owner, s.slot_index] = grad_out[fname][
            :, s.out_offset: s.out_offset + layout.dim].to(torch.float32)
    g_recv = g_send  # the identity on one device
    g_flat = g_recv.transpose(0, 1).reshape(F * N * B, layout.dim)
    valid = (segs < F * N * B) & (w_flat != 0)
    return SparseSegGrad(ids_flat, valid, segs, w_flat, g_flat)
