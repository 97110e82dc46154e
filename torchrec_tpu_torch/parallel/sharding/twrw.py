"""Table-row-wise and grid sharded execution (a subset of
``torchrec_tpu/parallel/sharding/twrw.py``).

One block-shard layout covers both: each (feature x column shard) is a
slot whose table rows are block-split over a contiguous group of ranks
(a "node"); TWRW is one column shard, GRID several, each on its own node.
Each rank runs every slot's dispatch with destination ``node_start + id
// block`` and the destination's stack offset added to the row
(``rw.block_dispatch``), reads the received ``[N, S, C]`` buckets as
regions as the row-wise lookup does (``rw.block_lookup``, B1 or, with
``lookup_kernel="dedup"``, B4: ranks outside a slot's node receive only
padding for it), and reduce-scatters the partial
sums home, where a feature's column shards are concatenated.  The
backward all-gathers each slot's gradient to every owner.  A layout's
``qcomms`` and ``row_align`` are those of ``sharding/rw.py``.

A layout built with ``hier`` runs the two-level ICI/DCN dist of
``sharding/hier.py`` (the source pools each slot itself), and only there
may it dedup (``dedup``: the source sends each distinct (slot,
destination, row) once), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
from torchrec_tpu_torch.parallel.comm import ShardingEnv, resolve_env
from torchrec_tpu_torch.parallel.qcomm import QCommsConfig
from torchrec_tpu_torch.parallel.sharding.common import FeatureSpec
from torchrec_tpu_torch.parallel.sharding.rw import (
    block_backward,
    block_dispatch,
    block_lookup,
)
from torchrec_tpu_torch.parallel.sharding.tw import WeightLike
from torchrec_tpu_torch.sparse import KeyedJaggedTensor


@dataclasses.dataclass
class BlockSlot:
    """One TWRW/GRID slot: a table (or column shard) whose rows are
    block-split over its node's ranks."""

    feature: FeatureSpec
    col_shard: int  # column-shard index (0 for pure TWRW)
    out_offset: int  # column offset into the feature's embedding
    node_devices: Tuple[int, ...]  # contiguous ranks holding the rows
    block_size: int  # rows per rank within the node


@dataclasses.dataclass
class TwRwGroupLayout:
    """Static layout of one (TWRW | GRID, shard dim) group."""

    name: str
    world_size: int
    batch_size: int
    dim: int  # column-shard dim
    cap: int
    slots: List[BlockSlot]
    # stack offset of slot s's block on rank d: [S, N] (l_stack: not held)
    dest_offset: np.ndarray
    l_stack: int
    feature_slots: Dict[str, List[BlockSlot]]
    feature_order: List[str]
    qcomms: Optional[QCommsConfig] = None  # wire precision of the dists
    # the two-level dist (sharding/hier.py) and its source-level dedup:
    # the row-wise layout's fields, one group a slot
    dedup: bool = False
    dedup_cap: int = 0
    dedup_factor: float = 1.0
    hier: object = None  # Optional[hier.HierTopology]
    hier_cap: int = 0
    hier_factor: float = 1.0

    @property
    def hier_send_cap(self) -> int:
        return self.dedup_cap if self.dedup else self.cap

    @property
    def hier_num_groups(self) -> int:
        return len(self.slots)

    def id_wire_bytes(self) -> int:
        """A rank's id-dist payload a step: three ``[N, S, cap]`` arrays
        (12 bytes a slot) flat; the two-level dist's stage-1 int32 buffer
        over ICI plus its ``[S, hier_cap]`` int32 DCN request."""
        if self.hier is not None:
            return (self.world_size * len(self.slots) * self.hier_send_cap
                    * 4 + self.hier.num_slices * self.hier_cap * 4)
        return self.world_size * len(self.slots) * self.cap * 12


def build_twrw_layout(
    name: str,
    features: Sequence[FeatureSpec],
    table_nodes: Dict[str, List[List[int]]],  # table -> node per col shard
    world_size: int,
    batch_size: int,
    qcomms: Optional[QCommsConfig] = None,
    row_align: int = 1,
    dedup: bool = False,
    dedup_factor: float = 1.0,
    hier=None,
    hier_factor: float = 1.0,
) -> TwRwGroupLayout:
    """Table-row-wise / grid group layout: each (table, column shard)'s
    rows split over its node's contiguous ranks, stacked by rank (each
    rank's stack rounded up to a multiple of ``row_align``).  ``hier`` and
    ``hier_factor`` compile the two-level dist, ``dedup`` and
    ``dedup_factor`` its source-level dedup (``rw.build_rw_layout``)."""
    if dedup and hier is None:
        raise ValueError(f"{name}: a block-shard group dedups only on the "
                         "two-level dist")
    dim = features[0].dim
    if any(f.dim != dim for f in features):
        raise ValueError(f"group {name}: features of different dims")
    used = [0] * world_size
    placed: Dict[Tuple[str, int], Dict[int, int]] = {}
    block_of: Dict[Tuple[str, int], int] = {}
    for f in features:
        for ci, devs in enumerate(table_nodes[f.table_name]):
            key = (f.table_name, ci)
            if key in placed:
                continue
            if list(devs) != list(range(devs[0], devs[0] + len(devs))):
                raise ValueError(f"{key}: node ranks must be contiguous, "
                                 f"got {devs}")
            bs = -(-f.table_rows // len(devs))
            block_of[key] = bs
            placed[key] = {}
            for d in devs:
                placed[key][d] = used[d]
                used[d] += bs
    l_stack = -(-max(1, max(used)) // row_align) * row_align
    slots: List[BlockSlot] = []
    feature_slots: Dict[str, List[BlockSlot]] = {}
    for f in features:
        fslots = []
        for ci, devs in enumerate(table_nodes[f.table_name]):
            s = BlockSlot(feature=f, col_shard=ci, out_offset=ci * dim,
                          node_devices=tuple(devs),
                          block_size=block_of[(f.table_name, ci)])
            slots.append(s)
            fslots.append(s)
        feature_slots[f.name] = fslots
    dest_offset = np.full((len(slots), world_size), l_stack, dtype=np.int32)
    for si, s in enumerate(slots):
        for d, off in placed[(s.feature.table_name, s.col_shard)].items():
            dest_offset[si, d] = off
    cap = max(f.cap for f in features)
    dedup_cap = 0
    if dedup:
        exact = max(min(s.feature.cap, s.block_size) for s in slots)
        dedup_cap = max(1, min(exact,
                               int(np.ceil(cap / max(1.0, dedup_factor)))))
    hier_cap = 0
    if hier is not None:
        from torchrec_tpu_torch.parallel.sharding.hier import hier_cap_for

        if hier.world_size != world_size:
            raise ValueError(f"{name}: a {hier.num_slices} x "
                             f"{hier.ici_size} topology for {world_size} "
                             "ranks")
        hier_cap = hier_cap_for(hier.ici_size, len(slots),
                                dedup_cap if dedup else cap, l_stack,
                                hier_factor)
    return TwRwGroupLayout(
        name=name, world_size=world_size, batch_size=batch_size, dim=dim,
        cap=cap, slots=slots,
        dest_offset=dest_offset, l_stack=l_stack,
        feature_slots=feature_slots,
        feature_order=list(dict.fromkeys(f.name for f in features)),
        qcomms=qcomms, dedup=dedup, dedup_cap=dedup_cap,
        dedup_factor=max(1.0, float(dedup_factor)), hier=hier,
        hier_cap=hier_cap, hier_factor=max(1.0, float(hier_factor)),
    )


def table_blocks(layout: TwRwGroupLayout):
    """Each (table, column shard) once: (slot index, slot)."""
    done = set()
    for si, s in enumerate(layout.slots):
        key = (s.feature.table_name, s.col_shard)
        if key not in done:
            done.add(key)
            yield si, s


def twrw_params_from_tables(
    layout: TwRwGroupLayout,
    table_weights: Mapping[str, WeightLike],
    dtype: torch.dtype = torch.float32,
    device=None,
    rank: Optional[int] = None,
) -> torch.Tensor:
    """Rank ``rank``'s stack ``[l_stack, dim]`` (every rank's with
    ``rank=None``): block ``i`` of a (table, column shard) on its node's
    ``i``-th rank, at that rank's offset for the slot."""
    L = layout.l_stack
    ranks = range(layout.world_size) if rank is None else [rank]
    out = torch.zeros((len(ranks) * L, layout.dim), dtype=dtype,
                      device=device)
    for si, s in table_blocks(layout):
        w = torch.as_tensor(table_weights[s.feature.table_name])[
            :, s.out_offset: s.out_offset + layout.dim]
        for i, d in enumerate(ranks):
            if d not in s.node_devices:
                continue
            bi = s.node_devices.index(d)
            rows = w[bi * s.block_size: (bi + 1) * s.block_size]
            off = int(layout.dest_offset[si, d])
            out[i * L + off: i * L + off + rows.shape[0]] = rows.to(
                out.device)
    return out


def twrw_tables_from_params(
    layout: TwRwGroupLayout, params: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`twrw_params_from_tables` over every rank's stack
    ``[N * l_stack, dim]``: each table with its column shards
    concatenated."""
    L = layout.l_stack
    shards: Dict[str, List[Tuple[int, torch.Tensor]]] = {}
    for si, s in table_blocks(layout):
        R = s.feature.table_rows
        rows = [params[d * L + int(layout.dest_offset[si, d]):
                       d * L + int(layout.dest_offset[si, d])
                       + min(s.block_size, R - bi * s.block_size)]
                for bi, d in enumerate(s.node_devices)
                if R - bi * s.block_size > 0]
        shards.setdefault(s.feature.table_name, []).append(
            (s.out_offset, torch.cat(rows)))
    return {t: torch.cat([v for _, v in sorted(p, key=lambda x: x[0])],
                         dim=1)
            for t, p in shards.items()}


def twrw_forward_local(
    layout: TwRwGroupLayout,
    stack_local: torch.Tensor,  # [l_stack, dim]
    kjt: KeyedJaggedTensor,
    env: Optional[ShardingEnv] = None,
    lookup_kernel: str = "tbe",
) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """Dispatch -> all-to-all -> partial lookup (``lookup_kernel``, see
    ``rw.block_lookup``) -> reduce-scatter of the node partials.  Returns
    ({feature: [B, total dim]}, ctx)."""
    N = layout.world_size
    env = resolve_env(env, N, stack_local.device)
    jts = kjt.to_dict()
    entries = []
    for si, s in enumerate(layout.slots):
        ids = jts[s.feature.name].values().to(torch.int64)
        dest = s.node_devices[0] + ids // s.block_size
        doff = torch.as_tensor(layout.dest_offset[si],
                               device=ids.device).to(torch.int64)
        entries.append((s.feature, dest,
                        doff[dest.clamp(0, N - 1)] + ids % s.block_size))
    recv = block_dispatch(layout, entries, kjt, env, fill_id=layout.l_stack)
    pooled, ctx = block_lookup(layout, stack_local, *recv, env,
                               lookup_kernel)  # [S, B, D]
    slot_index = {id(s): i for i, s in enumerate(layout.slots)}
    out: Dict[str, torch.Tensor] = {}
    for fname in layout.feature_order:
        pieces = [pooled[slot_index[id(s)]]
                  for s in layout.feature_slots[fname]]
        out[fname] = pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                                  dim=-1)
    return out, ctx


def twrw_backward_local(
    layout: TwRwGroupLayout,
    ctx: Tuple,
    grad_out: Mapping[str, torch.Tensor],
    env: Optional[ShardingEnv] = None,
) -> SparseSegGrad:
    """Each slot's gradient to every rank of the world (an all-gather, the
    reverse of the reduce-scatter); the owner's sparse gradient."""
    env = resolve_env(env, layout.world_size, ctx[1].device)
    g_home = torch.stack([
        grad_out[s.feature.name][:, s.out_offset: s.out_offset + layout.dim]
        .to(torch.float32) for s in layout.slots])  # [S, B, dim]
    return block_backward(layout, ctx, g_home, env)
