"""Plan compilation and parameter plumbing for sharded embedding modules
(a subset of ``torchrec_tpu/parallel/grouped.py``): tables are grouped by
(sharding type, shard dim) into stacked layouts, one stack per group on
each rank.

Kinds: TABLE_WISE, COLUMN_WISE and TABLE_COLUMN_WISE compile to table-wise
layouts (a column shard is a table of its own, ``sharding/tw.py``),
ROW_WISE to row-wise ones (``sharding/rw.py``), TABLE_ROW_WISE and
GRID_SHARD to block-shard ones (``sharding/twrw.py``), and DATA_PARALLEL
to a replicated :class:`DpGroup` per dim.  The parameter functions take
and give the calling rank's share: ``rank`` picks it, and a DP group's
share is the whole stack.

``qcomms`` sets every sharded layout's wire precision and ``row_align``
rounds every sharded stack up to a multiple (``DMPCollection``
FULLY_SHARDED); a sequence module (``allow_block_sharding=False``)
rejects TABLE_ROW_WISE and GRID_SHARD, which have no sequence variant.
:func:`step_every_row` makes a data-parallel group's update step every
row of its stack, as the JAX package's dense all-reduced update does.

A ROW_WISE table whose plan sets ``dedup`` compiles to a row-wise layout
of the dedup'd input dist, in a group of its own (``rw_dedup_d{dim}``:
its wire layout differs), whose distinct-id capacity is sized by the
smallest ``dedup_factor`` its tables claim; a sequence module keeps the
plain layout, as the JAX package does.  :attr:`GroupedLayouts.
feature_rows` are the tables' rows in feature order, the bounds of the
traced id sanitizer.

On a two-level world (``hier_topo``, a ``sharding.hier.HierTopology``)
the ROW_WISE, TABLE_ROW_WISE and GRID_SHARD tables whose plan sets
``hier`` compile to the two-level ICI/DCN dists, in groups of their own
(``rw_hier_d{dim}``, ``rw_hier_dedup_d{dim}``, ``twrw_hier_d{dim}``,
``twrw_hier_dedup_d{dim}``; a block-shard group dedups only there), each
group's distinct-row capacity sized by the smallest ``hier_factor`` its
tables claim.  Without a two-level world the flag is inert, so one plan
runs on either world; a sequence module keeps the flat layouts.

Left out: host-cached tables (ROADMAP A10), on which a plan raises, and
``param_specs``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.ops.fused_update import (
    FusedOptimConfig,
    SparseSegGrad,
    init_optimizer_state,
)
from torchrec_tpu_torch.parallel.comm import all_gather
from torchrec_tpu_torch.parallel.qcomm import QCommsConfig
from torchrec_tpu_torch.parallel.sharding.common import (
    FeatureSpec,
    feature_specs_for_tables,
)
from torchrec_tpu_torch.parallel.sharding.rw import (
    RwGroupLayout,
    build_rw_layout,
    rw_params_from_tables,
    rw_tables_from_params,
)
from torchrec_tpu_torch.parallel.sharding.tw import (
    TwGroupLayout,
    WeightLike,
    build_tw_layout,
    tw_params_from_tables,
    tw_tables_from_params,
)
from torchrec_tpu_torch.parallel.sharding.twrw import (
    TwRwGroupLayout,
    build_twrw_layout,
    table_blocks,
    twrw_params_from_tables,
    twrw_tables_from_params,
)
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    EmbeddingModuleShardingPlan,
    ShardingType,
)

_I32_MAX = (1 << 31) - 1
_TW_KINDS = (ShardingType.TABLE_WISE, ShardingType.COLUMN_WISE,
             ShardingType.TABLE_COLUMN_WISE)


@dataclasses.dataclass
class DpGroup:
    """Replicated (data-parallel) tables stacked into one array, the same
    on every rank."""

    name: str
    features: List[FeatureSpec]
    table_rows: Dict[str, int]
    local_offset: Dict[str, int]
    stack_rows: int
    dim: int


def step_every_row(sg: SparseSegGrad, num_rows: int) -> SparseSegGrad:
    """``sg`` with one more slot a row for every row of a ``num_rows``
    stack that no kept slot of ``sg`` touches: weight 1 on an appended
    zero gradient segment.  The fused update then steps every row once,
    as the JAX package's data-parallel update of every row with its
    all-reduced dense gradient does (a zero gradient still moves Adam's
    momentum and applies weight decay).  The touched rows keep exactly
    their slots, in their order: the appended slots of those rows are not
    valid, and a stable sort by row puts them last.  No host sync."""
    dev = sg.ids.device
    ok = sg.ok() & (sg.ids >= 0) & (sg.ids < num_rows)
    touched = torch.zeros(num_rows + 1, dtype=torch.bool, device=dev)
    touched[torch.where(ok, sg.ids.to(torch.int64), num_rows)] = True
    S, D = sg.grad_seg.shape
    rows = torch.arange(num_rows, device=dev, dtype=sg.ids.dtype)
    w = (torch.ones(sg.ids.shape, dtype=torch.float32, device=dev)
         if sg.weights is None else sg.weights)
    return SparseSegGrad(
        torch.cat([sg.ids, rows]),
        torch.cat([ok, ~touched[:num_rows]]),
        torch.cat([sg.segments,
                   torch.full((num_rows,), S, dtype=sg.segments.dtype,
                              device=dev)]),
        torch.cat([w, torch.ones(num_rows, dtype=torch.float32,
                                 device=dev)]),
        torch.cat([sg.grad_seg, sg.grad_seg.new_zeros((1, D))]))


@dataclasses.dataclass
class GroupedLayouts:
    """Output of :func:`classify_plan`: the layouts of each kind by group
    name and the features in KJT/KT order."""

    tw_layouts: Dict[str, TwGroupLayout]
    rw_layouts: Dict[str, RwGroupLayout]
    twrw_layouts: Dict[str, TwRwGroupLayout]
    dp_groups: Dict[str, DpGroup]
    feature_order: Tuple[str, ...]
    feature_dims: Tuple[int, ...]
    # per feature (feature_order) its table's rows: the sanitizer's bounds
    feature_rows: Tuple[int, ...] = ()


def _shard_dim(cfg, n: int) -> int:
    d = cfg.embedding_dim // max(1, n)
    if d * max(1, n) != cfg.embedding_dim:
        raise ValueError(f"{cfg.name}: dim {cfg.embedding_dim} does not "
                         f"split into {n} column shards")
    return d


def classify_plan(
    tables: Sequence[EmbeddingBagConfig],
    plan: EmbeddingModuleShardingPlan,
    world_size: int,
    batch_size: int,
    feature_caps: Dict[str, int],
    allow_block_sharding: bool = True,
    qcomms: Optional[QCommsConfig] = None,
    row_align: int = 1,
    hier_topo=None,
) -> GroupedLayouts:
    """Group the plan's tables by (kind, shard dim) and compile their
    layouts: groups ``tw_d{dim}``, ``rw_d{dim}``, ``twrw_d{dim}`` and
    ``dp_d{dim}`` (module docstring for the options and the two-level
    groups of ``hier_topo``)."""
    specs = feature_specs_for_tables(tables, feature_caps)
    by_table: Dict[str, List[FeatureSpec]] = {}
    for s in specs:
        by_table.setdefault(s.table_name, []).append(s)
    tw_feats: Dict[int, List[FeatureSpec]] = {}
    tw_owner: Dict[str, List[int]] = {}
    rw_feats: Dict[Tuple[int, bool, bool], List[FeatureSpec]] = {}
    rw_dedup_factor: Dict[int, float] = {}
    rw_hier_factor: Dict[int, float] = {}
    twrw_feats: Dict[Tuple[int, bool, bool], List[FeatureSpec]] = {}
    twrw_hier_factor: Dict[int, float] = {}
    twrw_nodes: Dict[str, List[List[int]]] = {}
    dp_feats: Dict[int, List[FeatureSpec]] = {}
    for cfg in tables:
        ps = plan[cfg.name]
        st = ps.sharding_type
        feats = by_table.get(cfg.name, [])
        hier_on = (bool(getattr(ps, "hier", False)) and hier_topo is not None
                   and allow_block_sharding)
        hier_factor = max(1.0, getattr(ps, "hier_factor", 1.0) or 1.0)
        if ps.compute_kernel == EmbeddingComputeKernel.FUSED_HOST_CACHED:
            raise NotImplementedError(
                f"{cfg.name}: the host-cached kernel (FUSED_HOST_CACHED) "
                "needs tiered storage, which is not ported (ROADMAP A10)")
        if ps.ranks is not None and any(not 0 <= r < world_size
                                        for r in ps.ranks):
            raise ValueError(f"{cfg.name}: ranks {ps.ranks} outside a world "
                             f"of {world_size}")
        if st in _TW_KINDS:
            if not ps.ranks:
                raise ValueError(f"{cfg.name}: a {st.value} plan needs ranks")
            if ps.num_col_shards not in (1, len(ps.ranks)):
                raise ValueError(f"{cfg.name}: num_col_shards="
                                 f"{ps.num_col_shards} disagrees with ranks="
                                 f"{ps.ranks} (one rank per column shard)")
            d = _shard_dim(cfg, len(ps.ranks))
            tw_owner[cfg.name] = list(ps.ranks)
            for s in feats:
                tw_feats.setdefault(d, []).append(dataclasses.replace(s,
                                                                      dim=d))
        elif st == ShardingType.ROW_WISE:
            dedup = bool(ps.dedup) and allow_block_sharding
            d = cfg.embedding_dim
            for s in feats:
                rw_feats.setdefault((d, dedup, hier_on), []).append(s)
            if hier_on:
                rw_hier_factor[d] = min(rw_hier_factor.get(d, float("inf")),
                                        hier_factor)
            if dedup:
                # one capacity a group: the smallest claimed factor wins
                rw_dedup_factor[d] = min(
                    rw_dedup_factor.get(d, float("inf")),
                    max(1.0, ps.dedup_factor or 1.0))
        elif st in (ShardingType.TABLE_ROW_WISE, ShardingType.GRID_SHARD):
            if not allow_block_sharding:
                raise NotImplementedError(
                    f"{cfg.name}: {st.value} has no sequence variant")
            if not ps.ranks:
                raise ValueError(f"{cfg.name}: a {st.value} plan needs ranks")
            n_cw = max(1, ps.num_col_shards)
            if len(ps.ranks) % n_cw:
                raise ValueError(f"{cfg.name}: ranks must split evenly into "
                                 f"{n_cw} column-shard nodes")
            per = len(ps.ranks) // n_cw
            twrw_nodes[cfg.name] = [list(ps.ranks[i * per:(i + 1) * per])
                                    for i in range(n_cw)]
            d = _shard_dim(cfg, n_cw)
            # a block-shard group dedups only on the two-level dist
            dedup = hier_on and bool(getattr(ps, "dedup", False))
            for s in feats:
                twrw_feats.setdefault((d, dedup, hier_on), []).append(
                    dataclasses.replace(s, dim=d))
            if hier_on:
                twrw_hier_factor[d] = min(
                    twrw_hier_factor.get(d, float("inf")), hier_factor)
        elif st == ShardingType.DATA_PARALLEL:
            for s in feats:
                dp_feats.setdefault(s.dim, []).append(s)
        else:
            raise NotImplementedError(f"sharding type {st}")

    tw_layouts = {
        f"tw_d{d}": build_tw_layout(f"tw_d{d}", f, tw_owner, world_size,
                                    batch_size, qcomms, row_align)
        for d, f in sorted(tw_feats.items())}
    def gname(kind, d, dedup, hier):
        return (kind + ("_hier" if hier else "") + ("_dedup" if dedup else "")
                + f"_d{d}")

    rw_layouts = {}
    for (d, dedup, hier), f in sorted(rw_feats.items()):
        name = gname("rw", d, dedup, hier)
        rw_layouts[name] = build_rw_layout(
            name, f, world_size, batch_size, qcomms, row_align, dedup=dedup,
            dedup_factor=rw_dedup_factor.get(d, 1.0),
            hier=hier_topo if hier else None,
            hier_factor=rw_hier_factor.get(d, 1.0))
    twrw_layouts = {}
    for (d, dedup, hier), f in sorted(twrw_feats.items()):
        name = gname("twrw", d, dedup, hier)
        twrw_layouts[name] = build_twrw_layout(
            name, f, twrw_nodes, world_size, batch_size, qcomms, row_align,
            dedup=dedup, hier=hier_topo if hier else None,
            hier_factor=twrw_hier_factor.get(d, 1.0))
    dp_groups = {}
    for d, feats in sorted(dp_feats.items()):
        rows, off, acc = {}, {}, 0
        for s in feats:
            if s.table_name not in rows:
                rows[s.table_name] = s.table_rows
                off[s.table_name] = acc
                acc += s.table_rows
        dp_groups[f"dp_d{d}"] = DpGroup(f"dp_d{d}", feats, rows, off,
                                        max(1, acc), d)
    # the kernels index a stack with int32 row ids
    stack_sizes = {
        **{n: l.world_size * l.r_stack for n, l in tw_layouts.items()},
        **{n: l.world_size * l.l_stack for n, l in rw_layouts.items()},
        **{n: l.world_size * l.l_stack for n, l in twrw_layouts.items()},
        **{n: g.stack_rows for n, g in dp_groups.items()},
    }
    for n, rows in stack_sizes.items():
        if rows > _I32_MAX:
            raise ValueError(f"group {n}: {rows} stacked rows exceed the "
                             "int32 index range")
    return GroupedLayouts(
        tw_layouts=tw_layouts, rw_layouts=rw_layouts,
        twrw_layouts=twrw_layouts, dp_groups=dp_groups,
        feature_order=tuple(s.name for s in specs),
        feature_dims=tuple(s.dim for s in specs),
        feature_rows=tuple(s.table_rows for s in specs),
    )


class GroupedShardingBase:
    """Parameter and optimizer-state plumbing of the sharded modules.
    Subclasses are dataclasses exposing ``tables``, ``world_size``,
    ``tw_layouts``, ``rw_layouts``, ``twrw_layouts`` and ``dp_groups``."""

    @property
    def sharded_layouts(self) -> Dict[str, object]:
        """Every row-sharded group's layout (TW, RW, TWRW), in group
        order."""
        return {**self.tw_layouts, **self.rw_layouts, **self.twrw_layouts}

    @property
    def group_names(self) -> Tuple[str, ...]:
        """Every group, the sharded ones first, then the DP ones."""
        return tuple(self.sharded_layouts) + tuple(self.dp_groups)

    def local_rows(self, name: str) -> int:
        """The rows of group ``name``'s stack on one rank."""
        if name in self.dp_groups:
            return self.dp_groups[name].stack_rows
        lay = self.sharded_layouts[name]
        return lay.r_stack if isinstance(lay, TwGroupLayout) else lay.l_stack

    def params_from_tables(
        self,
        table_weights: Mapping[str, WeightLike],
        dtype: torch.dtype = torch.float32,
        device=None,
        rank: Optional[int] = 0,
    ) -> Dict[str, torch.Tensor]:
        """Table-name-keyed full weights -> rank ``rank``'s group stacks
        (``rank=None``: every rank's rows, the JAX package's global
        stacks; a DP group's stack either way)."""
        out: Dict[str, torch.Tensor] = {}
        for fn, layouts in ((tw_params_from_tables, self.tw_layouts),
                            (rw_params_from_tables, self.rw_layouts),
                            (twrw_params_from_tables, self.twrw_layouts)):
            for name, lay in layouts.items():
                out[name] = fn(lay, table_weights, dtype, device, rank)
        for name, g in self.dp_groups.items():
            buf = torch.zeros((g.stack_rows, g.dim), dtype=dtype,
                              device=device)
            for t, r in g.table_rows.items():
                buf[g.local_offset[t]: g.local_offset[t] + r] = (
                    torch.as_tensor(table_weights[t]).to(buf.device))
            out[name] = buf
        return out

    def gather_stacks(self, params: Mapping[str, torch.Tensor],
                      env) -> Dict[str, torch.Tensor]:
        """Every rank's stacks from each rank's own (an all-gather per
        sharded group over ``env``, a collective: every rank calls it):
        the input of :meth:`tables_to_weights`."""
        return {name: t if name in self.dp_groups
                else all_gather(t, env).flatten(0, 1)
                for name, t in params.items()}

    def tables_to_weights(
        self, params: Mapping[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """Every rank's group stacks (a sharded group's ranks concatenated
        in rank order, ``[N * rows, dim]``; a DP group's one stack) ->
        table-name-keyed full weights."""
        out: Dict[str, torch.Tensor] = {}
        for fn, layouts in ((tw_tables_from_params, self.tw_layouts),
                            (rw_tables_from_params, self.rw_layouts),
                            (twrw_tables_from_params, self.twrw_layouts)):
            for name, lay in layouts.items():
                out.update(fn(lay, params[name]))
        for name, g in self.dp_groups.items():
            for t, r in g.table_rows.items():
                out[t] = params[name][g.local_offset[t]: g.local_offset[t] + r]
        return out

    def init_params(
        self,
        generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
        rank: int = 0,
    ) -> Dict[str, torch.Tensor]:
        """Rank ``rank``'s fresh group stacks on the generator's device:
        every table drawn by its config's ``init_fn`` in table order (the
        same draws on every rank), then cast to ``dtype``."""
        weights = {c.name: c.init_fn(generator) for c in self.tables}
        return self.params_from_tables(weights, dtype, generator.device,
                                       rank)

    def init_fused_state(
        self, config: FusedOptimConfig, device=None
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fused-optimizer state per group in one rank's stack layout, in
        the optimizer's layout of ``ops/fused_update.py`` (rowwise
        Adagrad's ``[R]`` momentum, Adagrad's ``[R, D]``, the Adam
        family's ``m``, ``v`` and ``step``)."""
        dims = {**{n: l.dim for n, l in self.sharded_layouts.items()},
                **{n: g.dim for n, g in self.dp_groups.items()}}
        return {name: init_optimizer_state(config, self.local_rows(name),
                                           dims[name], device)
                for name in self.group_names}

    def stack_rows_for_table(
        self, table: str, rows: np.ndarray, rank: int = 0
    ) -> Tuple[str, np.ndarray, np.ndarray]:
        """A table's row ids -> (its group, the rows of rank ``rank``'s
        stack that hold them, and which of ``rows`` they are): one entry
        per column shard on the rank that holds the row.  Rows other
        ranks hold are left out."""
        rows = np.ascontiguousarray(rows, np.int64)
        idx = np.arange(rows.size)
        for name, lay in self.tw_layouts.items():
            hits, which = [], []
            for owner, entries in lay.stack_assignment.items():
                for tname, off, _, _ in entries:
                    if tname == table and owner == rank:
                        hits.append(off + rows)
                        which.append(idx)
            if any(tname == table for v in lay.stack_assignment.values()
                   for tname, *_ in v):
                return name, _cat(hits), _cat(which)
        for name, lay in self.rw_layouts.items():
            if table in lay.block_size:
                bs, lo = lay.block_size[table], lay.local_offset[table]
                mine = rows // bs == rank
                return name, lo + rows[mine] % bs, idx[mine]
        for name, lay in self.twrw_layouts.items():
            hits, which, found = [], [], False
            for si, sl in table_blocks(lay):
                if sl.feature.table_name != table:
                    continue
                found = True
                if rank not in sl.node_devices:
                    continue
                mine = rows // sl.block_size == sl.node_devices.index(rank)
                hits.append(int(lay.dest_offset[si, rank])
                            + rows[mine] % sl.block_size)
                which.append(idx[mine])
            if found:
                return name, _cat(hits), _cat(which)
        for name, g in self.dp_groups.items():
            if table in g.table_rows:
                return name, g.local_offset[table] + rows, idx
        raise KeyError(f"table {table} not found in any group")

    def feature_table_info(
        self, dtype_bytes: int = 4
    ) -> Dict[str, Tuple[str, int]]:
        """{feature: (table name, row bytes)}: a row prices at
        ``embedding_dim * dtype_bytes``."""
        return {f: (cfg.name, cfg.embedding_dim * int(dtype_bytes))
                for cfg in self.tables for f in cfg.feature_names}


def _cat(parts: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros((0,), np.int64)
