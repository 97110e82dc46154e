"""Dynamic resharding: move a live train state to a new sharding plan
(``torchrec_tpu/parallel/dynamic_sharding.py``).

The group layouts' converters express every shard layout as a gather
from, and a scatter into, full per-table weights
(``sharding/{tw,rw,twrw}.py``'s ``*_tables_from_params`` and
``*_params_from_tables``).  A reshard is therefore: every rank gathers
the whole stacks and fused states of the old plan (``DistributedModelParallel.
gather_group_state``, a collective), turns them into per-table weights
and per-table optimizer slots, rebuilds the DMP for the new plan, and
each rank takes its share of both under the new plan.  Everything runs
on the device of the state, as gathers and index writes on the stacks.

The per-table slot arrays (:func:`slots_to_tables`) are plan-independent
for every sharding type, data-parallel groups included, and for float32
and 16-bit optimizer states: a full-width slot moves with its columns,
a rowwise slot with its rows.  A rowwise slot of a column-sharded table
is the mean of its column shards' (each shard kept its own per-row
statistic), and is written back into every column shard.
``Checkpointer`` stores them as the ``fused_tables`` entry, from which
``restore_elastic`` rebuilds the slots under any plan and world size.
Scalar counters (the Adam family's ``step``) move as the largest over
the old groups, so bias correction does not restart.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from torchrec_tpu_torch.parallel.model_parallel import (
    DistributedModelParallel,
    State,
)
from torchrec_tpu_torch.parallel.sharding.rw import (
    rw_params_from_tables,
    rw_tables_from_params,
)
from torchrec_tpu_torch.parallel.sharding.tw import (
    tw_params_from_tables,
    tw_tables_from_params,
)
from torchrec_tpu_torch.parallel.sharding.twrw import (
    table_blocks,
    twrw_params_from_tables,
    twrw_tables_from_params,
)
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan

SCALARS = "__scalars__"


def _tw_rowwise_entries(lay, ranks):
    """(rank position, table, stack offset, rows) of every table-wise
    entry of ``ranks`` (one per column shard)."""
    for i, owner in enumerate(ranks):
        for tname, off, rows, _col in lay.stack_assignment[owner]:
            yield i, tname, off, rows


def _twrw_rowwise_blocks(lay, ranks):
    """(rank position, table, stack offset, first row, rows) of every
    block of ``ranks`` (each (table, column shard) once)."""
    for si, sl in table_blocks(lay):
        R = sl.feature.table_rows
        for bi, d in enumerate(sl.node_devices):
            n = min(sl.block_size, R - bi * sl.block_size)
            if n <= 0:
                break
            if d in ranks:
                yield (ranks.index(d), sl.feature.table_name,
                       int(lay.dest_offset[si, d]), bi * sl.block_size, n)


def _slot_gather(ebc, gname: str, arr: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """One group's slot array in the global layout (every rank's rows)
    -> per-table arrays.  A full-width slot (width == the group's dim)
    goes through the column-correct layout converters; a rowwise slot
    (``[rows]``, viewed as ``[rows, 1]``) is averaged over a table's
    column shards in float64."""
    rows = {c.name: c.num_embeddings for c in ebc.tables}
    vec = arr.dim() == 1
    view = arr[:, None] if vec else arr
    if gname in ebc.dp_groups:
        g = ebc.dp_groups[gname]
        out = {t: view[g.local_offset[t]: g.local_offset[t] + r]
               for t, r in g.table_rows.items()}
    elif gname in ebc.rw_layouts:
        # the row-wise converters ignore the width: column shards do not
        # exist here, so full-width and rowwise slots take one path
        out = rw_tables_from_params(ebc.rw_layouts[gname], view)
    else:
        tw = gname in ebc.tw_layouts
        lay = ebc.tw_layouts[gname] if tw else ebc.twrw_layouts[gname]
        if not vec and view.shape[1] == lay.dim:
            out = (tw_tables_from_params if tw
                   else twrw_tables_from_params)(lay, view)
        else:  # rowwise: the mean over a table's column shards
            L = lay.r_stack if tw else lay.l_stack
            ranks = list(range(lay.world_size))
            acc: Dict[str, torch.Tensor] = {}
            cnt: Dict[str, int] = {}
            if tw:
                for d, t, off, r in _tw_rowwise_entries(lay, ranks):
                    a = acc.setdefault(t, view.new_zeros(
                        (rows[t], view.shape[1]), dtype=torch.float64))
                    a[:r] += view[d * L + off: d * L + off + r]
                    cnt[t] = cnt.get(t, 0) + 1
            else:
                for d, t, off, lo, n in _twrw_rowwise_blocks(lay, ranks):
                    a = acc.setdefault(t, view.new_zeros(
                        (rows[t], view.shape[1]), dtype=torch.float64))
                    a[lo: lo + n] += view[d * L + off: d * L + off + n]
                # each block of every column shard was added once
                cnt = {s.feature.table_name: 0 for s in lay.slots}
                for _, s in table_blocks(lay):
                    cnt[s.feature.table_name] += 1
            out = {t: (a / max(cnt[t], 1)).to(view.dtype)
                   for t, a in acc.items()}
    return {t: (w[:, 0] if vec else w) for t, w in out.items()}


def _slot_scatter(ebc, gname: str, zero: torch.Tensor,
                  tbl: Mapping[str, Any], rank: Optional[int]
                  ) -> torch.Tensor:
    """Inverse of :func:`_slot_gather`: per-table slot arrays -> rank
    ``rank``'s share of the group's slot (every rank's with ``rank=None``),
    shaped and typed like ``zero`` (that share's zeros, which set the
    device and dtype); a rowwise slot goes into every column shard."""
    vec = zero.dim() == 1
    width = 1 if vec else zero.shape[1]
    tbl2 = {t: (torch.as_tensor(v)[:, None] if torch.as_tensor(v).dim() == 1
                else torch.as_tensor(v)) for t, v in tbl.items()}
    dev, dt = zero.device, zero.dtype
    if gname in ebc.dp_groups:
        g = ebc.dp_groups[gname]
        placed = torch.zeros((g.stack_rows, width), dtype=dt, device=dev)
        for t, r in g.table_rows.items():
            if t in tbl2:
                placed[g.local_offset[t]: g.local_offset[t] + r] = (
                    tbl2[t].to(dev, dt))
    elif gname in ebc.rw_layouts:
        lay = dataclasses.replace(ebc.rw_layouts[gname], dim=width)
        placed = rw_params_from_tables(lay, tbl2, dt, dev, rank)
    else:
        tw = gname in ebc.tw_layouts
        lay = ebc.tw_layouts[gname] if tw else ebc.twrw_layouts[gname]
        if width == lay.dim:
            placed = (tw_params_from_tables if tw else twrw_params_from_tables)(
                lay, tbl2, dt, dev, rank)
        else:  # rowwise: the same value into every column shard's rows
            L = lay.r_stack if tw else lay.l_stack
            ranks = list(range(lay.world_size)) if rank is None else [rank]
            placed = torch.zeros((len(ranks) * L, width), dtype=dt,
                                 device=dev)
            if tw:
                for i, t, off, r in _tw_rowwise_entries(lay, ranks):
                    if t in tbl2:
                        placed[i * L + off: i * L + off + r] = (
                            tbl2[t][:r].to(dev, dt))
            else:
                for i, t, off, lo, n in _twrw_rowwise_blocks(lay, ranks):
                    if t in tbl2:
                        placed[i * L + off: i * L + off + n] = (
                            tbl2[t][lo: lo + n].to(dev, dt))
    return placed[:, 0] if vec else placed


def _slots_to_tables(dmp, fused_global) -> Dict[str, Dict[str, Any]]:
    """Global-layout fused states -> per-table slot arrays
    ``{table: {slot: array}}``, the scalar counters (the largest over the
    groups) under :data:`SCALARS`."""
    ebc = dmp.sharded_ebc
    out: Dict[str, Dict[str, Any]] = {}
    scalars: Dict[str, int] = {}
    for gname, slots in fused_global.items():
        for sname, arr in slots.items():
            if not isinstance(arr, torch.Tensor) or arr.dim() == 0:
                scalars[sname] = max(scalars.get(sname, 0), int(arr))
                continue
            for t, w in _slot_gather(ebc, gname, arr).items():
                out.setdefault(t, {})[sname] = w
    if scalars:
        out[SCALARS] = scalars
    return out


def slots_to_tables(dmp: DistributedModelParallel, state: State,
                    replica0: bool = True) -> Dict[str, Dict[str, Any]]:
    """The fused optimizer slots of ``state`` (this rank's share) as
    plan-independent per-table arrays ``{table: {slot: array}}`` on the
    state's device, plus the scalar counters under ``"__scalars__"``.
    Under 2D parallelism ``replica0`` takes replica 0's copy (False: the
    replicas' mean, what ``Checkpointer`` stores).  A collective: every
    rank calls it and gets every table."""
    _, fused = dmp.gather_group_state(state, replica_mean=not replica0)
    return _slots_to_tables(dmp, fused)


def scatter_slots(dmp: DistributedModelParallel,
                  fused: Dict[str, Dict[str, Any]],
                  slot_tables: Mapping[str, Mapping[str, Any]]
                  ) -> Dict[str, Dict[str, Any]]:
    """Inverse of :func:`slots_to_tables` for ``dmp``'s plan: per-table
    slot arrays placed into ``fused`` (this process's freshly initialized
    share, e.g. ``sharded_ebc.init_fused_state``), in place, and returned;
    the scalar counters carry over.  A slot no table has stays zero, with
    a warning."""
    ebc = dmp.sharded_ebc
    scalars = slot_tables.get(SCALARS, {})
    placed: Dict[str, Dict[str, torch.Tensor]] = {}
    for gname, slots in fused.items():
        for sname, zero in slots.items():
            if not isinstance(zero, torch.Tensor) or zero.dim() == 0:
                if sname in scalars:
                    slots[sname] = int(scalars[sname])
                continue
            tbl = {t: v[sname] for t, v in slot_tables.items()
                   if t != SCALARS and sname in v}
            if not tbl:
                warnings.warn(f"optimizer slot {gname}/{sname} has no "
                              "transferable source; it stays zero")
                continue
            placed.setdefault(gname, {})[sname] = _slot_scatter(
                ebc, gname, _model_rank_zero(dmp, gname, zero), tbl,
                None if gname in ebc.dp_groups else dmp.env.rank)
    for gname, slots in dmp._local_share(placed).items():
        for sname, share in slots.items():
            fused[gname][sname].copy_(share)
    return fused


def _model_rank_zero(dmp, gname: str, zero: torch.Tensor) -> torch.Tensor:
    """A zero slot of the model rank's whole stack of group ``gname``
    (``zero`` is this process's share: a slice under FULLY_SHARDED)."""
    rows = (dmp.sharded_ebc.dp_groups[gname].stack_rows
            if gname in dmp.sharded_ebc.dp_groups
            else dmp.sharded_ebc.local_rows(gname))
    return zero.new_zeros((rows,) + tuple(zero.shape[1:]))


def reshard(
    dmp: DistributedModelParallel,
    state: State,
    new_plan: EmbeddingModuleShardingPlan,
) -> Tuple[DistributedModelParallel, State]:
    """Move a live train state onto ``new_plan`` (the reference's
    ``DMP.reshard``): returns ``(new_dmp, new_state)``, weights and
    optimizer slots carried exactly, the dense parameters, their
    optimizer state and the step shared with ``state``.  A collective:
    every rank gathers the old stacks and slots, then takes its share
    under the new plan.  Under 2D parallelism the replicas' mean moves."""
    ebc = dmp.sharded_ebc
    tables, fused = dmp.gather_group_state(state, replica_mean=True)
    weights = ebc.tables_to_weights(tables)
    slot_tables = _slots_to_tables(dmp, fused)
    new_dmp = clone_dmp_for_plan(dmp, new_plan)
    new_ebc = new_dmp.sharded_ebc
    new_tables = new_dmp._local_share(new_ebc.params_from_tables(
        weights, new_dmp.table_dtype, new_dmp.device,
        rank=new_dmp.env.rank))
    new_fused = new_dmp._local_share(new_ebc.init_fused_state(
        new_dmp.fused_config, new_dmp.device))
    new_fused = scatter_slots(new_dmp, new_fused, slot_tables)
    return new_dmp, {"dense": state["dense"],
                     "dense_opt": state["dense_opt"],
                     "tables": new_tables, "fused": new_fused,
                     "step": state["step"]}


def clone_dmp_for_plan(
    dmp: DistributedModelParallel,
    new_plan: EmbeddingModuleShardingPlan,
) -> DistributedModelParallel:
    """``dmp`` rebuilt under ``new_plan``: the same model, tables, env,
    optimizers, schedule, wire precision, row alignment, guardrails,
    table dtype, the kernels it was built with (or the registry's) and
    feature caps (:func:`_caps_from_layouts`); a ``DMPCollection`` keeps
    its strategy and sync interval."""
    ebc = dmp.sharded_ebc
    extra: Dict[str, Any] = {}
    if hasattr(dmp, "sync_interval"):
        extra = {"sync_interval": dmp.sync_interval,
                 "sharding_strategy": dmp.sharding_strategy}
    return type(dmp)(
        dmp.model, ebc.tables, new_plan, dmp.batch_size,
        _caps_from_layouts(ebc),
        fused_config=dmp.fused_config,
        dense_optimizer=dmp.dense_tx,
        table_dtype=dmp.table_dtype,
        lookup_kernel=dmp._kernel_args[0],
        update_kernel=dmp._kernel_args[1],
        env=dmp.env,
        sparse_lr_schedule=dmp.sparse_lr_schedule,
        qcomms=dmp.qcomms,
        row_align=dmp.row_align,
        guardrails=dmp.guardrails,
        **extra,
    )


def _caps_from_layouts(ebc) -> Dict[str, int]:
    """Every feature's id capacity, read back from the group layouts."""
    caps: Dict[str, int] = {}
    for lay in list(ebc.tw_layouts.values()) + list(
            ebc.twrw_layouts.values()):
        for s in lay.slots:
            caps[s.feature.name] = s.feature.cap
    for lay in ebc.rw_layouts.values():
        for f in lay.features:
            caps[f.name] = f.cap
    for g in ebc.dp_groups.values():
        for f in g.features:
            caps[f.name] = f.cap
    return caps
