"""Analytic perf + storage estimation per sharding option.

Reference: ``planner/shard_estimators.py`` — ``EmbeddingPerfEstimator``
(:71, fwd/bwd compute + comms from bandwidth constants) and
``EmbeddingStorageEstimator`` (:126, ``calculate_shard_storages`` :318).
The model, copied line for line from the JAX package's so that both
planners price an option to the same float: lookup cost = gathered bytes /
HBM bw; comms cost = per-device all-to-all / reduce-scatter bytes over the
intra-node link (``ici_bw``; the inter-node ``dcn_bw`` when a transfer
crosses nodes); the fused backward adds the optimizer read-modify-write
traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from torchrec_tpu_torch.parallel.planner.types import (
    ParameterConstraints,
    Perf,
    Shard,
    ShardingOption,
    Storage,
    Topology,
    zipf_hit_rate,
)
from torchrec_tpu_torch.parallel.types import EmbeddingComputeKernel, ShardingType

BYTES_F32 = 4


@dataclasses.dataclass
class EstimatorContext:
    """Inputs shared by perf/storage estimators: batch size and
    per-table constraints.  (Duplication factors ride on the
    ``ShardingOption`` itself — the enumerator resolves constraint vs
    calibrated default once, so the auto decision and the pricing use
    the same number.)"""
    batch_size_per_device: int = 512
    constraints: Optional[Dict[str, ParameterConstraints]] = None
    # calibrated real-ids / shipped-id-slots under capacity bucketing
    # (a calibration run writes it; planners.py wires it in) —
    # the fallback when a table's constraints don't pin their own
    padding_efficiency_default: float = 1.0
    # the trainer runs the hierarchical two-level ICI/DCN dists
    # (EmbeddingShardingPlanner(hierarchical=True)): on a multi-slice
    # topology the RW/TWRW comms terms are priced per link class — the
    # slice-local legs at ici_bw, the cross-slice exchange at dcn_bw
    # shrunk by the calibrated ``hier_dcn_reduction`` (a
    # calibration run; the dedup/bucketing calibration pattern)
    hierarchical: bool = False
    hier_dcn_reduction: float = 1.0
    # per-TABLE fitted scalars ({table: {"padding_efficiency": ...}},
    # scripts/fit_placement_model.py via the calibration ledger's
    # ``tables`` entry): resolved between an explicit constraint and
    # the global calibrated default
    per_table: Optional[Dict[str, Dict[str, float]]] = None

    def pooling(self, table: str) -> float:
        if self.constraints and table in self.constraints:
            return self.constraints[table].pooling_factor
        return ParameterConstraints().pooling_factor

    def padding_efficiency(self, table: str) -> float:
        """Real ids / shipped id slots in (0, 1] for this table's id
        dists: the id wires carry capacity-BUCKETED slots, not raw ids,
        so the perf model divides id-proportional wire terms by this
        (an un-bucketed/uncalibrated stack keeps 1.0 = raw-id pricing)."""
        eff = None
        if self.constraints and table in self.constraints:
            eff = self.constraints[table].padding_efficiency
        if eff is None and self.per_table:
            eff = self.per_table.get(table, {}).get("padding_efficiency")
        if eff is None:
            eff = self.padding_efficiency_default
        return min(1.0, max(1e-3, float(eff)))

    @classmethod
    def from_telemetry(
        cls,
        assumptions,
        live: Dict[str, Dict[str, float]],
        base: Optional["EstimatorContext"] = None,
    ) -> "EstimatorContext":
        """An estimator context priced with LIVE telemetry instead of
        plan-time beliefs — the repricing input of the online-migration
        replan (reliability/migration.py, docs/PLANNER.md "Live-telemetry
        repricing").

        ``assumptions`` is the running plan's stamped
        ``obs.PlanAssumptions`` (table set, pooling, topology knobs);
        ``live`` maps table -> observed signals, the shape
        ``HealthMonitor.live_signals()`` returns: ``occupancy``
        overrides the table's padding efficiency (real ids per shipped
        slot IS the occupancy rate the monitor tracks),
        ``hit_rate`` refits the table's Zipf exponent through
        :func:`fit_zipf_exponent` (so cached-kernel miss traffic is
        priced at the observed skew), and an explicit ``duplication``
        overrides the dedup factor.  ``base`` (default: a context built
        from the assumptions) supplies constraints that live values then
        override via per-table ``ParameterConstraints`` clones — the
        returned context's ``constraints`` can seed a fresh planner so
        the ENUMERATION decisions (dedup auto, tiering) see the same
        live numbers as the pricing."""
        import copy

        from torchrec_tpu_torch.parallel.planner.types import fit_zipf_exponent

        if base is None:
            base = cls(
                batch_size_per_device=assumptions.batch_size_per_device,
                hierarchical=assumptions.hierarchical,
                hier_dcn_reduction=assumptions.hier_dcn_reduction,
            )
        constraints = dict(base.constraints or {})
        for table, ta in assumptions.tables.items():
            c = copy.deepcopy(
                constraints.get(table, ParameterConstraints())
            )
            sig = live.get(table, {})
            if c.pooling_factor == ParameterConstraints().pooling_factor:
                # pin the plan-time pooling so repricing compares like
                # for like when the base constraints never set it
                if ta.pooling_factor:
                    c.pooling_factor = ta.pooling_factor
            # seed every unpinned scalar with the PLAN-TIME belief, so
            # a table without a live signal reprices at the same
            # numbers the running plan was priced with — the context
            # is "plan-time beliefs overridden by live evidence"
            if c.padding_efficiency is None:
                c.padding_efficiency = ta.padding_efficiency
            if c.zipf_exponent is None:
                c.zipf_exponent = ta.zipf_exponent
            if c.duplication_factor is None and ta.duplication_factor:
                c.duplication_factor = ta.duplication_factor
            occ = sig.get("occupancy")
            if occ is not None:
                c.padding_efficiency = min(1.0, max(1e-3, float(occ)))
            hr = sig.get("hit_rate")
            if hr is not None and ta.cache_load_factor is not None:
                c.zipf_exponent = fit_zipf_exponent(
                    float(hr), max(1, ta.num_embeddings),
                    ta.cache_load_factor,
                )
            dup = sig.get("duplication")
            if dup is not None:
                c.duplication_factor = max(1.0, float(dup))
            constraints[table] = c
        return cls(
            batch_size_per_device=base.batch_size_per_device,
            constraints=constraints,
            padding_efficiency_default=base.padding_efficiency_default,
            hierarchical=base.hierarchical,
            hier_dcn_reduction=base.hier_dcn_reduction,
            per_table=base.per_table,
        )


class EmbeddingPerfEstimator:
    """Fill ``shard.perf`` for every option."""

    def __init__(self, topology: Topology, ctx: EstimatorContext):
        self.t = topology
        self.ctx = ctx

    def estimate(self, options) -> None:
        for opt in options:
            self._estimate_option(opt)

    def _estimate_option(self, opt: ShardingOption) -> None:
        t = self.t
        N = t.world_size
        B = self.ctx.batch_size_per_device
        P = self.ctx.pooling(opt.name)
        D_full = opt.embedding_dim
        st = opt.sharding_type
        n_shards = max(1, len(opt.shards))

        # per-device ids that touch this table per step (global batch view)
        global_ids = N * B * P
        # the id wires ship capacity-bucketed SLOTS, not raw ids: under
        # adaptive bucketing (train_pipeline.BucketedStepCache) shipped
        # slots ~= real ids / padding_efficiency (measured by a calibration run); every id-proportional wire term below is
        # priced at those expected bucketed bytes
        pad_eff = self.ctx.padding_efficiency(opt.name)
        # dedup'd RW: only distinct ids are looked up, scattered, and
        # wired — the duplication factor divides all id-proportional
        # terms (TorchRec input-dist dedup; Zipf streams measured by
        # a calibration run feed the calibrated factor).  The
        # factor rides on the option itself (set by the enumerator, the
        # same value that made the auto decision) so pricing and the
        # enable decision cannot drift.
        dup = max(1.0, opt.duplication_factor) if opt.dedup else 1.0

        for shard in opt.shards:
            rows, cols = shard.size
            # fraction of lookups landing on this shard
            if st in (ShardingType.ROW_WISE, ShardingType.TABLE_ROW_WISE,
                      ShardingType.GRID_SHARD):
                frac = max(rows, 1) / max(opt.num_embeddings, 1)
            elif st == ShardingType.DATA_PARALLEL:
                frac = 1.0 / N  # each replica looks up its own batch only
            else:  # TW/CW: whole table's traffic on the owner
                frac = 1.0
            ids_here = global_ids * frac
            distinct_here = ids_here / dup

            lookup_bytes = distinct_here * cols * BYTES_F32
            fwd_compute = lookup_bytes / t.hbm_bw
            # fused backward: read grad rows + momentum RMW + weight RMW;
            # with dedup the grads arrive pre-aggregated, so every term
            # scales with the distinct count
            bwd_compute = 3 * lookup_bytes / t.hbm_bw
            prefetch = 0.0

            if opt.compute_kernel == EmbeddingComputeKernel.FUSED_HOST_CACHED:
                # tiered/host-offloaded cache: misses fetch rows over
                # the host link, evictions write back (reference
                # UVM-caching perf model, shard_estimators.py prefetch
                # terms).  Miss rate: with a calibrated Zipf exponent
                # (ParameterConstraints.zipf_exponent / a calibration
                # run) the expected hit rate is the mass of the
                # cached head of the rank distribution — the steady
                # state the tiered LFU-with-aging eviction converges to
                # (tiered/storage.py); exponent 0 keeps the uniform
                # upper bound the scale-up proposer shrinks.
                clf = min(max(opt.cache_load_factor or 0.0, 0.0), 1.0)
                miss = 1.0 - zipf_hit_rate(
                    clf, max(1, opt.num_embeddings), opt.zipf_exponent
                )
                # id stream always round-trips to the host id-transformer
                # (slot remap), even at miss=0 — so a fully-cached table
                # still ranks (slightly) behind plain FUSED
                host_bytes = miss * ids_here * cols * BYTES_F32 + ids_here * 8
                # cache fill + eviction write-back ride the host link —
                # tracked as prefetch (reference Perf.prefetch_compute)
                prefetch += 2 * host_bytes / t.host_bw

            # comms per step attributable to this shard (per-chip bytes)
            if st == ShardingType.DATA_PARALLEL:
                # allreduce of the dense gradient ~ 2 * table bytes / N
                comm_bytes = 2 * rows * cols * BYTES_F32 / N
                fwd_comms = 0.0
                bwd_comms = comm_bytes / t.comms_bw(True)
            elif st in (ShardingType.TABLE_WISE, ShardingType.COLUMN_WISE):
                # input ids a2a (small) + pooled output a2a back
                out_bytes = N * B * cols * BYTES_F32
                in_bytes = ids_here * 8 / pad_eff
                fwd_comms = (in_bytes + out_bytes) / t.comms_bw(True)
                bwd_comms = out_bytes / t.comms_bw(True)
            else:  # RW / TWRW / GRID: bucketized a2a + reduce-scatter
                out_bytes = B * cols * BYTES_F32 * n_shards / N
                # every non-dedup bucketized dist (rw.py AND twrw.py)
                # ships THREE per-slot arrays — int32 ids + int32
                # segments + f32 weights; the dedup line below uses its
                # true 4 B/id, so these paths must be priced on their
                # true 12 B/id too or the rankings are biased
                in_bytes = ids_here * 12 / pad_eff
                if opt.dedup and st == ShardingType.ROW_WISE:
                    # dedup dist: one int32 id array of DISTINCT ids
                    # (weights/segments stay at the source), and the
                    # output/backward legs carry one embedding row per
                    # distinct id instead of psum_scatter/all_gather of
                    # the full pooled batch.  The dedup cap is derived
                    # from the (bucketed) feature cap (rw.py
                    # build_rw_layout), so the same efficiency applies
                    in_bytes = distinct_here * 4 / pad_eff
                    out_bytes = distinct_here * cols * BYTES_F32 / pad_eff
                multi_slice = (t.slice_size or N) < N
                if self.ctx.hierarchical and multi_slice:
                    # two-level dist (sharding/hier.py): the full id
                    # dispatch + embedding return ride ICI slice-local;
                    # only the dedup'd (int8-wire) cross-slice exchange
                    # pays DCN, shrunk by the measured flat/hier DCN
                    # byte ratio (a calibration run writes it).  The
                    # DCN legs carry id requests + rows forward and
                    # grads backward — priced as the flat leg bytes
                    # over the calibrated reduction.
                    h = max(1.0, self.ctx.hier_dcn_reduction)
                    fwd_comms = (in_bytes + out_bytes) / t.ici_bw + (
                        in_bytes + out_bytes
                    ) / (h * t.dcn_bw)
                    bwd_comms = out_bytes / t.ici_bw + out_bytes / (
                        h * t.dcn_bw
                    )
                elif st == ShardingType.ROW_WISE:
                    # spans ALL devices: every leg crosses DCN when the
                    # world is multi-slice
                    bw = t.comms_bw(not multi_slice)
                    fwd_comms = (in_bytes + out_bytes) / bw
                    bwd_comms = out_bytes / bw
                else:  # TWRW / GRID: rows stay within one slice
                    # ids may arrive from any slice (DCN when multi-slice);
                    # partial-sum combine rides ICI inside the node, with
                    # one cross-slice hop of the final pooled block home
                    in_bw = t.comms_bw(not multi_slice)
                    fwd_comms = in_bytes / in_bw + out_bytes / t.ici_bw
                    bwd_comms = out_bytes / t.ici_bw
                    if multi_slice:
                        final_bytes = B * cols * BYTES_F32
                        fwd_comms += final_bytes / t.dcn_bw
                        bwd_comms += final_bytes / t.dcn_bw

            shard.perf = Perf(
                fwd_compute=fwd_compute,
                fwd_comms=fwd_comms,
                bwd_compute=bwd_compute,
                bwd_comms=bwd_comms,
                prefetch=prefetch,
            )


def expected_wire_bytes(
    opt: ShardingOption, ctx: EstimatorContext, t: Topology
) -> Dict[str, float]:
    """Expected per-step wire bytes of one chosen option, split by link
    class (``{"ici": bytes, "dcn": bytes}``) — the byte terms of
    :class:`EmbeddingPerfEstimator`'s comms pricing WITHOUT the
    bandwidth division, so the health monitor can compare them against
    the qcomm ledgers' measured ``wire/link:ici`` / ``wire/link:dcn``
    gauges.  Any formula change in the estimator's comms terms must land
    here too (the assumptions twin of `_estimate_option`)."""
    N = t.world_size
    B = ctx.batch_size_per_device
    P = ctx.pooling(opt.name)
    st = opt.sharding_type
    n_shards = max(1, len(opt.shards))
    global_ids = N * B * P
    pad_eff = ctx.padding_efficiency(opt.name)
    dup = max(1.0, opt.duplication_factor) if opt.dedup else 1.0
    multi_slice = (t.slice_size or N) < N
    ici = dcn = 0.0
    for shard in opt.shards:
        rows, cols = shard.size
        if st in (ShardingType.ROW_WISE, ShardingType.TABLE_ROW_WISE,
                  ShardingType.GRID_SHARD):
            frac = max(rows, 1) / max(opt.num_embeddings, 1)
        elif st == ShardingType.DATA_PARALLEL:
            frac = 1.0 / N
        else:
            frac = 1.0
        ids_here = global_ids * frac
        distinct_here = ids_here / dup
        if st == ShardingType.DATA_PARALLEL:
            ici += 2 * rows * cols * BYTES_F32 / N
        elif st in (ShardingType.TABLE_WISE, ShardingType.COLUMN_WISE):
            out_bytes = N * B * cols * BYTES_F32
            ici += ids_here * 8 / pad_eff + 2 * out_bytes
        else:  # RW / TWRW / GRID
            out_bytes = B * cols * BYTES_F32 * n_shards / N
            in_bytes = ids_here * 12 / pad_eff
            if opt.dedup and st == ShardingType.ROW_WISE:
                in_bytes = distinct_here * 4 / pad_eff
                out_bytes = distinct_here * cols * BYTES_F32 / pad_eff
            if ctx.hierarchical and multi_slice:
                h = max(1.0, ctx.hier_dcn_reduction)
                ici += in_bytes + 2 * out_bytes
                dcn += (in_bytes + 2 * out_bytes) / h
            elif st == ShardingType.ROW_WISE:
                if multi_slice:
                    dcn += in_bytes + 2 * out_bytes
                else:
                    ici += in_bytes + 2 * out_bytes
            else:  # TWRW / GRID
                if multi_slice:
                    dcn += in_bytes + 2 * B * cols * BYTES_F32
                else:
                    ici += in_bytes
                ici += 2 * out_bytes
    return {"ici": ici, "dcn": dcn}


def build_plan_assumptions(
    options,
    ctx: EstimatorContext,
    t: Topology,
    feature_names: Optional[Dict[str, list]] = None,
):
    """The ``PlanAssumptions`` artifact for a CHOSEN option set (the
    planner's winning proposal): per-table expected occupancy /
    padding efficiency / cache hit rate / duplication factor, plus the
    expected per-link-class wire bytes per step summed over tables —
    what ``EmbeddingShardingPlanner.plan`` stamps onto the emitted plan
    and the health monitor drifts against.  ``feature_names`` maps
    table -> its KJT keys (from the embedding configs), stamped so the
    monitor can find the FEATURE-keyed occupancy gauges."""
    from torchrec_tpu_torch.obs.assumptions import (
        PlanAssumptions,
        TableAssumptions,
    )

    tables: Dict[str, TableAssumptions] = {}
    wire = {"ici": 0.0, "dcn": 0.0}
    for opt in options:
        pad_eff = ctx.padding_efficiency(opt.name)
        hit = None
        if opt.compute_kernel == EmbeddingComputeKernel.FUSED_HOST_CACHED:
            clf = min(max(opt.cache_load_factor or 0.0, 0.0), 1.0)
            hit = zipf_hit_rate(
                clf, max(1, opt.num_embeddings), opt.zipf_exponent
            )
        tables[opt.name] = TableAssumptions(
            sharding_type=opt.sharding_type.value,
            compute_kernel=opt.compute_kernel.value,
            # under capacity bucketing the shipped id slots are
            # real/pad_eff: expected_occupancy derives from this in
            # TableAssumptions.__post_init__ (single writer)
            padding_efficiency=pad_eff,
            expected_hit_rate=hit,
            duplication_factor=float(opt.duplication_factor),
            zipf_exponent=float(opt.zipf_exponent),
            pooling_factor=ctx.pooling(opt.name),
            cache_load_factor=opt.cache_load_factor,
            num_embeddings=int(opt.num_embeddings),
            feature_names=list((feature_names or {}).get(opt.name, ())),
        )
        for link, nbytes in expected_wire_bytes(opt, ctx, t).items():
            wire[link] += nbytes
    return PlanAssumptions(
        tables=tables,
        wire_bytes_per_step={k: float(v) for k, v in wire.items()},
        world_size=t.world_size,
        batch_size_per_device=ctx.batch_size_per_device,
        hierarchical=ctx.hierarchical,
        hier_dcn_reduction=ctx.hier_dcn_reduction,
    )


def options_from_plan(
    plan,
    tables,
    topology: Topology,
    ctx: EstimatorContext,
):
    """Reconstruct priceable ``ShardingOption``s from an EMITTED plan
    ({table: ParameterSharding}) — the inverse of the planner's
    ``_to_parameter_sharding``, so an already-running plan can be
    re-priced under a different (e.g. live-telemetry) context.  Shard
    geometry comes from ``sharding_spec`` when the plan carries one,
    else it is re-derived exactly as the enumerator lays each type out;
    the dedup flag and cache sizing come off the plan entry, while the
    duplication factor / zipf exponent resolve through ``ctx``'s
    constraints (the live numbers when ctx came from telemetry)."""

    N = topology.world_size
    node = topology.slice_size or N
    out = []
    for cfg in tables:
        ps = plan.get(cfg.name)
        if ps is None:
            continue
        rows, cols = cfg.num_embeddings, cfg.embedding_dim
        st = ps.sharding_type
        shards = []
        if ps.sharding_spec:
            shards = [
                Shard(
                    size=tuple(m.shard_sizes),
                    offset=tuple(m.shard_offsets),
                    rank=m.placement,
                )
                for m in ps.sharding_spec
            ]
        elif st == ShardingType.DATA_PARALLEL:
            shards = [Shard(size=(rows, cols), offset=(0, 0), rank=None)]
        elif st == ShardingType.TABLE_WISE:
            shards = [
                Shard(
                    size=(rows, cols), offset=(0, 0),
                    rank=(ps.ranks or [0])[0],
                )
            ]
        elif st == ShardingType.COLUMN_WISE:
            ranks = ps.ranks or list(range(ps.num_col_shards))
            w = cols // max(1, len(ranks))
            shards = [
                Shard(size=(rows, w), offset=(0, i * w), rank=r)
                for i, r in enumerate(ranks)
            ]
        else:  # RW / TWRW / GRID: row blocks over the rank list
            ranks = ps.ranks or list(
                range(node if st != ShardingType.ROW_WISE else N)
            )
            per_col = max(1, len(ranks) // max(1, ps.num_col_shards))
            w = cols // max(1, ps.num_col_shards)
            block = -(-rows // per_col)
            for ci in range(max(1, ps.num_col_shards)):
                for bi in range(per_col):
                    r = ranks[ci * per_col + bi]
                    n = min(block, max(rows - bi * block, 0))
                    shards.append(
                        Shard(
                            size=(n, w), offset=(bi * block, ci * w),
                            rank=r,
                        )
                    )
        dup = zipf = None
        if ctx.constraints and cfg.name in ctx.constraints:
            dup = ctx.constraints[cfg.name].duplication_factor
            zipf = ctx.constraints[cfg.name].zipf_exponent
        out.append(
            ShardingOption(
                name=cfg.name,
                sharding_type=st,
                compute_kernel=ps.compute_kernel,
                shards=shards,
                num_embeddings=rows,
                embedding_dim=cols,
                cache_load_factor=ps.cache_load_factor,
                dedup=ps.dedup,
                duplication_factor=max(1.0, dup if dup is not None else 1.0),
                zipf_exponent=zipf if zipf is not None else 0.0,
            )
        )
    return out


def price_plan(
    plan,
    tables,
    topology: Topology,
    ctx: EstimatorContext,
) -> float:
    """Bottleneck-device cost (seconds/step) of an EMITTED plan under
    ``ctx`` — the number the online-migration improvement gate compares
    between the running plan and a replanned candidate, both priced
    with the SAME (live) context so the decision measures the plan, not
    the beliefs.  Per-shard perf accumulates onto the shard's rank;
    DATA_PARALLEL work lands on every device (each replica does its own
    batch's lookups and pays its allreduce share); unplaced shards
    (rank None on a non-DP type) fall back to rank 0."""
    options = options_from_plan(plan, tables, topology, ctx)
    EmbeddingPerfEstimator(topology, ctx).estimate(options)
    per_rank = [0.0] * topology.world_size
    for opt in options:
        for shard in opt.shards:
            cost = shard.perf.total if shard.perf else 0.0
            if (
                opt.sharding_type == ShardingType.DATA_PARALLEL
                or shard.rank is None
            ):
                if opt.sharding_type == ShardingType.DATA_PARALLEL:
                    for r in range(topology.world_size):
                        per_rank[r] += cost
                else:
                    per_rank[0] += cost
            else:
                per_rank[shard.rank % topology.world_size] += cost
    return max(per_rank) if per_rank else 0.0


class EmbeddingStorageEstimator:
    """Fill ``shard.storage`` (reference ``calculate_shard_storages``)."""

    def __init__(self, topology: Topology, ctx: EstimatorContext,
                 optimizer_multiplier: float = 0.25):
        # rowwise adagrad: one fp32 scalar per row => dim-relative 1/D;
        # use a conservative 0.25x multiplier default (covers adagrad slots
        # on small dims); full adam would be 2.0
        self.t = topology
        self.ctx = ctx
        self.opt_mult = optimizer_multiplier

    def estimate(self, options) -> None:
        B = self.ctx.batch_size_per_device
        N = self.t.world_size
        for opt in options:
            P = self.ctx.pooling(opt.name)
            cached = (
                opt.compute_kernel == EmbeddingComputeKernel.FUSED_HOST_CACHED
            )
            for shard in opt.shards:
                rows, cols = shard.size
                weight_bytes = rows * cols * BYTES_F32
                ddr = 0
                if cached:
                    # only the device cache lives in HBM; the full table
                    # (and its durably-evicted rows) sit in host DDR
                    clf = min(max(opt.cache_load_factor or 0.0, 0.0), 1.0)
                    ddr = weight_bytes
                    weight_bytes = int(weight_bytes * clf)
                opt_bytes = int(weight_bytes * self.opt_mult)
                # activation/io: received id buffers + pooled outputs
                io_bytes = int(N * B * P * 8 + N * B * cols * BYTES_F32)
                shard.storage = Storage(
                    hbm=weight_bytes + opt_bytes + io_bytes, ddr=ddr
                )
