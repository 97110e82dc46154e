"""Sharding planner — the search loop.

Reference: ``planner/planners.py`` ``EmbeddingShardingPlanner.plan``
(:804): enumerate -> propose -> estimate -> partition -> rank candidate
plans by bottleneck-device perf, emit the winning ``ShardingPlan``.
A copy of the JAX package's planner: the same arithmetic in the same
order on Python floats, so both return the same plan and per-rank
``Perf``/``Storage`` floats on the same inputs and device profile.
``collective_plan`` (:766, plan on rank 0 + broadcast) has no counterpart:
the planner is deterministic, so every rank plans alike.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

from torchrec_tpu_torch.modules.embedding_configs import BaseEmbeddingConfig
from torchrec_tpu_torch.parallel.planner.enumerators import EmbeddingEnumerator
from torchrec_tpu_torch.parallel.planner.partitioners import (
    GreedyPerfPartitioner,
    MemoryBalancedPartitioner,
)
from torchrec_tpu_torch.parallel.planner.proposers import (
    CacheScaleupProposer,
    DynamicProgrammingProposer,
    GreedyProposer,
    UniformProposer,
)
from torchrec_tpu_torch.parallel.planner.shard_estimators import (
    EmbeddingPerfEstimator,
    EmbeddingStorageEstimator,
    EstimatorContext,
    build_plan_assumptions,
)
from torchrec_tpu_torch.parallel.planner.stats import EmbeddingStats
from torchrec_tpu_torch.parallel.planner.types import (
    ParameterConstraints,
    PlannerError,
    ShardingOption,
    Topology,
    load_calibrated_duplication,
    load_calibrated_hier_factor,
    load_calibrated_padding_efficiency,
    load_calibrated_table_scalars,
    load_calibrated_zipf,
)
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    EmbeddingModuleShardingPlan,
    ParameterSharding,
    ShardingType,
    StampedEmbeddingModuleShardingPlan,
)


def _to_parameter_sharding(opt: ShardingOption) -> ParameterSharding:
    st = opt.sharding_type
    ps: ParameterSharding
    ranks = [s.rank for s in opt.shards]
    if st == ShardingType.DATA_PARALLEL:
        ps = ParameterSharding(sharding_type=st)
    elif st == ShardingType.TABLE_WISE:
        ps = ParameterSharding(sharding_type=st, ranks=ranks[:1])
    elif st == ShardingType.COLUMN_WISE:
        # order ranks by column offset
        order = sorted(range(len(opt.shards)), key=lambda i: opt.shards[i].offset[1])
        ps = ParameterSharding(
            sharding_type=st,
            ranks=[ranks[i] for i in order],
            num_col_shards=len(ranks),
        )
    elif st == ShardingType.ROW_WISE:
        # dedup_factor stays 1.0 (exact unique-id capacity): the
        # measured duplication factor is a MEAN, and sizing the hard
        # drop-capacity from it would silently drop contributions on
        # above-average batches — the planner's auto knob must change
        # performance, never numerics.  The mean still drives the perf
        # model; users who accept bounded dropping opt in by setting
        # ParameterSharding.dedup_factor themselves.
        ps = ParameterSharding(
            sharding_type=st, ranks=ranks, dedup=opt.dedup,
        )
    elif st in (ShardingType.TABLE_ROW_WISE, ShardingType.GRID_SHARD):
        # shards are grouped per column shard, node-contiguous by the
        # partitioner; order each group by row offset, groups by col offset
        by_col: Dict[int, List] = {}
        for s in opt.shards:
            by_col.setdefault(s.offset[1], []).append(s)
        flat = []
        for col in sorted(by_col):
            flat.extend(
                s.rank for s in sorted(by_col[col], key=lambda s: s.offset[0])
            )
        ps = ParameterSharding(
            sharding_type=st, ranks=flat, num_col_shards=len(by_col)
        )
    else:
        raise PlannerError(f"cannot express {st} as ParameterSharding")
    ps.compute_kernel = opt.compute_kernel
    ps.cache_load_factor = opt.cache_load_factor
    return ps


class EmbeddingShardingPlanner:
    """Full search planner (drop-in for the v0 greedy heuristic)."""

    def __init__(
        self,
        world_size: Optional[int] = None,
        topology: Optional[Topology] = None,
        batch_size_per_device: int = 512,
        constraints: Optional[Dict[str, ParameterConstraints]] = None,
        debug: bool = False,
        storage_reservation=None,
        bucketed_inputs: bool = False,
        hierarchical: bool = False,
    ):
        """``bucketed_inputs``: the trainer runs the capacity-bucketed
        pipelines (train_pipeline.BucketedTrainPipeline), so id wires
        ship bucketed slots — price them with the calibrated
        ``padding_efficiency``.  Off by default: a static-cap trainer's
        wires are NOT bucketed, and applying the factor there would skew
        id-heavy vs output-heavy rankings (the same altitude as the
        ``dedup`` gate — pricing follows the runtime feature actually in
        use).  Per-table ``ParameterConstraints.padding_efficiency``
        remains an explicit override either way.

        ``hierarchical``: the trainer runs the two-level ICI/DCN dists
        (a DCN_AXIS mesh + ``ParameterSharding.hier``); on a multi-slice
        topology the perf model then prices RW/TWRW comms per link
        class — slice-local legs at ici_bw, the dedup'd cross-slice
        exchange at dcn_bw divided by the calibrated
        ``hier_dcn_reduction`` (a calibration run writes it) — and
        the emitted plan stamps ``hier=True`` onto every RW/TWRW/GRID
        entry so the runtime compiles the hierarchical layouts.  Same
        pricing-follows-runtime altitude as the other two knobs."""
        assert world_size or topology
        if topology is None:
            # when a reservation object owns the carve-out, the topology
            # starts from the raw HBM cap (no double counting)
            topology = Topology(
                world_size=world_size,
                reserved_hbm_fraction=(
                    0.0 if storage_reservation is not None else 0.15
                ),
            )
        if storage_reservation is not None:
            if topology.reserved_hbm_fraction > 0:
                raise PlannerError(
                    "pass a Topology with reserved_hbm_fraction=0.0 when a "
                    "storage_reservation owns the carve-out — otherwise "
                    "both would apply and ~2x the intended HBM is reserved"
                )
            topology = storage_reservation.reserve(copy.deepcopy(topology))
        self.topology = topology
        self.hierarchical = bool(hierarchical)
        # per-TABLE fitted scalars (scripts/fit_placement_model.py merges
        # them into the ledger's ``tables`` entry): resolved between an
        # explicit constraint and the global calibrated default, for the
        # pricing (ctx) and the enumeration decisions (enumerator) alike
        per_table = load_calibrated_table_scalars()
        self.ctx = EstimatorContext(
            batch_size_per_device=batch_size_per_device,
            constraints=constraints,
            # measured real-ids/bucketed-slots ratio (a calibration
            # run) prices id wires at expected bucketed bytes —
            # only when the trainer actually buckets (see docstring)
            padding_efficiency_default=(
                (load_calibrated_padding_efficiency() or 1.0)
                if bucketed_inputs
                else 1.0
            ),
            hierarchical=self.hierarchical,
            hier_dcn_reduction=(
                (load_calibrated_hier_factor() or 1.0)
                if hierarchical
                else 1.0
            ),
            per_table=per_table if bucketed_inputs else {
                # padding efficiency follows the bucketed_inputs gate
                # (un-bucketed wires ship raw ids); the other fitted
                # scalars describe the id STREAM and apply regardless
                t: {k: v for k, v in s.items()
                    if k != "padding_efficiency"}
                for t, s in per_table.items()
            },
        )
        # dataset-measured duplication factor (a calibration run
        # writes it) feeds "auto" dedup decisions and — via the options
        # the enumerator emits — the perf model's duplication term
        self.enumerator = EmbeddingEnumerator(
            self.topology, constraints,
            default_duplication_factor=load_calibrated_duplication()
            or 1.0,
            # dataset-measured id-stream skew (a calibration run
            # writes zipf_exponent) prices FUSED_HOST_CACHED miss
            # traffic at the expected hit rate; 0.0 = uniform bound
            default_zipf_exponent=load_calibrated_zipf() or 0.0,
            per_table=per_table,
        )
        self.perf_estimator = EmbeddingPerfEstimator(self.topology, self.ctx)
        self.storage_estimator = EmbeddingStorageEstimator(
            self.topology, self.ctx
        )
        total_hbm = sum(d.storage.hbm for d in self.topology.devices)
        greedy = GreedyProposer()
        self.proposers = [
            greedy,
            UniformProposer(),
            DynamicProgrammingProposer(total_hbm),
        ]
        if constraints and any(
            c.cache_load_factor is not None
            or (
                c.compute_kernels is not None
                and EmbeddingComputeKernel.FUSED_HOST_CACHED
                in c.compute_kernels
            )
            for c in constraints.values()
        ):
            # cached options in play: scale device caches into leftover
            # HBM (yields only scaled variants; greedy covers m=1)
            self.proposers.insert(
                0,
                CacheScaleupProposer(
                    greedy,
                    self.storage_estimator,
                    self.perf_estimator,
                    total_hbm,
                ),
            )
        self.partitioners = [
            GreedyPerfPartitioner(self.topology),
            MemoryBalancedPartitioner(self.topology),
        ]
        self.stats = EmbeddingStats()
        self.debug = debug
        self.last_report: str = ""
        # set by plan(): the PlanAssumptions stamped on the last
        # emitted plan (None until a plan has been produced)
        self.last_assumptions = None

    def plan(
        self, tables: Sequence[BaseEmbeddingConfig]
    ) -> EmbeddingModuleShardingPlan:
        options = self.enumerator.enumerate(tables)
        if not options:
            return {}
        self.perf_estimator.estimate(options)
        self.storage_estimator.estimate(options)

        best = None
        best_cost = float("inf")
        best_devices = None
        errors: List[str] = []
        for proposer in self.proposers:
            for proposal in proposer.propose(options):
                for partitioner in self.partitioners:
                    candidate = copy.deepcopy(proposal)
                    try:
                        placed = partitioner.partition(candidate)
                    except PlannerError as e:
                        errors.append(str(e))
                        continue
                    devices = partitioner.last_devices
                    cost = max(d.perf.total for d in devices)
                    if cost < best_cost:
                        best, best_cost = placed, cost
                        best_devices = devices
        if best is None:
            raise PlannerError(
                "no feasible sharding plan found",
                "\n".join(errors[-5:]),
            )
        self.last_options = best  # chosen ShardingOptions (for stats)
        self.last_report = self.stats.log(self.topology, best, best_devices)
        if self.debug:
            print(self.last_report)
        # plan-time assumptions stamp (obs/assumptions.py): every
        # emitted plan carries the belief set it was priced under, so
        # the health monitor can score live telemetry against it and a
        # placement-features dataset can reference the exact numbers
        self.last_assumptions = build_plan_assumptions(
            best, self.ctx, self.topology,
            feature_names={
                cfg.name: list(cfg.feature_names) for cfg in tables
            },
        )
        plan = StampedEmbeddingModuleShardingPlan(
            {opt.name: _to_parameter_sharding(opt) for opt in best},
            assumptions=self.last_assumptions,
        )
        if self.hierarchical:
            # the runtime gates on BOTH the plan flag and a two-level
            # mesh, so the stamped plan stays portable to flat worlds
            for ps in plan.values():
                if ps.sharding_type in (
                    ShardingType.ROW_WISE,
                    ShardingType.TABLE_ROW_WISE,
                    ShardingType.GRID_SHARD,
                ):
                    ps.hier = True
        return plan
