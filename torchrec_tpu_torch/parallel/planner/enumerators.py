"""Sharding-option enumeration.

Reference: ``planner/enumerators.py:80`` ``EmbeddingEnumerator`` — all
valid (sharding type x compute kernel) candidates per table under
constraints, with shard geometry; estimators fill in perf/storage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from torchrec_tpu_torch.modules.embedding_configs import BaseEmbeddingConfig
from torchrec_tpu_torch.parallel.planner.types import (
    DEDUP_AUTO_THRESHOLD,
    ParameterConstraints,
    PlannerError,
    Shard,
    ShardingOption,
    Topology,
)
from torchrec_tpu_torch.parallel.types import (
    DEFAULT_CACHE_LOAD_FACTOR,
    EmbeddingComputeKernel,
    ShardingType,
)

DEFAULT_SHARDING_TYPES = [
    ShardingType.DATA_PARALLEL,
    ShardingType.TABLE_WISE,
    ShardingType.COLUMN_WISE,
    ShardingType.ROW_WISE,
    ShardingType.TABLE_ROW_WISE,
    ShardingType.GRID_SHARD,
]


class EmbeddingEnumerator:
    """Candidate (sharding_type, kernel) options per table, filtered
    by ParameterConstraints (reference planner/enumerators.py)."""
    def __init__(
        self,
        topology: Topology,
        constraints: Optional[Dict[str, ParameterConstraints]] = None,
        default_duplication_factor: float = 1.0,
        default_zipf_exponent: float = 0.0,
        per_table: Optional[Dict[str, Dict[str, float]]] = None,
    ):
        self.topology = topology
        self.constraints = constraints or {}
        # dataset-calibrated fallback for "auto" dedup decisions
        self.default_duplication_factor = default_duplication_factor
        # dataset-calibrated fallback for tiered miss-traffic pricing
        # (a calibration run writes zipf_exponent)
        self.default_zipf_exponent = default_zipf_exponent
        # per-TABLE fitted scalars (fit_placement_model.py): tried
        # between an explicit constraint and the global default
        self.per_table = per_table or {}

    def _dedup_for(
        self, table: str, c: ParameterConstraints
    ) -> Tuple[bool, float]:
        """(enable dedup for RW options, duplication factor) under this
        table's constraints — "auto" enables once the (constraint-or-
        calibrated) duplication factor clears DEDUP_AUTO_THRESHOLD."""
        dup = c.duplication_factor
        if dup is None:
            dup = self.per_table.get(table, {}).get("duplication_factor")
        if dup is None:
            dup = self.default_duplication_factor
        dup = max(1.0, float(dup))
        mode = c.dedup
        if mode in (None, "off", False):
            return False, dup
        if mode in ("on", True):
            return True, dup
        if mode == "auto":
            return dup >= DEDUP_AUTO_THRESHOLD, dup
        raise PlannerError(f"unknown dedup constraint {mode!r}")

    def _shards_for(
        self, st: ShardingType, rows: int, cols: int, min_partition: int,
        explicit: bool = False,
    ) -> List[List[Shard]]:
        """Possible shard geometries for one sharding type."""
        N = self.topology.world_size
        node = self.topology.slice_size or N
        out: List[List[Shard]] = []
        if st in (ShardingType.DATA_PARALLEL, ShardingType.TABLE_WISE):
            out.append([Shard(size=(rows, cols), offset=(0, 0))])
        elif st == ShardingType.COLUMN_WISE:
            # every even split with shard width >= min_partition
            n = 2
            while n <= min(N, cols // min_partition):
                if cols % n == 0:
                    w = cols // n
                    out.append(
                        [
                            Shard(size=(rows, w), offset=(0, i * w))
                            for i in range(n)
                        ]
                    )
                n += 1
        elif st == ShardingType.ROW_WISE:
            if N == 1 and not explicit:
                # single device: RW degenerates to TW but still pays the
                # bucketize sort — skip unless constraints demand it
                return out
            block = -(-rows // N)
            out.append(
                [
                    Shard(
                        size=(min(block, max(rows - r * block, 0)), cols),
                        offset=(r * block, 0),
                    )
                    for r in range(N)
                ]
            )
        elif st == ShardingType.TABLE_ROW_WISE:
            if node < N:  # only meaningful multi-slice
                block = -(-rows // node)
                out.append(
                    [
                        Shard(
                            size=(min(block, max(rows - r * block, 0)), cols),
                            offset=(r * block, 0),
                        )
                        for r in range(node)
                    ]
                )
        elif st == ShardingType.GRID_SHARD:
            if node < N and cols >= 2 * min_partition and cols % 2 == 0:
                w = cols // 2
                block = -(-rows // node)
                shards = []
                for ci in range(2):
                    for r in range(node):
                        shards.append(
                            Shard(
                                size=(
                                    min(block, max(rows - r * block, 0)),
                                    w,
                                ),
                                offset=(r * block, ci * w),
                            )
                        )
                out.append(shards)
        return out

    def enumerate(
        self, tables: Sequence[BaseEmbeddingConfig]
    ) -> List[ShardingOption]:
        options: List[ShardingOption] = []
        for cfg in tables:
            n_before = len(options)
            c = self.constraints.get(cfg.name, ParameterConstraints())
            explicit = c.sharding_types is not None
            types = c.sharding_types or DEFAULT_SHARDING_TYPES
            kernels = c.compute_kernels or [EmbeddingComputeKernel.FUSED]
            cached_kernel = EmbeddingComputeKernel.FUSED_HOST_CACHED
            want_cached = c.cache_load_factor is not None or (
                c.compute_kernels is not None
                and cached_kernel in c.compute_kernels
            )
            # tiered-storage constraint (ROADMAP A10): "on"
            # always enumerates the cached kernel; "auto" is the
            # beyond-HBM escape hatch — a table whose full weights
            # exceed ONE device's HBM budget can never be placed TW/DP
            # un-cached (and past world_size x budget not at all), so
            # it gets a FUSED_HOST_CACHED option automatically instead
            # of failing the plan
            if c.tiered in ("on", True):
                want_cached = True
            elif c.tiered == "auto":
                weight_bytes = cfg.num_embeddings * cfg.embedding_dim * 4
                budget = min(
                    d.storage.hbm for d in self.topology.devices
                )
                if weight_bytes > budget:
                    want_cached = True
            elif c.tiered not in (None, "off", False):
                raise PlannerError(
                    f"unknown tiered constraint {c.tiered!r} "
                    "(expected None/'off'/'on'/'auto')"
                )
            if want_cached and cached_kernel not in kernels:
                # host-offloaded cached kernel: the device cache only
                # supports single-column TW/DP layouts
                # (modules/host_offload.py apply_io constraint), so cached
                # options are enumerated for those types only
                kernels = kernels + [cached_kernel]
            # the storage model and the runtime sizing share one fallback
            # so an unspecified factor can't be budgeted as a 0-byte cache
            clf = (
                c.cache_load_factor
                if c.cache_load_factor is not None
                else DEFAULT_CACHE_LOAD_FACTOR
            )
            dedup_rw, dup_factor = self._dedup_for(cfg.name, c)
            zipf = c.zipf_exponent
            if zipf is None:
                zipf = self.per_table.get(cfg.name, {}).get(
                    "zipf_exponent"
                )
            if zipf is None:
                zipf = self.default_zipf_exponent
            for st in types:
                for geometry in self._shards_for(
                    st, cfg.num_embeddings, cfg.embedding_dim,
                    c.min_partition, explicit,
                ):
                    for k in kernels:
                        if k == EmbeddingComputeKernel.FUSED_HOST_CACHED and (
                            st
                            not in (
                                ShardingType.TABLE_WISE,
                                ShardingType.DATA_PARALLEL,
                            )
                        ):
                            continue
                        options.append(
                            ShardingOption(
                                name=cfg.name,
                                sharding_type=st,
                                compute_kernel=k,
                                shards=[
                                    Shard(size=s.size, offset=s.offset)
                                    for s in geometry
                                ],
                                num_embeddings=cfg.num_embeddings,
                                embedding_dim=cfg.embedding_dim,
                                cache_load_factor=(
                                    clf if k == cached_kernel else None
                                ),
                                # dedup'd input dist is a ROW_WISE
                                # runtime path
                                dedup=(
                                    dedup_rw
                                    and st == ShardingType.ROW_WISE
                                ),
                                duplication_factor=dup_factor,
                                zipf_exponent=(
                                    zipf if k == cached_kernel else 0.0
                                ),
                            )
                        )
            if len(options) == n_before:
                # a silently-dropped table would be sharded with defaults
                # the planner never budgeted — fail loudly instead
                raise PlannerError(
                    f"table {cfg.name!r}: constraints produce no sharding "
                    f"options (sharding_types={[t.value for t in types]}, "
                    f"kernels={[k.value for k in kernels]}; note "
                    "FUSED_HOST_CACHED only supports TABLE_WISE/"
                    "DATA_PARALLEL layouts)"
                )
        return options
