"""Planner cost/topology model.

Reference: ``planner/types.py`` — ``Perf`` (:70), ``Storage`` (:135),
``Topology`` (:952), ``DeviceHardware`` (:166), ``ShardingOption`` (:1264),
``ParameterConstraints``, ``PlannerError``; constants from
``planner/constants.py`` replaced with device profiles (HBM capacity and
bandwidth, intra-/inter-node link rates, bf16 FLOP/s): the H100 SXM5
80GB, or a caller's dict.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    ShardingType,
)

GB = 1024**3


@dataclasses.dataclass
class Perf:
    """Estimated per-step cost of one shard, seconds
    (reference planner/types.py:70)."""

    fwd_compute: float = 0.0
    fwd_comms: float = 0.0
    bwd_compute: float = 0.0
    bwd_comms: float = 0.0
    # host-link traffic of offloaded-cache fills/write-backs (reference
    # Perf.prefetch_compute — the UVM prefetch pipeline's cost)
    prefetch: float = 0.0

    @property
    def total(self) -> float:
        return (
            self.fwd_compute + self.fwd_comms + self.bwd_compute
            + self.bwd_comms + self.prefetch
        )

    def __add__(self, other: "Perf") -> "Perf":
        return Perf(
            self.fwd_compute + other.fwd_compute,
            self.fwd_comms + other.fwd_comms,
            self.bwd_compute + other.bwd_compute,
            self.bwd_comms + other.bwd_comms,
            self.prefetch + other.prefetch,
        )


@dataclasses.dataclass
class Storage:
    """Bytes (reference planner/types.py:135)."""

    hbm: int = 0
    ddr: int = 0

    def __add__(self, other: "Storage") -> "Storage":
        return Storage(self.hbm + other.hbm, self.ddr + other.ddr)

    def fits_in(self, other: "Storage") -> bool:
        return self.hbm <= other.hbm and self.ddr <= other.ddr


# The device profiles the estimators run on: HBM bytes per device, and the
# rates in GB/s (HBM, the intra-node link, the inter-node network, the
# host link) and dense bf16 TFLOP/s.  Keys follow the JAX package's
# profile dicts so that one of those can be passed as ``profile=``; its
# names map onto a GPU cluster as:
#   ici_bw      the intra-node link (NVLink), all-to-all rate per device
#   dcn_bw      the inter-node network, per device
#   slice_size  (Topology) the devices of one node
# Provenance of the one entry, the H100 SXM5 80GB (NVIDIA's data sheet):
#   hbm_cap     80 GB                              PUBLIC SPEC
#   hbm_bw      3,350 GB/s                         PUBLIC SPEC (peak)
#   tflops      989 dense bf16                     PUBLIC SPEC (no sparsity)
#   ici_bw      450 GB/s a direction, NVLink 4     PUBLIC SPEC link rate;
#                                                  its usable all-to-all
#                                                  share is ASSUMED whole
#   dcn_bw      50 GB/s: one 400 Gb/s NIC a GPU    ASSUMED
#   host_bw     64 GB/s: PCIe Gen5 x16 a direction ASSUMED usable
# None of them is measured: ``Topology.load_calibration`` overrides them
# from a measured calibration file and marks those entries MEASURED.
H100_SXM5_80GB = "h100_sxm5_80gb"
DEVICE_PROFILES: Dict[str, Dict[str, float]] = {
    H100_SXM5_80GB: dict(
        hbm_cap=80 * 10**9, hbm_bw=3350, ici_bw=450, dcn_bw=50,
        tflops=989, host_bw=64,
    ),
}
DEFAULT_DEVICE = H100_SXM5_80GB

# the port's own calibration file, beside the package; no other file is
# read unless a caller passes its path
DEFAULT_CALIBRATION = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "PLANNER_CALIBRATION.json",
)


@dataclasses.dataclass
class DeviceHardware:
    """One device's budget (reference planner/types.py:166)."""

    rank: int
    storage: Storage
    perf: Perf = dataclasses.field(default_factory=Perf)


@dataclasses.dataclass
class Topology:
    """World description (reference planner/types.py:952): ``world_size``
    devices of one profile, ``slice_size`` of them to a node.

    ``device`` names the profile in :data:`DEVICE_PROFILES` (the H100 by
    default); ``profile``, a dict with that table's keys, overrides it
    (``device`` then only labels the report and the plan hash)."""

    world_size: int
    device: str = DEFAULT_DEVICE
    profile: Optional[Dict[str, float]] = None
    # devices per node; traffic between nodes rides dcn_bw
    slice_size: Optional[int] = None
    hbm_cap_per_device: Optional[int] = None
    reserved_hbm_fraction: float = 0.15  # dense params, activations

    def __post_init__(self):
        prof = self.profile or DEVICE_PROFILES[self.device]
        cap = int(
            (self.hbm_cap_per_device or prof["hbm_cap"])
            * (1 - self.reserved_hbm_fraction)
        )
        self.devices = [
            DeviceHardware(rank=r, storage=Storage(hbm=cap, ddr=64 * GB))
            for r in range(self.world_size)
        ]
        self.hbm_bw = prof["hbm_bw"] * 1e9  # bytes/sec
        self.ici_bw = prof["ici_bw"] * 1e9
        self.dcn_bw = prof["dcn_bw"] * 1e9
        self.flops = prof["tflops"] * 1e12
        # host<->device link for offloaded-table cache fills
        self.host_bw = prof["host_bw"] * 1e9
        # which constants are profile assumptions vs hardware-measured
        # (load_calibration flips entries to MEASURED; stats.py reports)
        self.calibration_sources = {
            k: "ASSUMED"
            for k in ("hbm_bw", "ici_bw", "dcn_bw", "flops", "host_bw")
        }
        if self.slice_size is None:
            self.slice_size = self.world_size

    def comms_bw(self, intra_slice: bool) -> float:
        return self.ici_bw if intra_slice else self.dcn_bw

    def load_calibration(self, path: str = DEFAULT_CALIBRATION):
        """Override assumed constants with measured ones (in bytes/s and
        FLOP/s).  Returns self; keeps the assumptions when no calibration
        file exists."""
        import json

        if not os.path.exists(path):
            return self
        with open(path) as f:
            m = json.load(f)
        for k in ("hbm_bw", "ici_bw", "dcn_bw", "flops", "host_bw"):
            if k in m:
                setattr(self, k, float(m[k]))
                self.calibration_sources[k] = "MEASURED"
        return self


@dataclasses.dataclass
class Shard:
    """One physical shard of a table (reference planner/types.py Shard)."""

    size: Tuple[int, int]  # (rows, cols)
    offset: Tuple[int, int]
    rank: Optional[int] = None
    perf: Optional[Perf] = None
    storage: Optional[Storage] = None


@dataclasses.dataclass
class ShardingOption:
    """A candidate (table x sharding_type x kernel) with its shards
    (reference planner/types.py:1264)."""

    name: str  # table name
    sharding_type: ShardingType
    compute_kernel: EmbeddingComputeKernel
    shards: List[Shard]
    num_embeddings: int = 0
    embedding_dim: int = 0
    # FUSED_HOST_CACHED: device-cache fraction; the cache scale-up
    # proposer raises it toward 1.0 to fill leftover HBM
    cache_load_factor: Optional[float] = None
    # ROW_WISE deduplicated input dist: only distinct ids cross the wire
    # (see ParameterSharding.dedup); duplication_factor is the expected
    # raw-ids-per-distinct-id ratio the perf model divides traffic by
    dedup: bool = False
    duplication_factor: float = 1.0
    # FUSED_HOST_CACHED: id-stream Zipf exponent pricing the expected
    # miss traffic (0.0 = uniform upper bound).  Rides on the option —
    # set by the enumerator from the constraint or the calibrated
    # default, so the tiering decision and the pricing use one number
    zipf_exponent: float = 0.0
    # planner bookkeeping
    dependency: Optional[str] = None

    @property
    def total_storage(self) -> Storage:
        out = Storage()
        for s in self.shards:
            if s.storage:
                out = out + s.storage
        return out

    @property
    def total_perf(self) -> float:
        return sum(s.perf.total for s in self.shards if s.perf)

    @property
    def is_pooled(self) -> bool:
        return True


@dataclasses.dataclass
class ParameterConstraints:
    """Per-table search constraints (reference planner/types.py
    ParameterConstraints)."""

    sharding_types: Optional[List[ShardingType]] = None
    compute_kernels: Optional[List[EmbeddingComputeKernel]] = None
    min_partition: int = 32  # smallest CW column shard width
    pooling_factor: float = 10.0  # avg ids per example per feature
    batch_size: Optional[int] = None
    # request FUSED_HOST_CACHED enumeration at this starting device-cache
    # fraction (reference CacheParams.load_factor); the scale-up proposer
    # may raise it
    cache_load_factor: Optional[float] = None
    # deduplicated input dist for ROW_WISE options: None/"off" = never,
    # "on" = always, "auto" = enable when the duplication factor clears
    # DEDUP_AUTO_THRESHOLD (dedup pays once enough id traffic is
    # redundant; below that the extra sort + per-unique return loses)
    dedup: Optional[str] = None
    # expected raw-ids-per-distinct-id per (feature, shard) batch; None
    # falls back to the dataset-measured value in PLANNER_CALIBRATION.json
    # (written by a calibration run) and then to 1.0
    duplication_factor: Optional[float] = None
    # expected real-ids / shipped-id-slots under capacity bucketing
    # (train_pipeline.BucketedStepCache): the perf model prices the id
    # dists at expected BUCKETED bytes = real bytes / efficiency.  None
    # falls back to the measured value in PLANNER_CALIBRATION.json
    # (written by a calibration run) and then to 1.0 — i.e.
    # an uncalibrated, un-bucketed stack is priced at its raw id count,
    # exactly the pre-bucketing behavior
    padding_efficiency: Optional[float] = None
    # tiered (host-offloaded cached) storage for this table
    # (ROADMAP A10): None/"off" = never, "on" = always
    # enumerate FUSED_HOST_CACHED options, "auto" = tier WHEN THE TABLE
    # DOES NOT FIT the per-device HBM budget (the beyond-HBM escape
    # hatch: a table the partitioner could never place gets a cached
    # option automatically instead of failing the plan)
    tiered: Optional[str] = None
    # access-skew Zipf exponent of this table's id stream; drives the
    # cached kernel's expected hit rate (zipf_hit_rate below) so miss
    # traffic is priced at the MEASURED skew instead of the uniform
    # upper bound.  None falls back to the calibrated value in
    # PLANNER_CALIBRATION.json (written by a calibration run)
    # and then to 0.0 = uniform
    zipf_exponent: Optional[float] = None


# "auto" dedup enables at/above this duplication factor: at 1.5x the
# distinct-id traffic saving (~33%) clears the dedup path's sort +
# per-unique-return overhead with margin (a calibration run sweep)
DEDUP_AUTO_THRESHOLD = 1.5


def _load_calibration_ledger(path: str) -> Optional[Dict]:
    """The calibration ledger at ``path`` as a dict, or None when absent
    or unreadable."""
    import json

    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_calibration_scalar(
    key: str, path: str = DEFAULT_CALIBRATION
) -> Optional[float]:
    """One scalar from the calibration ledger, or None when never
    measured."""
    m = _load_calibration_ledger(path)
    if m is None:
        return None
    v = m.get(key)
    return float(v) if v else None


def load_calibrated_duplication(
    path: str = DEFAULT_CALIBRATION,
) -> Optional[float]:
    """Dataset-measured duplication factor (a calibration run
    writes ``duplication_factor``) — drives "auto" dedup decisions and
    the perf model's duplication term."""
    return _load_calibration_scalar("duplication_factor", path)


def load_calibrated_zipf(
    path: str = DEFAULT_CALIBRATION,
) -> Optional[float]:
    """Dataset-measured id-stream Zipf exponent (a calibration run writes ``zipf_exponent``) — drives the tiered/cached
    kernel's expected-hit-rate pricing (:func:`zipf_hit_rate`)."""
    return _load_calibration_scalar("zipf_exponent", path)


def zipf_hit_rate(
    cache_fraction: float, rows: int, exponent: float
) -> float:
    """Expected cache hit rate for a Zipf(``exponent``)-distributed id
    stream over ``rows`` ids when the hottest ``cache_fraction`` of
    them are resident (the LFU-with-aging steady state the tiered
    eviction policy converges to): mass of the top-K ranks,
    H_{K,s} / H_{R,s} with the generalized-harmonic closed-form
    approximation.  ``exponent <= 0`` degrades to the uniform model
    (hit rate == cache fraction) — the safe upper bound on miss
    traffic the pre-calibration estimator used."""
    c = min(1.0, max(0.0, cache_fraction))
    if exponent <= 0.0 or rows <= 1 or c in (0.0, 1.0):
        return c
    import math

    k = max(1.0, c * rows)

    def harmonic(x: float, s: float) -> float:
        # integral approximation of the generalized harmonic number
        # H_{x,s} = sum r^-s: 1 (first term exact) + integral_1^x t^-s
        if abs(s - 1.0) < 1e-6:
            return 1.0 + math.log(x)
        return 1.0 + (x ** (1.0 - s) - 1.0) / (1.0 - s)

    return min(1.0, max(c, harmonic(k, exponent) / harmonic(float(rows),
                                                            exponent)))


def fit_zipf_exponent(
    hit_rate: float, rows: int, cache_fraction: float
) -> float:
    """Invert :func:`zipf_hit_rate`: the Zipf exponent under which a
    cache holding the hottest ``cache_fraction`` of ``rows`` ids would
    see the OBSERVED ``hit_rate``.  ``zipf_hit_rate`` is monotone
    non-decreasing in the exponent, so a bisection over [0, 8] suffices.
    Observed rates at or below the uniform bound (hit == cache
    fraction) fit exponent 0 — the live stream carries no measurable
    skew, exactly the safe pre-calibration pricing.  This is the shared
    inversion behind ``scripts/fit_placement_model.py`` and
    ``EstimatorContext.from_telemetry`` (live hit-rate telemetry ->
    estimator skew)."""
    c = min(1.0, max(0.0, cache_fraction))
    h = min(1.0, max(0.0, hit_rate))
    if rows <= 1 or c in (0.0, 1.0) or h <= zipf_hit_rate(c, rows, 0.0):
        return 0.0
    lo, hi = 0.0, 8.0
    if h >= zipf_hit_rate(c, rows, hi):
        return hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if zipf_hit_rate(c, rows, mid) < h:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def load_calibrated_table_scalars(
    path: str = DEFAULT_CALIBRATION,
) -> Dict[str, Dict[str, float]]:
    """Per-TABLE fitted estimator scalars from the calibration ledger's
    ``tables`` entry ({table: {padding_efficiency, duplication_factor,
    zipf_exponent, ...}}), written by ``scripts/fit_placement_model.py``
    from placement-features datasets.  Empty dict when never fitted.
    Consumers resolve a table's scalar as: explicit
    ``ParameterConstraints`` -> this per-table fit -> the global
    calibrated default -> the built-in default."""
    m = _load_calibration_ledger(path)
    if m is None:
        return {}
    tables = m.get("tables")
    if not isinstance(tables, dict):
        return {}
    out: Dict[str, Dict[str, float]] = {}
    for t, scalars in tables.items():
        if not isinstance(scalars, dict):
            continue
        out[t] = {
            k: float(v)
            for k, v in scalars.items()
            if isinstance(v, (int, float))
        }
    return out


def load_calibrated_hier_factor(
    path: str = DEFAULT_CALIBRATION,
) -> Optional[float]:
    """Measured flat/hierarchical DCN bytes-per-step ratio (a calibration run writes ``hier_dcn_reduction``) — the factor the
    multi-slice perf model divides a hierarchical option's DCN wire
    terms by.  It bundles the whole lever (slice-level dedup + id-only
    requests + the int8 DCN leg), matching what the wire ledger
    measures, clamped to >= 1 so an uncalibrated or nonsensical ledger
    can never make hierarchy look WORSE than flat."""
    v = _load_calibration_scalar("hier_dcn_reduction", path)
    if v is None:
        return None
    return max(1.0, v)


def load_calibrated_padding_efficiency(
    path: str = DEFAULT_CALIBRATION,
) -> Optional[float]:
    """Dataset-measured padding efficiency (real ids / bucketed id
    slots; a calibration run writes ``padding_efficiency``)
    clamped to (0, 1] — the perf model prices id-dist traffic at
    expected bucketed bytes with it."""
    v = _load_calibration_scalar("padding_efficiency", path)
    if v is None:
        return None
    return min(1.0, max(1e-3, v))


class PlannerError(Exception):
    """Structured planner failure (reference planner/types.py
    PlannerError)."""

    def __init__(self, message: str, per_rank_debug: Optional[str] = None):
        super().__init__(message + ("\n" + per_rank_debug if per_rank_debug else ""))
        self.per_rank_debug = per_rank_debug
