"""Plan-time assumptions — the artifact the health monitor drifts
against.

Reference: torchrec's planner stats/logging layer records what the
planner *believed* about every table (pooling factors, caching ratios,
estimated perf) next to the emitted plan; DreamShard (PAPERS.md) shows
plan quality tracks live workload features.  Here those beliefs become
a first-class artifact: :class:`PlanAssumptions` captures, per table,
the expected occupancy / padding efficiency / cache hit rate /
duplication factor the estimator priced the winning plan with, plus the
run-level expected per-link-class wire bytes per step — and
``EmbeddingShardingPlanner.plan`` stamps it onto every emitted plan
(``StampedEmbeddingModuleShardingPlan.assumptions``, parallel/types.py).

The health monitor (``obs/health.py``, in both packages) compares live
signals against these numbers; the artifact and its
:meth:`PlanAssumptions.fingerprint` are the same in both packages, so
either package's plan can be scored against the other's beliefs.

Pure data + IO: no planner imports (the planner imports *us*), atomic
tmp-and-rename saves (the DiskStore generation idiom), deterministic
fingerprints over canonical JSON.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional

__all__ = [
    "ASSUMPTIONS_SCHEMA_VERSION",
    "PlanAssumptions",
    "TableAssumptions",
]

#: Bump when the field set below changes shape; rides both the saved
#: artifact and every placement-features row derived under it.
ASSUMPTIONS_SCHEMA_VERSION = 1


@dataclasses.dataclass
class TableAssumptions:
    """What the planner assumed about ONE table when it priced the
    winning plan.  Rates are in [0, 1]; ``expected_hit_rate`` is None
    for tables that are not cache-backed (nothing to drift).

    ``sharding_type`` / ``compute_kernel`` identify the chosen option
    (enum values as strings); ``padding_efficiency`` is the
    real-ids-per-shipped-slot rate the id wires were priced at, and
    ``expected_occupancy`` — the occupancy rate the monitor drifts on
    — DEFAULTS to it (leave None; a workload whose expected occupancy
    legitimately differs from the wire-pricing efficiency may pin it
    explicitly, and ``__post_init__`` fills the derivation so the two
    can never silently diverge); ``duplication_factor`` the expected raw
    ids per distinct id; ``zipf_exponent`` the id-stream skew behind
    ``expected_hit_rate``; ``pooling_factor`` the assumed ids per
    example; ``cache_load_factor`` / ``num_embeddings`` the cache
    sizing the hit rate was derived from; ``feature_names`` the KJT
    keys routed to this table — the per-key occupancy/padding gauges
    (``kjt/<key>/*``, ``bucketing/<key>/*``) are FEATURE-keyed, so the
    health monitor needs this map to find the table's live signal."""

    sharding_type: str = ""
    compute_kernel: str = ""
    # expected real ids per shipped id slot — the occupancy rate the
    # bucketed id wires were priced at; None derives it from
    # padding_efficiency in __post_init__ (one writer, no divergence)
    expected_occupancy: Optional[float] = None
    padding_efficiency: float = 1.0
    # zipf_hit_rate(cache_load_factor, rows, zipf_exponent) for
    # FUSED_HOST_CACHED tables — the steady-state cache hit rate the
    # miss traffic was priced at
    expected_hit_rate: Optional[float] = None
    duplication_factor: float = 1.0
    zipf_exponent: float = 0.0
    pooling_factor: float = 0.0
    cache_load_factor: Optional[float] = None
    num_embeddings: int = 0
    feature_names: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.expected_occupancy is None:
            self.expected_occupancy = self.padding_efficiency

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TableAssumptions":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class PlanAssumptions:
    """The full plan-time belief set: per-table ``tables``
    (:class:`TableAssumptions`) plus the run-level expected
    ``wire_bytes_per_step`` per link class (``{"ici": bytes, "dcn":
    bytes}`` per step, the same split the qcomm ledgers measure under
    ``wire/link:ici`` / ``wire/link:dcn``).  ``world_size`` /
    ``batch_size_per_device`` record the topology the numbers were
    priced for, ``hierarchical`` / ``hier_dcn_reduction`` the
    two-level comms pricing knobs in effect, and ``schema_version``
    (:data:`ASSUMPTIONS_SCHEMA_VERSION`) the artifact shape."""

    tables: Dict[str, TableAssumptions] = dataclasses.field(
        default_factory=dict
    )
    wire_bytes_per_step: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    world_size: int = 0
    batch_size_per_device: int = 0
    hierarchical: bool = False
    hier_dcn_reduction: float = 1.0
    schema_version: int = ASSUMPTIONS_SCHEMA_VERSION

    # -- identity ----------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tables"] = {t: a.to_dict() for t, a in self.tables.items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanAssumptions":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["tables"] = {
            t: TableAssumptions.from_dict(a)
            for t, a in d.get("tables", {}).items()
        }
        return cls(**kw)

    def fingerprint(self) -> str:
        """Stable short id of this belief set (sha256 over canonical
        JSON): what placement-features rows and health dumps reference,
        so a drift score is always attributable to the exact plan-time
        numbers it was computed against."""
        canon = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    # -- IO ----------------------------------------------------------------

    def save(self, path: str) -> str:
        """Atomic write (tmp + ``os.replace``, the DiskStore generation
        idiom — a crash mid-save can never surface a torn artifact)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        body = dict(self.to_dict(), fingerprint=self.fingerprint())
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(body, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "PlanAssumptions":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))
