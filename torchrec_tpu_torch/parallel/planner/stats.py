"""Plan statistics report.

Reference: ``planner/stats.py:1298`` ``EmbeddingStats`` — the rich plan
report: per-table sharding choices, per-rank HBM and perf broken down
into fwd/bwd compute, comms and prefetch, imbalance statistics
(max/mean, KL divergence of the per-rank distributions), and a summary
of what drives the critical path.

Comms columns are the intra-/inter-node all-to-all+reduce estimates of
shard_estimators.py; prefetch is the host-link traffic of host-offloaded
caches (FUSED_HOST_CACHED); the report also states which topology
constants are MEASURED (a calibration file) vs ASSUMED (the device
profile) so an estimate is never mistaken for a measurement.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from torchrec_tpu_torch.parallel.planner.types import (
    DeviceHardware,
    Perf,
    ShardingOption,
    Topology,
)


def _kl_divergence(values: List[float]) -> float:
    """KL(observed || uniform) over ranks — 0.0 means perfectly balanced
    (the reference's imbalance statistic, planner/stats.py
    ``_calculate_kl_divergence``)."""
    total = sum(values)
    if total <= 0:
        return 0.0
    n = len(values)
    kl = 0.0
    for v in values:
        p = v / total
        if p > 0:
            kl += p * math.log(p * n)
    return kl


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:8.3f}"


class EmbeddingStats:
    """Builds the report string; also exposes the per-rank aggregates
    for programmatic checks (tests, planner debugging)."""

    def __init__(self):
        self.per_rank_perf: Dict[int, Perf] = {}
        self.per_rank_hbm: Dict[int, int] = {}

    def _aggregate(
        self, plan: List[ShardingOption], world_size: Optional[int] = None
    ) -> None:
        from torchrec_tpu_torch.parallel.types import ShardingType

        if world_size is None:
            world_size = 1 + max(
                (s.rank for o in plan for s in o.shards
                 if s.rank is not None),
                default=0,
            )
        self.per_rank_perf = {}
        self.per_rank_hbm = {}

        def charge(rank: int, perf: Perf, hbm: int) -> None:
            self.per_rank_perf[rank] = (
                self.per_rank_perf.get(rank, Perf()) + perf
            )
            self.per_rank_hbm[rank] = self.per_rank_hbm.get(rank, 0) + hbm

        for opt in plan:
            if opt.sharding_type == ShardingType.DATA_PARALLEL:
                # replicated: the partitioner charges every device the
                # full replica (partitioners.py DP branch) even though
                # the shard records rank=0 — mirror that here
                for s in opt.shards:
                    for r in range(world_size):
                        charge(r, s.perf or Perf(),
                               s.storage.hbm if s.storage else 0)
                continue
            for s in opt.shards:
                if s.rank is None:
                    continue
                charge(s.rank, s.perf or Perf(),
                       s.storage.hbm if s.storage else 0)

    def log(
        self,
        topology: Topology,
        plan: List[ShardingOption],
        devices: Optional[List[DeviceHardware]] = None,
    ) -> str:
        N = topology.world_size
        self._aggregate(plan, world_size=N)
        lines = ["--- torchrec_tpu_torch sharding plan " + "-" * 40]
        lines.append(
            f"  topology: {N} x {topology.device} "
            f"(node={topology.slice_size}), "
            f"hbm={topology.devices[0].storage.hbm / 2**30:.1f}GiB/device, "
            f"intra={topology.ici_bw / 1e9:.0f}GB/s "
            f"inter={topology.dcn_bw / 1e9:.1f}GB/s "
            f"hbm_bw={topology.hbm_bw / 1e9:.0f}GB/s"
        )
        src = getattr(topology, "calibration_sources", {})
        if src:
            measured = sorted(k for k, v in src.items() if v == "MEASURED")
            assumed = sorted(k for k, v in src.items() if v == "ASSUMED")
            lines.append(
                "  calibration: MEASURED=" + (",".join(measured) or "none")
                + "  ASSUMED=" + (",".join(assumed) or "none")
            )

        # -- per-table choices ------------------------------------------
        for opt in sorted(plan, key=lambda o: o.name):
            ranks = sorted({s.rank for s in opt.shards if s.rank is not None})
            rank_str = (
                f"ranks={ranks}" if len(ranks) <= 8 else f"{len(ranks)} ranks"
            )
            lines.append(
                f"  {opt.name:<24} {opt.sharding_type.value:<16} "
                f"{opt.compute_kernel.value:<6} shards={len(opt.shards):<4} "
                f"{rank_str} hbm={opt.total_storage.hbm / 2**30:.3f}GiB "
                f"perf={opt.total_perf * 1e3:.3f}ms"
            )

        # -- per-rank breakdown (reference stats.py per-rank table) -----
        lines.append(
            "  per-rank (ms/step):  rank  fwd_comp fwd_comms  bwd_comp "
            "bwd_comms  prefetch     total   hbm_used"
        )
        cap = topology.devices[0].storage.hbm
        all_ranks = sorted(
            set(self.per_rank_perf) | set(self.per_rank_hbm)
        ) or list(range(N))
        for r in all_ranks:
            p = self.per_rank_perf.get(r, Perf())
            hbm = self.per_rank_hbm.get(r, 0)
            if devices is not None and r < len(devices):
                hbm = cap - devices[r].storage.hbm
            lines.append(
                f"    {r:>17}  {_fmt_ms(p.fwd_compute)} {_fmt_ms(p.fwd_comms)}"
                f"  {_fmt_ms(p.bwd_compute)} {_fmt_ms(p.bwd_comms)}"
                f"  {_fmt_ms(p.prefetch)}  {_fmt_ms(p.total)}"
                f"   {hbm / 2**30:.3f}GiB ({100 * hbm / cap:.1f}%)"
            )

        # -- imbalance statistics (reference imbalance divergences) ------
        perfs = [self.per_rank_perf.get(r, Perf()).total for r in all_ranks]
        hbms = [float(self.per_rank_hbm.get(r, 0)) for r in all_ranks]
        if perfs and max(perfs) > 0:
            mean = sum(perfs) / len(perfs)
            lines.append(
                f"  perf imbalance: max/mean={max(perfs) / (mean + 1e-12):.2f} "
                f"kl_div={_kl_divergence(perfs):.4f} "
                f"critical_path={max(perfs) * 1e3:.3f}ms"
            )
        if hbms and max(hbms) > 0:
            mean = sum(hbms) / len(hbms)
            lines.append(
                f"  hbm imbalance:  max/mean={max(hbms) / (mean + 1e-12):.2f} "
                f"kl_div={_kl_divergence(hbms):.4f}"
            )

        # -- what dominates the critical path ----------------------------
        if perfs and max(perfs) > 0:
            worst = all_ranks[perfs.index(max(perfs))]
            p = self.per_rank_perf.get(worst, Perf())
            parts = {
                "fwd_compute": p.fwd_compute,
                "fwd_comms": p.fwd_comms,
                "bwd_compute": p.bwd_compute,
                "bwd_comms": p.bwd_comms,
                "prefetch": p.prefetch,
            }
            dom = max(parts, key=parts.get)
            lines.append(
                f"  critical rank {worst}: dominated by {dom} "
                f"({100 * parts[dom] / (p.total + 1e-12):.0f}%)"
            )
        return "\n".join(lines)


def compare_plans(
    topology: Topology,
    plans: Dict[str, List[ShardingOption]],
) -> str:
    """Side-by-side critical-path comparison of candidate plans (e.g.
    planner-chosen vs uniform) — the reference logs the best/enumerated
    proposals' scores; this makes the comparison a one-call artifact."""
    lines = ["--- plan comparison " + "-" * 40]
    for name, plan in plans.items():
        st = EmbeddingStats()
        st._aggregate(plan, world_size=topology.world_size)
        perfs = [p.total for p in st.per_rank_perf.values()] or [0.0]
        hbms = [float(h) for h in st.per_rank_hbm.values()] or [0.0]
        lines.append(
            f"  {name:<16} critical_path={max(perfs) * 1e3:8.3f}ms "
            f"sum_perf={sum(perfs) * 1e3:8.3f}ms "
            f"max_hbm={max(hbms) / 2**30:.3f}GiB "
            f"perf_kl={_kl_divergence(perfs):.4f}"
        )
    return "\n".join(lines)
