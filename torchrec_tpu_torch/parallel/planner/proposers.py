"""Proposal generation — candidate plans from enumerated options.

Reference: ``planner/proposers.py`` — GreedyProposer (:34, per-table best
option by perf), UniformProposer (:137, same sharding type for all tables),
and the grid-search proposer (:207) for small search spaces.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, Iterator, List

from torchrec_tpu_torch.parallel.planner.types import ShardingOption
from torchrec_tpu_torch.parallel.types import EmbeddingComputeKernel, ShardingType


def _by_table(options: List[ShardingOption]) -> Dict[str, List[ShardingOption]]:
    out: Dict[str, List[ShardingOption]] = {}
    for o in options:
        out.setdefault(o.name, []).append(o)
    return out


class GreedyProposer:
    """Yield plans: first the per-table perf-best option, then successive
    demotions of the worst table to its next-best option."""

    def __init__(self, max_proposals: int = 20):
        self.max_proposals = max_proposals

    def propose(
        self, options: List[ShardingOption]
    ) -> Iterator[List[ShardingOption]]:
        by_table = {
            t: sorted(opts, key=lambda o: o.total_perf)
            for t, opts in _by_table(options).items()
        }
        index = {t: 0 for t in by_table}
        for _ in range(self.max_proposals):
            yield [by_table[t][i] for t, i in index.items()]
            # demote the table whose current choice dominates perf
            movable = [
                t for t, i in index.items() if i + 1 < len(by_table[t])
            ]
            if not movable:
                return
            worst = max(
                movable, key=lambda t: by_table[t][index[t]].total_perf
            )
            index[worst] += 1


class UniformProposer:
    """One proposal per sharding type applied to every table
    (reference :137)."""

    def propose(
        self, options: List[ShardingOption]
    ) -> Iterator[List[ShardingOption]]:
        by_table = _by_table(options)
        for st in ShardingType:
            plan = []
            ok = True
            for t, opts in by_table.items():
                match = [o for o in opts if o.sharding_type == st]
                if not match:
                    ok = False
                    break
                plan.append(min(match, key=lambda o: o.total_perf))
            if ok and plan:
                yield plan


class GridSearchProposer:
    """Exhaustive product for small spaces (reference :207)."""

    def __init__(self, max_proposals: int = 200):
        self.max_proposals = max_proposals

    def propose(
        self, options: List[ShardingOption]
    ) -> Iterator[List[ShardingOption]]:
        by_table = _by_table(options)
        tables = list(by_table)
        space = 1
        for t in tables:
            space *= len(by_table[t])
        if space > self.max_proposals:
            return
        for combo in itertools.product(*(by_table[t] for t in tables)):
            yield list(combo)


class DynamicProgrammingProposer:
    """HBM-binned dynamic program (reference ``planner/proposers.py:287``
    ``DynamicProgrammingProposer``): discretize the global HBM budget into
    bins, then dp[t][b] = min total perf over tables 0..t using <= b bins
    of storage.  Yields the optimal-by-total-perf plan for the full
    budget, then for progressively tighter budgets (useful when the
    partitioner rejects the loosest plan for per-device imbalance)."""

    def __init__(self, hbm_budget_bytes: int, num_bins: int = 100):
        self.budget = int(hbm_budget_bytes)
        self.num_bins = num_bins

    def propose(
        self, options: List[ShardingOption]
    ) -> Iterator[List[ShardingOption]]:
        by_table = _by_table(options)
        tables = list(by_table)
        if not tables or self.budget <= 0:
            return
        # ceil so an option consuming the exact budget still fits its bins
        bin_size = max(1, -(-self.budget // self.num_bins))
        B = self.num_bins

        def bins_of(o: ShardingOption) -> int:
            # may exceed B: such an option is over-budget outright and is
            # skipped in the transition (never clamped into feasibility)
            return -(-o.total_storage.hbm // bin_size)

        INF = float("inf")
        # dp[b] = (total perf, choice list) best using <= b bins
        dp = [(0.0, []) for _ in range(B + 1)]
        feasible = True
        for t in tables:
            nxt = [(INF, None) for _ in range(B + 1)]
            for b in range(B + 1):
                prev_perf, prev_choice = dp[b]
                if prev_choice is None or prev_perf == INF:
                    continue
                for o in by_table[t]:
                    nb = b + bins_of(o)
                    if nb > B:
                        continue
                    cand = prev_perf + o.total_perf
                    if cand < nxt[nb][0]:
                        nxt[nb] = (cand, prev_choice + [o])
            # prefix-min so dp[b] = best using <= b bins
            best = (INF, None)
            for b in range(B + 1):
                if nxt[b][0] < best[0]:
                    best = nxt[b]
                nxt[b] = best
            dp = nxt
            if dp[B][1] is None:
                feasible = False
                break
        if not feasible:
            return
        seen = set()
        for b in range(B, 0, -B // 4 or 1):
            perf, choice = dp[b]
            if choice is None:
                continue
            key = tuple(id(o) for o in choice)
            if key in seen:
                continue
            seen.add(key)
            yield list(choice)


class CacheScaleupProposer:
    """Scale host-offloaded device caches into leftover HBM (reference
    ``planner/proposers.py:471`` ``EmbeddingOffloadScaleupProposer``).

    Wraps a base proposer: for each base proposal containing
    FUSED_HOST_CACHED options, binary-search the largest uniform
    multiplier on their ``cache_load_factor`` (capped at 1.0 per table)
    whose re-estimated storage still fits the global HBM budget, then
    yield the scaled proposal (larger caches -> lower miss traffic ->
    better perf, at zero cost when HBM would otherwise sit idle).
    Non-cached proposals pass through unchanged."""

    def __init__(self, base, storage_estimator, perf_estimator,
                 hbm_budget_bytes: int, search_iters: int = 12):
        self.base = base
        self.storage_estimator = storage_estimator
        self.perf_estimator = perf_estimator
        self.budget = int(hbm_budget_bytes)
        self.search_iters = search_iters

    def _scaled(
        self,
        proposal: List[ShardingOption],
        mult: float,
        with_perf: bool = True,
    ):
        """``with_perf=False`` for fit-search probes: the search only
        reads storage, so skip the (much costlier) perf pass there."""
        out = copy.deepcopy(proposal)
        for o in out:
            if o.compute_kernel == EmbeddingComputeKernel.FUSED_HOST_CACHED:
                o.cache_load_factor = min(
                    1.0, (o.cache_load_factor or 0.0) * mult
                )
        self.storage_estimator.estimate(out)
        if with_perf:
            self.perf_estimator.estimate(out)
        return out

    def _fits(self, proposal: List[ShardingOption]) -> bool:
        total = sum(o.total_storage.hbm for o in proposal)
        return total <= self.budget

    def propose(
        self, options: List[ShardingOption]
    ) -> Iterator[List[ShardingOption]]:
        for proposal in self.base.propose(options):
            cached = [
                o
                for o in proposal
                if o.compute_kernel == EmbeddingComputeKernel.FUSED_HOST_CACHED
            ]
            if not cached or not self._fits(proposal):
                # nothing to scale: the planner already runs the base
                # proposer standalone, so don't re-yield its proposals
                continue
            # binary search the scale-up multiplier in [1, max_mult]
            max_mult = max(
                1.0 / max(o.cache_load_factor or 1.0, 1e-6) for o in cached
            )
            if self._fits(self._scaled(proposal, max_mult, with_perf=False)):
                m_fit = max_mult  # every cache reaches the whole table
            else:
                lo, hi = 1.0, max_mult
                for _ in range(self.search_iters):
                    mid = (lo + hi) / 2
                    if self._fits(
                        self._scaled(proposal, mid, with_perf=False)
                    ):
                        lo = mid
                    else:
                        hi = mid
                m_fit = lo
            # the global-budget fit can still exceed one DEVICE's capacity
            # (a TW cache lives whole on its owner rank) and be rejected by
            # the partitioner — yield a descending ladder so the planner
            # keeps the largest per-device-feasible scale-up (the
            # reference's proposer<->partitioner feedback loop,
            # planner/proposers.py:471)
            # (the unscaled m=1 proposal comes from the standalone base
            # proposer, so the ladder stops above it)
            mults = [m_fit]
            extra = m_fit - 1.0
            while extra > 0.05:
                extra /= 2
                mults.append(1.0 + extra)
            seen_m = set()
            for m in mults:
                key = round(m, 6)
                if key in seen_m or key <= 1.0:
                    continue
                seen_m.add(key)
                yield self._scaled(proposal, m)
