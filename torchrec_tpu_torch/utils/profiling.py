"""Counter-key namespace and the bucketing pipeline's padding counters (a
subset of ``torchrec_tpu/utils/profiling.py``)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def counter_key(prefix: str, table: str, counter: str) -> str:
    """THE per-table counter namespace: ``<prefix>/<table>/<counter>``."""
    return f"{prefix}/{table}/{counter}"


class PaddingStats:
    """Host-side padding counters of the capacity-bucketing pipeline
    (``parallel/train_pipeline.py``): batches, id slots shipped under the
    bucketed and under the static capacities, dispatches per signature,
    round-up fallbacks and programs.

    The port compiles nothing: a "program" here is one signature's
    ``DistributedModelParallel.with_feature_caps`` clone, built on first
    use (the JAX package counts compiled executables).  Left out: the
    compile count, the overflow-fallback count of the dedup overflow
    guard, per-key sums and the wire-byte ledgers."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.batches = 0
        self.real_ids = 0
        self.bucketed_slots = 0
        self.static_slots = 0
        self.fallback_count = 0
        self.program_count = 0
        self.dispatch_counts: Dict[Tuple[int, ...], int] = {}

    def record_batch(
        self,
        occupancy: Sequence[int],
        bucketed_caps: Sequence[int],
        static_caps: Sequence[int],
    ) -> None:
        self.batches += 1
        self.real_ids += sum(int(x) for x in occupancy)
        self.bucketed_slots += sum(int(x) for x in bucketed_caps)
        self.static_slots += sum(int(x) for x in static_caps)

    def record_dispatch(self, signature: Sequence[int]) -> None:
        sig = tuple(signature)
        self.dispatch_counts[sig] = self.dispatch_counts.get(sig, 0) + 1

    def record_program(self) -> None:
        self.program_count += 1

    def record_fallback(self) -> None:
        self.fallback_count += 1

    def padding_efficiency(self) -> float:
        """Real ids / bucketed id slots, in (0, 1]."""
        return self.real_ids / max(1, self.bucketed_slots)

    def padded_bytes_ratio(self) -> float:
        """Bucketed / static id slots shipped (below 1: padding saved)."""
        return self.bucketed_slots / max(1, self.static_slots)

    def scalar_metrics(self, prefix: str = "bucketing") -> Dict[str, float]:
        return {
            f"{prefix}/batches": float(self.batches),
            f"{prefix}/dispatch_count": float(
                sum(self.dispatch_counts.values())),
            f"{prefix}/program_count": float(self.program_count),
            f"{prefix}/fallback_count": float(self.fallback_count),
            f"{prefix}/padding_efficiency": self.padding_efficiency(),
            f"{prefix}/padded_bytes_ratio": self.padded_bytes_ratio(),
        }
