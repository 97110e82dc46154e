"""Shard placement onto devices.

Reference: ``planner/partitioners.py`` — ``GreedyPerfPartitioner`` (:176,
heaviest-shard-first onto the least-loaded feasible device; TW/CW shards
pick one owner, RW/TWRW shards are placed by construction) and
``MemoryBalancedPartitioner`` (:694).
"""

from __future__ import annotations

import copy
from typing import List

from torchrec_tpu_torch.parallel.planner.types import (
    DeviceHardware,
    Perf,
    PlannerError,
    ShardingOption,
    Storage,
    Topology,
)
from torchrec_tpu_torch.parallel.types import ShardingType


def _fits(dev: DeviceHardware, storage: Storage) -> bool:
    return storage.hbm <= dev.storage.hbm and storage.ddr <= dev.storage.ddr


def _charge(dev: DeviceHardware, storage: Storage, perf: Perf) -> None:
    dev.storage = Storage(
        hbm=dev.storage.hbm - storage.hbm, ddr=dev.storage.ddr - storage.ddr
    )
    dev.perf = dev.perf + perf


class GreedyPerfPartitioner:
    """Place proposed options; mutates shard.rank.  Raises PlannerError if
    infeasible."""

    def __init__(self, topology: Topology):
        self.topology = topology

    @staticmethod
    def _order_key(opt: ShardingOption):
        """Placement order: heaviest perf first."""
        return -opt.total_perf

    @staticmethod
    def _select_key(dev: DeviceHardware):
        """Owner choice for TW/CW shards: least loaded by perf."""
        return (dev.perf.total, -dev.storage.hbm)

    def partition(
        self, proposal: List[ShardingOption]
    ) -> List[ShardingOption]:
        devices = copy.deepcopy(self.topology.devices)
        N = self.topology.world_size
        node = self.topology.slice_size or N
        ordered = sorted(proposal, key=self._order_key)
        for opt in ordered:
            st = opt.sharding_type
            if st == ShardingType.DATA_PARALLEL:
                # replicated on every device
                for dev in devices:
                    if not _fits(dev, opt.shards[0].storage):
                        raise PlannerError(
                            f"{opt.name}: DP replica does not fit on rank "
                            f"{dev.rank}"
                        )
                for dev in devices:
                    _charge(dev, opt.shards[0].storage, opt.shards[0].perf)
                for s in opt.shards:
                    s.rank = 0
            elif st in (ShardingType.TABLE_WISE, ShardingType.COLUMN_WISE):
                for s in opt.shards:
                    # least-loaded-by-perf feasible device
                    cands = [d for d in devices if _fits(d, s.storage)]
                    if not cands:
                        raise PlannerError(
                            f"{opt.name}: no device fits shard "
                            f"({s.storage.hbm / 2**30:.2f} GiB)",
                            self._debug(devices),
                        )
                    dev = min(cands, key=self._select_key)
                    s.rank = dev.rank
                    _charge(dev, s.storage, s.perf)
            elif st == ShardingType.ROW_WISE:
                assert len(opt.shards) == N
                for r, s in enumerate(opt.shards):
                    if not _fits(devices[r], s.storage):
                        raise PlannerError(
                            f"{opt.name}: RW block does not fit on rank {r}",
                            self._debug(devices),
                        )
                    s.rank = r
                    _charge(devices[r], s.storage, s.perf)
            elif st in (ShardingType.TABLE_ROW_WISE, ShardingType.GRID_SHARD):
                # each column group of `node` shards goes to the
                # least-loaded slice
                n_groups = len(opt.shards) // node
                slices = list(range(N // node))
                for gi in range(n_groups):
                    group = opt.shards[gi * node : (gi + 1) * node]

                    def slice_load(si):
                        return sum(
                            devices[si * node + j].perf.total
                            for j in range(node)
                        )

                    feasible = [
                        si
                        for si in slices
                        if all(
                            _fits(devices[si * node + j], group[j].storage)
                            for j in range(node)
                        )
                    ]
                    if not feasible:
                        raise PlannerError(
                            f"{opt.name}: no slice fits TWRW/GRID group",
                            self._debug(devices),
                        )
                    si = min(feasible, key=slice_load)
                    for j, s in enumerate(group):
                        s.rank = si * node + j
                        _charge(devices[si * node + j], s.storage, s.perf)
            else:
                raise PlannerError(f"unknown sharding type {st}")
        self.last_devices = devices
        return proposal

    @staticmethod
    def _debug(devices: List[DeviceHardware]) -> str:
        lines = [
            f"  rank {d.rank}: free hbm={d.storage.hbm / 2**30:.2f} GiB "
            f"perf={d.perf.total * 1e3:.2f} ms"
            for d in devices
        ]
        return "per-rank state:\n" + "\n".join(lines)


class MemoryBalancedPartitioner(GreedyPerfPartitioner):
    """Balance HBM instead of perf (reference :694) — same placement loop
    with storage-driven ordering and owner choice."""

    @staticmethod
    def _order_key(opt: ShardingOption):
        return -opt.total_storage.hbm

    @staticmethod
    def _select_key(dev: DeviceHardware):
        # most free memory first; perf as tiebreaker
        return (-dev.storage.hbm, dev.perf.total)
