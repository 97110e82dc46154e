"""The model-parallel world: a ``torch.distributed`` process group in
place of the JAX package's mesh axis (a subset of
``torchrec_tpu/parallel/comm.py``).

The JAX package names its collectives by mesh axis inside ``shard_map``;
the port runs one process per rank, each with its own device, and names
them by a :class:`ShardingEnv`: the world size, this rank, the process
group and the rank's device.  The backend is the caller's choice,
``"nccl"`` (one card per rank) or ``"gloo"`` (any device; on CUDA tensors
it stages them through host memory itself), and so is the device: nothing
here picks either quietly.

The collectives the sharded modules use are the three below, each over
``torch.distributed`` on the env's group (at one rank too, when it has
one), and each the identity at one rank with no group.  Sums over ranks are taken here, in rank order
(:func:`sum_over_ranks`), not by the backend's reduction, so they give
the same bits over NCCL and gloo and on every rank.

Left out: the hybrid and two-level meshes (``create_hybrid_mesh``,
``create_two_level_mesh``, ROADMAP A8), the replica and DCN axes, and
``device_put_global`` (each rank builds its own share).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class ShardingEnv:
    """The world one model-parallel step runs over: ``world_size``
    ranks, this process's ``rank``, the ``group`` the collectives run on
    (None only at one rank) and the rank's ``device``."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None

    def __post_init__(self):
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world_size}")
        if self.world_size > 1 and self.group is None:
            raise ValueError(f"a world of {self.world_size} ranks needs a "
                             "process group")

    @staticmethod
    def single_device(device: DeviceLike = None) -> "ShardingEnv":
        """One rank, no process group: the collectives are the identity.
        The device is CUDA unless the caller names another."""
        return ShardingEnv(1, 0, resolve_device(device))

    @staticmethod
    def from_process_group(
        backend: str, device: DeviceLike = None
    ) -> "ShardingEnv":
        """The env of this process in the initialised default process
        group.  ``backend`` must be the group's: ``"nccl"`` or ``"gloo"``.  The device is the caller's; with none
        named, or a CUDA device with no index, it is
        ``cuda:{LOCAL_RANK}`` (the local rank from the environment, else
        the rank), and no card raises."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "multiprocess.initialize first")
        actual = dist.get_backend()
        if actual != backend:
            raise ValueError(f"the process group runs {actual!r}, not "
                             f"{backend!r}")
        rank = dist.get_rank()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {dev}")
        return ShardingEnv(dist.get_world_size(), rank, dev,
                           dist.group.WORLD, backend)


def resolve_env(env: Optional[ShardingEnv], world_size: int,
                device: torch.device) -> ShardingEnv:
    """The env a group's dists run on: ``env``, or the identity world of
    one rank on ``device`` when none is given at ``world_size == 1``."""
    if env is None:
        if world_size != 1:
            raise ValueError(f"a group over {world_size} ranks needs a "
                             "ShardingEnv for its dists")
        return ShardingEnv(1, 0, device)
    if env.world_size != world_size:
        raise ValueError(f"layout for {world_size} ranks, env of "
                         f"{env.world_size}")
    return env


def all_to_all(x: torch.Tensor, env: ShardingEnv) -> torch.Tensor:
    """``[N, ...]`` -> ``[N, ...]``: block ``d`` of ``x`` goes to rank
    ``d``, and block ``j`` of the result is the block rank ``j`` sent this
    rank (a new contiguous tensor)."""
    x = x.contiguous()
    if env.group is None:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=env.group)
    return out


def all_gather(x: torch.Tensor, env: ShardingEnv) -> torch.Tensor:
    """``[N, *x.shape]``: every rank's ``x`` in rank order."""
    if env.group is None:
        return x.unsqueeze(0).clone()
    flat = x.reshape(-1).contiguous()  # gloo gathers along dim 0 only
    out = flat.new_empty(env.world_size * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=env.group)
    return out.view((env.world_size,) + tuple(x.shape))


def sum_over_ranks(blocks: torch.Tensor) -> torch.Tensor:
    """``blocks[0] + blocks[1] + ...`` over the leading (rank) axis, one
    add at a time in rank order, so the bits do not depend on a backend's
    or a reduction kernel's order."""
    acc = blocks[0].clone()
    for b in blocks[1:]:
        acc = acc + b
    return acc


def all_reduce_sum(x: torch.Tensor, env: ShardingEnv) -> torch.Tensor:
    """The sum of ``x`` over ranks, the same bits on every rank: an
    all-gather, then :func:`sum_over_ranks`."""
    if env.group is None:
        return x.clone()
    return sum_over_ranks(all_gather(x, env))
