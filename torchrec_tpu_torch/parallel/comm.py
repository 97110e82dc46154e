"""The model-parallel world: ``torch.distributed`` process groups in
place of the JAX package's mesh axes (a subset of
``torchrec_tpu/parallel/comm.py``), and the wire-byte ledger.

The JAX package names its collectives by mesh axis inside ``shard_map``;
the port runs one process per rank, each with its own device, and names
them by a :class:`ShardingEnv`: the world size, this rank, the process
group and the rank's device.  The backend is the caller's choice,
``"nccl"`` (one card per rank) or ``"gloo"`` (any device; on CUDA tensors
it stages them through host memory itself), and so is the device: nothing
here picks either quietly.

A 2D world (``DMPCollection``, the JAX package's ``(replica, model)``
mesh) is ``num_replicas`` replicas of ``world_size`` model ranks: global
rank ``r * world_size + m`` is model rank ``m`` of replica ``r``.  Its
env's ``group`` is the model group (the ``world_size`` ranks of one
replica, where the dists run), ``replica_group`` the ``num_replicas``
ranks holding one model rank (the replica sync and the FULLY_SHARDED
gathers), and ``global_group`` every rank (the dense mean);
:attr:`ShardingEnv.replica_env` and :attr:`ShardingEnv.global_env` are
those worlds as envs of their own.  ``world_size`` stays the model
group's size, as in the JAX package.

The collectives the sharded modules use are the ones below, each over
``torch.distributed`` on the env's group (at one rank too, when it has
one), and each the identity at one rank with no group.  Sums over ranks
are taken here, in rank order (:func:`sum_over_ranks`), not by the
backend's reduction, so they give the same bits over NCCL and gloo and
on every rank.

A two-level world (the JAX package's ``create_two_level_mesh``, its
``(dcn, model)`` mesh) is ``num_slices`` slices of ``ici_size`` ranks:
global rank ``slice * ici_size + local``, dcn-major as in JAX.  Its env
keeps the whole world as ``group`` (the flat dists run there) and adds an
``ici_group`` (the ``ici_size`` ranks of this rank's slice) and a
``dcn_group`` (the ``num_slices`` ranks of this local rank, one a slice),
built by ``multiprocess.replica_model_groups`` with slices for replicas; :attr:`ShardingEnv.ici_env`
and :attr:`ShardingEnv.dcn_env` are those worlds as envs of their own.
One card's ranks are all one slice in fact: the slices are a topology
the dists are told of, which sets the link class each leg is recorded
under.

The ledger (:func:`wire_accounting`) records the logical payload of each
collective per tag as the JAX package's does while it traces: the send
buffer at wire precision, times the fan-out for an all-gather,
self-chunks included.  The port runs eagerly, so it records at call
time: every call inside the context adds its bytes.  Every record also
lands under the link classes :data:`LINK_ICI` / :data:`LINK_DCN`, split
by the share of the payload that crosses a slice boundary
(:func:`cross_slice_fraction` of the slices the collective spans:
:attr:`ShardingEnv.dcn_fraction`); on a flat world all of it is ICI.

Left out: ``create_hybrid_mesh`` and ``device_put_global`` (each rank
builds its own share).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")

_WIRE_LEDGER: Optional[Dict[str, float]] = None

LINK_ICI = "link:ici"
LINK_DCN = "link:dcn"
LINK_TAGS = (LINK_ICI, LINK_DCN)


@contextlib.contextmanager
def wire_accounting() -> Iterator[Dict[str, float]]:
    """Collect per-tag wire bytes of every collective called inside the
    context.  Nested contexts shadow (inner calls record inner)."""
    global _WIRE_LEDGER
    prev = _WIRE_LEDGER
    ledger: Dict[str, float] = {}
    _WIRE_LEDGER = ledger
    try:
        yield ledger
    finally:
        _WIRE_LEDGER = prev


def record_wire_bytes(tag: str, nbytes: float,
                      dcn_fraction: float = 0.0) -> None:
    """Add ``nbytes`` to the active ledger (no-op outside
    :func:`wire_accounting`), and split the same bytes into the
    :data:`LINK_ICI` / :data:`LINK_DCN` entries by ``dcn_fraction``, the
    share that crosses a slice boundary (0: all intra-slice)."""
    if _WIRE_LEDGER is None:
        return
    nbytes = float(nbytes)
    _WIRE_LEDGER[tag] = _WIRE_LEDGER.get(tag, 0.0) + nbytes
    dcn = nbytes * min(1.0, max(0.0, float(dcn_fraction)))
    _WIRE_LEDGER[LINK_ICI] = _WIRE_LEDGER.get(LINK_ICI, 0.0) + (nbytes - dcn)
    _WIRE_LEDGER[LINK_DCN] = _WIRE_LEDGER.get(LINK_DCN, 0.0) + dcn


def cross_slice_fraction(num_slices: int) -> float:
    """The share of an all-to-all, reduce-scatter or all-gather payload
    that crosses a slice boundary when the collective spans
    ``num_slices`` slices: ``(S - 1) / S`` (the chunks to the own slice,
    the self-chunk included, stay on ICI)."""
    s = max(1, int(num_slices))
    return (s - 1) / s


@dataclasses.dataclass(frozen=True)
class ShardingEnv:
    """The world one model-parallel step runs over: ``world_size`` model
    ranks, this process's model ``rank``, the ``group`` the collectives
    run on (None only at one rank) and the rank's ``device``; in a 2D
    world also ``num_replicas``, this process's ``replica_rank``, the
    ``replica_group`` and the ``global_group`` of every rank; in a
    two-level world ``num_slices``, the ``ici_group`` and the
    ``dcn_group`` (module docstring)."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None
    num_replicas: int = 1
    replica_rank: int = 0
    replica_group: Optional[dist.ProcessGroup] = None
    global_group: Optional[dist.ProcessGroup] = None
    num_slices: int = 1
    ici_group: Optional[dist.ProcessGroup] = None
    dcn_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world_size}")
        if self.world_size > 1 and self.group is None:
            raise ValueError(f"a world of {self.world_size} ranks needs a "
                             "process group")
        if not 0 <= self.replica_rank < self.num_replicas:
            raise ValueError(f"replica {self.replica_rank} outside "
                             f"{self.num_replicas} replicas")
        if self.num_replicas > 1 and (self.replica_group is None
                                      or self.global_group is None):
            raise ValueError(f"{self.num_replicas} replicas need a replica "
                             "group and a global group")
        if self.num_slices < 1 or self.world_size % self.num_slices:
            raise ValueError(f"{self.world_size} ranks do not split into "
                             f"{self.num_slices} slices")
        if self.num_slices > 1:
            if self.num_replicas > 1:
                raise NotImplementedError(
                    "a two-level world of replicas: the JAX package has no "
                    "such mesh either")
            if (self.ici_size > 1 and self.ici_group is None) or (
                    self.dcn_group is None):
                raise ValueError(f"{self.num_slices} slices need an ici "
                                 "group and a dcn group")

    @property
    def ici_size(self) -> int:
        """The ranks of one slice."""
        return self.world_size // self.num_slices

    @property
    def slice_rank(self) -> int:
        """This rank's slice: ``rank // ici_size`` (dcn-major)."""
        return self.rank // self.ici_size

    @property
    def dcn_fraction(self) -> float:
        """The share of a collective over this world that crosses a slice
        boundary (the ledger's link-class split)."""
        return cross_slice_fraction(self.num_slices)

    @property
    def ici_env(self) -> "ShardingEnv":
        """This rank's slice as a world of its own (rank: the local
        rank); the env itself on a one-slice world."""
        if self.num_slices == 1:
            return self
        return ShardingEnv(self.ici_size, self.rank % self.ici_size,
                           self.device, self.ici_group, self.backend)

    @property
    def dcn_env(self) -> "ShardingEnv":
        """The ranks of this local rank, one a slice, as a world of
        ``num_slices`` one-rank slices (rank: the slice): each of its
        collectives crosses the slice boundary but for the self-chunk."""
        return ShardingEnv(self.num_slices, self.slice_rank, self.device,
                           self.dcn_group, self.backend,
                           num_slices=self.num_slices,
                           dcn_group=self.dcn_group)

    @property
    def global_rank(self) -> int:
        """``replica_rank * world_size + rank``: the JAX mesh's
        ``(replica, model)`` order."""
        return self.replica_rank * self.world_size + self.rank

    @property
    def global_size(self) -> int:
        """Every rank of the 2D world: ``num_replicas * world_size``."""
        return self.num_replicas * self.world_size

    @property
    def replica_env(self) -> "ShardingEnv":
        """The ``num_replicas`` ranks that hold this model rank, as a
        world of its own (rank: the replica)."""
        return ShardingEnv(self.num_replicas, self.replica_rank, self.device,
                           self.replica_group, self.backend)

    @property
    def global_env(self) -> "ShardingEnv":
        """Every rank of the 2D world as one world (rank: the global
        rank); the env itself with one replica."""
        if self.num_replicas == 1:
            return self
        return ShardingEnv(self.global_size, self.global_rank, self.device,
                           self.global_group, self.backend)

    @staticmethod
    def single_device(device: DeviceLike = None) -> "ShardingEnv":
        """One rank, no process group: the collectives are the identity.
        The device is CUDA unless the caller names another."""
        return ShardingEnv(1, 0, resolve_device(device))

    @staticmethod
    def from_process_group(
        backend: str, device: DeviceLike = None, num_replicas: int = 1,
        num_slices: int = 1,
    ) -> "ShardingEnv":
        """The env of this process in the initialised default process
        group.  ``backend`` must be the group's: ``"nccl"`` or ``"gloo"``.
        The device is the caller's; with none named, or a CUDA device with
        no index, it is ``cuda:{LOCAL_RANK}`` (the local rank from the
        environment, else the rank), and no card raises.  With
        ``num_replicas`` R > 1 the world is R replicas of ``world size /
        R`` model ranks, their groups built by
        ``multiprocess.replica_model_groups`` (a collective: every rank
        calls it, in the same order as its other groups).  With
        ``num_slices`` S > 1 the world is two-level: S slices of ``world
        size / S`` ranks, global rank ``slice * (W / S) + local``, the
        groups built by ``multiprocess.replica_model_groups`` (a
        collective too)."""
        from torchrec_tpu_torch.parallel.multiprocess import (
            replica_model_groups,
        )

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
        W = dist.get_world_size()
        if num_slices > 1:
            if num_replicas != 1:
                raise NotImplementedError("a two-level world of replicas")
            ici, dcn = replica_model_groups(num_slices)
            return ShardingEnv(W, rank, dev, dist.group.WORLD, backend,
                               num_slices=num_slices, ici_group=ici,
                               dcn_group=dcn)
        if num_replicas == 1:
            return ShardingEnv(W, rank, dev, dist.group.WORLD, backend)
        model, replica = replica_model_groups(num_replicas)
        M = W // num_replicas
        return ShardingEnv(M, rank % M, dev, model, backend, num_replicas,
                           rank // M, replica, dist.group.WORLD)


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
    if x.dtype == torch.bool:  # crosses the wire as bytes
        return all_to_all(x.view(torch.uint8), env).view(torch.bool)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=env.group)
    return out


def all_gather(x: torch.Tensor, env: ShardingEnv) -> torch.Tensor:
    """``[N, *x.shape]``: every rank's ``x`` in rank order."""
    if env.group is None:
        return x.unsqueeze(0).clone()
    if x.dtype == torch.bool:
        return all_gather(x.view(torch.uint8), env).view(torch.bool)
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


def all_reduce_sum(x: torch.Tensor, env: ShardingEnv,
                   tag: str = "all_reduce") -> torch.Tensor:
    """The sum of ``x`` over ranks, the same bits on every rank: a
    reduce-scatter (an all-to-all of ``x`` cut into ``N`` pieces, padded
    to a multiple of ``N``, then :func:`sum_over_ranks` of the piece this
    rank owns), then an all-gather of the reduced pieces.  Each element is
    summed in rank order, as an all-gather of ``x`` and a rank-order sum
    would, but a rank sends about ``2 (N - 1) / N`` of ``x`` instead of
    ``N - 1`` copies.  The ledger records both collectives under ``tag``
    (``2 N`` pieces of ``x``'s dtype)."""
    if env.group is None:
        return x.clone()
    N = env.world_size
    flat = x.reshape(-1)
    piece = -(-flat.numel() // N)
    padded = flat.new_zeros(N * piece)
    padded[:flat.numel()] = flat
    record_wire_bytes(tag, 2 * N * piece * x.element_size(), env.dcn_fraction)
    mine = sum_over_ranks(all_to_all(padded.view(N, piece), env))
    return all_gather(mine, env).reshape(-1)[:flat.numel()].view(x.shape)
