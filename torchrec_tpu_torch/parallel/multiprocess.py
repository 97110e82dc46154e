"""Multi-process runtime: joining the process group, the rank and world
size, a host all-gather, and a launcher (a subset of
``torchrec_tpu/parallel/multiprocess.py``).

The JAX package is single-program multi-controller over one global mesh;
the port runs one process per rank, joined by a ``torch.distributed``
process group over a TCP store.  :func:`launch` is the torchrun analogue:
it binds the store in the calling process on a port the system picks,
then starts ``num_processes`` processes with the ``spawn`` start method,
each with its rank, the world size and the store's address in its
environment (``TORCHREC_MP_*``), and each worker calls :func:`initialize`
with its backend.  The port is bound before any rank sees it, so two
launches on one host never meet on a store.  :func:`replica_model_groups`
builds the model and replica groups of a 2D world (``DMPCollection``), and
the slice (ICI) and cross-slice (DCN) groups of a two-level world (the JAX
package's ``create_two_level_mesh``), which have the same shape.
:func:`_worker_env` is a spawned worker's environment, shared with
``reliability.ElasticSupervisor``, which starts its workers as scripts and
holds each generation's store the same way, and ``_BIND_FAILURE_RE`` the
signature of a store that could not bind, which its exit classifier reads.

Left out: ``SyncedCollisionCollection`` (ROADMAP A10) and
``make_global_batch`` (each rank feeds its own batch).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# env names the launcher sets for workers
_ENV_COORD = "TORCHREC_MP_COORDINATOR"
_ENV_NPROC = "TORCHREC_MP_NUM_PROCESSES"
_ENV_PID = "TORCHREC_MP_PROCESS_ID"

# a collective that waits longer than this on another rank raises
_TIMEOUT_S = 300.0

# a store-bind failure in a worker's output: an infrastructure loss (the
# port was taken), not the worker's own fault
_BIND_FAILURE_RE = (
    r"(address (is )?already in use|failed to bind|bind .*failed|"
    r"errno 98|EADDRINUSE)"
)


def initialize(
    backend: str,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join this process to the process group: ``backend`` ``"nccl"`` or
    ``"gloo"``, the store at ``coordinator_address`` (``host:port``), the
    world of ``num_processes``, rank ``process_id``.  The last three
    default to the ``TORCHREC_MP_*`` variables :func:`launch` sets; the
    launcher then holds the store and every rank joins it as a client.
    Given an address, rank 0 hosts the store there."""
    launched = coordinator_address is None
    addr = coordinator_address or os.environ[_ENV_COORD]
    n = int(num_processes if num_processes is not None
            else os.environ[_ENV_NPROC])
    rank = int(process_id if process_id is not None
               else os.environ[_ENV_PID])
    host, port = addr.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), n,
                          is_master=rank == 0 and not launched,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=n, rank=rank,
                            timeout=timeout)


def process_index() -> int:
    """Rank of this process (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Number of processes in the group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def replica_model_groups(
    num_replicas: int,
) -> Tuple[dist.ProcessGroup, dist.ProcessGroup]:
    """This rank's (model group, replica group) of a world of
    ``num_replicas`` replicas of ``M = world / num_replicas`` model ranks,
    global rank ``r * M + m`` (the JAX mesh's ``(replica, model)`` order):
    the model group of replica ``r`` holds ranks ``r * M .. r * M + M - 1``
    (group rank ``m``), the replica group of model rank ``m`` holds ranks
    ``m, M + m, ...`` (group rank ``r``).  ``dist.new_group`` is
    collective over the whole world, so every rank creates every group,
    model groups first, in the same order (a rank that skipped one, or
    took another order, would hang the launch).  With slices for replicas
    these are a two-level world's groups: the model group the slice's
    (ICI) group, the replica group the (DCN) group of one local rank
    across the slices, global rank ``slice * M + local`` (dcn-major)."""
    W, rank = dist.get_world_size(), dist.get_rank()
    if num_replicas < 1 or W % num_replicas:
        raise ValueError(f"{W} ranks do not split into {num_replicas} "
                         "replicas")
    M = W // num_replicas
    model = replica = None
    for r in range(num_replicas):
        g = dist.new_group([r * M + m for m in range(M)])
        if rank // M == r:
            model = g
    for m in range(M):
        g = dist.new_group([r * M + m for r in range(num_replicas)])
        if rank % M == m:
            replica = g
    return model, replica


def allgather_host(x: np.ndarray) -> np.ndarray:
    """Gather a same-shaped host array from every process, stacked on a
    new leading axis in rank order: one all-gather, through the card
    under NCCL (which moves CUDA tensors only) and in host memory under
    gloo."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if process_count() == 1:
        return np.asarray(x)[None]
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    n = process_count()
    out = t.new_empty(n * t.numel())  # gloo gathers along dim 0 only
    dist.all_gather_into_tensor(out, t.reshape(-1))
    return out.view((n,) + tuple(t.shape)).cpu().numpy()


def _worker_env(
    num_processes: int,
    pid: int,
    port: int,
    env_extra: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """The environment of one worker started as a script: the ambient
    environment, the ``TORCHREC_MP_*`` topology (the store at
    ``127.0.0.1:port``, held by the launching process) and
    ``env_extra``."""
    env = dict(os.environ)
    env.update({_ENV_COORD: f"127.0.0.1:{port}",
                _ENV_NPROC: str(num_processes),
                _ENV_PID: str(pid)})
    if env_extra:
        env.update(env_extra)
    return env


def _worker(fn, rank, num_processes, port, args, results) -> None:
    """One spawned rank: its topology into the environment, then
    ``fn(*args)``; the result or the traceback goes to ``results``."""
    os.environ.update({_ENV_COORD: f"127.0.0.1:{port}",
                       _ENV_NPROC: str(num_processes),
                       _ENV_PID: str(rank)})
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: B902 - reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_and_wait(fn, num_processes, port, args, timeout) -> List[tuple]:
    """One launch on a fixed port: every rank's ``(rank, ok, result or
    traceback)``; a rank that died without a report or exited non-zero,
    or a world that outran ``timeout``, counts as failed.  Every process
    is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(fn, r, num_processes, port, args, results))
             for r in range(num_processes)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < num_processes:
            why = None
            try:
                rank, ok, res = results.get(timeout=1.0)
                got[rank] = (rank, ok, res)
                if not ok:  # the others may wait on it forever
                    why = f"stopped after rank {rank} failed"
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    why = (f"rank {dead[0]} exited with "
                           f"{procs[dead[0]].exitcode} and no report")
                elif time.monotonic() > deadline:
                    why = f"timed out after {timeout} s"
            if why is not None:
                for r in range(num_processes):
                    got.setdefault(r, (r, False, f"rank {r}: {why}"))
                break
    finally:
        for p in procs:
            p.join(timeout=30 if all(ok for _, ok, _ in got.values())
                   else 0)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    for r, p in enumerate(procs):  # a rank that reported, then died
        if got.get(r, (r, False))[1] and p.exitcode != 0:
            got[r] = (r, False, f"rank {r} exited with {p.exitcode}")
    return [got[r] for r in range(num_processes)]


def launch(
    fn: Callable[..., Any],
    num_processes: int,
    args: Sequence[Any] = (),
    timeout: float = 600.0,
) -> List[Any]:
    """Run ``fn(*args)`` in ``num_processes`` spawned processes, one per
    rank (``fn`` is importable by name and calls :func:`initialize`), and
    return every rank's result in rank order.  Raises ``RuntimeError``
    with the failing ranks' tracebacks if any rank fails, dies or outruns
    ``timeout`` seconds; every process is stopped either way.  The store
    lives in this process, bound on a port the system picks, for the
    whole launch."""
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          timeout=datetime.timedelta(seconds=_TIMEOUT_S),
                          wait_for_workers=False)
    reports = _spawn_and_wait(fn, num_processes, store.port, args, timeout)
    failed = [(r, res) for r, ok, res in reports if not ok]
    if failed:
        raise RuntimeError("launch failed:\n" + "\n".join(
            f"--- rank {r} ---\n{res}" for r, res in failed))
    return [res for _, _, res in reports]
