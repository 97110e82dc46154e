"""Collective benchmarks over the ranks of a process group
(``torchrec_tpu/utils/benchmark_comms.py``; reference
``distributed/benchmark/benchmark_comms.py``): the pooled-embedding
collectives (all-to-all, reduce-scatter, all-gather) of
``parallel/qcomm.py`` at one payload shape, at each wire precision.

One process a rank: every rank of ``env`` calls the same function with the
same arguments.  Timing is
:func:`~torchrec_tpu_torch.utils.benchmark.benchmark_func`'s; the
effective bandwidth comes from the wire-byte model
(``qcomm.wire_bytes_per_f32``), and each result carries the bytes the
ledger (``wire_accounting``) recorded for one call, which equal that
model.

:func:`write_comms_calibration` merges a measured bandwidth into the
port's own planner calibration (``parallel/planner/types.py::
DEFAULT_CALIBRATION``); only a CUDA measurement across two or more
distinct cards qualifies, so ranks sharing one card never write.
:func:`merge_calibration` takes an ``fcntl`` lock on a sidecar file and
lands the ledger through a pid-unique temp file and ``os.replace``:
concurrent writers keep each other's keys and a reader never sees a torn
file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.planner.types import DEFAULT_CALIBRATION
from torchrec_tpu_torch.parallel.qcomm import (
    CommType,
    QCommsConfig,
    qcomm_all_gather,
    qcomm_all_to_all,
    qcomm_psum_scatter,
    wire_accounting,
    wire_bytes_per_f32,
)
from torchrec_tpu_torch.utils.benchmark import BenchmarkResult, benchmark_func

COLLECTIVES = ("all_to_all", "reduce_scatter", "all_gather")


@dataclasses.dataclass
class CommsBenchResult:
    """One collective's timing and its effective bandwidth."""

    result: BenchmarkResult
    payload_bytes_per_rank: int  # the model's wire bytes a rank sends a call
    ledger_bytes: float  # what wire_accounting recorded for one call

    @property
    def effective_gbps(self) -> float:
        ms = self.result.p50_ms
        if ms <= 0:
            return float("inf")
        return self.payload_bytes_per_rank / (ms * 1e-3) / 1e9

    def __str__(self) -> str:
        return f"{self.result}  eff_bw={self.effective_gbps:.1f}GB/s"


def _collective_fns(env: ShardingEnv, qcomms: Optional[QCommsConfig]
                    ) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    return {
        "all_to_all": lambda v: qcomm_all_to_all(v, env, qcomms, "fwd",
                                                 tag="bench"),
        "reduce_scatter": lambda v: qcomm_psum_scatter(v, env, qcomms, "fwd",
                                                       tag="bench"),
        "all_gather": lambda v: qcomm_all_gather(v, env, qcomms, "fwd",
                                                 tag="bench"),
    }


def benchmark_collectives(
    env: ShardingEnv,
    rows_per_rank: int = 1024,
    dim: int = 128,
    qcomms: Optional[QCommsConfig] = None,
    which: Sequence[str] = COLLECTIVES,
    warmup: int = 3,
    iters: int = 20,
) -> List[CommsBenchResult]:
    """The collectives of ``which`` at one payload: each rank's
    ``[N, rows_per_rank, dim]`` float32 (N ranks; the pooled output
    dist's shape), at the configured wire precision."""
    N = env.world_size
    prec_tag = qcomms.precision("fwd").value if qcomms is not None else "fp32"
    fns = _collective_fns(env, qcomms)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        N, rows_per_rank, dim).astype(np.float32)).to(env.device)
    payload = int(N * rows_per_rank * dim
                  * wire_bytes_per_f32(qcomms, "fwd", dim))
    out: List[CommsBenchResult] = []
    for name in which:
        body = fns[name]
        with wire_accounting() as ledger:
            body(x)
        res = benchmark_func(
            f"{name}[{prec_tag} {rows_per_rank}x{dim} N={N}]",
            lambda f=body: f(x), warmup=warmup, iters=iters)
        out.append(CommsBenchResult(result=res,
                                    payload_bytes_per_rank=payload,
                                    ledger_bytes=ledger.get("bench", 0.0)))
    return out


def merge_calibration(entries: dict, path: str = DEFAULT_CALIBRATION
                      ) -> None:
    """Merge ``entries`` into the calibration ledger at ``path``, safe
    against concurrent writers and crashes: an exclusive ``fcntl`` lock
    on ``path + ".lock"`` serializes the read-modify-write, and the
    merged ledger lands through a pid-unique temp file and
    ``os.replace``.  A dict-valued entry merges key by key into a dict
    already there (one level)."""
    lock_file = open(path + ".lock", "a")
    try:
        try:
            import fcntl

            fcntl.flock(lock_file, fcntl.LOCK_EX)
        except ImportError:  # not POSIX: the atomic replace still holds
            pass
        ledger = {}
        if os.path.exists(path):
            with open(path) as f:
                ledger = json.load(f)
        for key, value in entries.items():
            if isinstance(value, dict) and isinstance(ledger.get(key), dict):
                merged = dict(ledger[key])
                merged.update(value)
                ledger[key] = merged
            else:
                ledger[key] = value
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(ledger, f)
        os.replace(tmp, path)
    finally:
        lock_file.close()  # drops the lock


def write_comms_calibration(
    eff_gbps: float,
    collective: str,
    n_cards: int,
    device_kind: str,
    platform: str,
    n_hosts: int = 1,
    process_index: int = 0,
    path: str = DEFAULT_CALIBRATION,
) -> Optional[str]:
    """Merge a measured collective bandwidth into the planner's
    calibration (``Topology.load_calibration`` turns the constant from
    ASSUMED to MEASURED).  Only a ``"cuda"`` measurement across
    ``n_cards`` >= 2 distinct cards qualifies (ranks sharing one card
    measure the host's staging, not a link), and only process 0 writes.
    One host's cards bound ``ici_bw`` (NVLink), several hosts'
    ``dcn_bw``.  Returns the key written, or None."""
    if platform != "cuda" or n_cards < 2:
        return None
    if process_index != 0:
        return None
    key = "dcn_bw" if n_hosts > 1 else "ici_bw"
    merge_calibration({
        key: eff_gbps * 1e9,
        f"{key}_source": (
            f"benchmark_comms on {n_cards}x {device_kind} ({n_hosts} "
            f"host(s)): {collective} effective {eff_gbps:.1f} GB/s a card"),
    }, path=path)
    return key


def benchmark_qcomm_sweep(
    env: ShardingEnv,
    rows_per_rank: int = 1024,
    dim: int = 128,
    precisions: Sequence[CommType] = (CommType.FP32, CommType.BF16,
                                      CommType.INT8),
    warmup: int = 3,
    iters: int = 20,
) -> Dict[str, List[CommsBenchResult]]:
    """The all-to-all at each wire precision (the reference's qcomm
    variants), by precision name."""
    out: Dict[str, List[CommsBenchResult]] = {}
    for prec in precisions:
        cfg = (None if prec == CommType.FP32
               else QCommsConfig(forward_precision=prec))
        out[prec.value] = benchmark_collectives(
            env, rows_per_rank=rows_per_rank, dim=dim, qcomms=cfg,
            which=("all_to_all",), warmup=warmup, iters=iters)
    return out
