"""Fused sparse optimizer application, "optimizer in the backward"
(a subset of ``torchrec_tpu/ops/fused_update.py``).

The train step hands each sharded group's segment-level gradient
(:class:`SparseSegGrad`) to :func:`apply_sparse_update_segments`, which
runs one of the fused backward + optimizer kernels of
``ops/tbe_backward.py``: duplicate ids are aggregated and each touched
row's weight and optimizer state are read and written once, in place.
The kernel is an argument: ``"tbe"`` is the per-id kernel (the port of
``pallas_fused_sparse_update``, B2) and ``"dedup"`` the dedup kernel (the
port of ``pallas_dedup_fused_sparse_update``, B6), each for all eight
optimizers.  The JAX package's process-wide switch is here too
(:func:`set_sparse_update_kernel`, :data:`UPDATE_KERNELS` with the JAX
names, the environment override ``TORCHREC_TPU_SPARSE_UPDATE_KERNEL``,
held under ``embedding_ops.TRACE_KERNEL_LOCK``): ``"xla"`` and
``"pallas"`` select B2, ``"pallas_dedup"`` B6
(:func:`resolve_update_kernel`); the port reads it when a DMP is built
with no ``update_kernel``, the counterpart of the JAX package reading it
at trace time.  Its ``chunk``, ``group`` and ``interpret`` options size or
emulate the TPU kernel and do nothing here; ``id_cap`` has no counterpart
either (the port's grid covers the slots it is given).
The Adam family's bias corrections are those of the incremented step, as
the JAX package computes them for either kernel
(``ops/fused_update.py:475-483``).

State layouts, as in the JAX package:

* sgd, lars_sgd: ``{}``;
* rowwise_adagrad: ``momentum`` ``[R]``; adagrad: ``momentum`` ``[R, D]``;
* adam, lamb: ``m`` and ``v`` ``[R, D]`` and ``step``;
* partial_rowwise_adam, partial_rowwise_lamb: ``m`` ``[R, D]``, ``v``
  ``[R]`` and ``step``.

The states are tensors of ``FusedOptimConfig.momentum_dtype``: float32,
bfloat16 or float16 (both kernels read and write each; the arithmetic is
the JAX package's XLA update's, ``tbe_backward.update_rows``), and
``step``, the Adam family's count of applied updates, is a Python int (the
JAX package keeps an int32 array).  :func:`apply_sparse_update` is the
JAX package's XLA path, ``aggregate_duplicate_rows`` + the optimizer
math, and is the dedup kernel's plain version.
:meth:`SparseSegGrad.from_row_grads` wraps per-id gradients (the dedup'd
row-wise dist's) in the segment contract.

``FusedOptimConfig.stochastic_rounding`` switches the bfloat16 write-back:
on, a table rounds stochastically whenever the step hands a seed (the
noise is the kernels' hash, since ``jax.random`` has no torch
counterpart); off, the update passes no seed and each value is rounded
once to nearest, as the Pallas kernel does with the switch off.
:func:`stochastic_round_to_bf16` is the JAX function's contract over a
``torch.Generator``.  Left out: the ``dedup=False`` option of
``apply_sparse_update``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, Optional, Tuple, Union

import torch

from torchrec_tpu_torch.ops.embedding_ops import (
    TRACE_KERNEL_LOCK,
    aggregate_duplicate_rows,
    embedding_row_grads,
)
from torchrec_tpu_torch.ops.tbe_backward import (
    STATE_LAYOUTS,
    dedup_fused_sparse_update,
    fused_sparse_update,
    update_rows,
)

State = Dict[str, Union[torch.Tensor, int]]


@dataclasses.dataclass(frozen=True)
class SparseSegGrad:
    """A sharded group's backward result before row-gradient
    materialization: the per-segment upstream gradient plus the slot
    layout that expands it."""

    ids: torch.Tensor  # [V] table-local row ids
    valid: torch.Tensor  # [V] bool
    segments: torch.Tensor  # [V] grad_seg row each slot pooled into
    weights: Optional[torch.Tensor]  # [V] float32 or None
    grad_seg: torch.Tensor  # [S, D] upstream pooled gradient

    def ok(self) -> torch.Tensor:
        """The slot mask: ``valid`` and a segment in ``[0, S)``."""
        S = self.grad_seg.shape[0]
        return self.valid & (self.segments >= 0) & (self.segments < S)

    def row_grads(self) -> torch.Tensor:
        """The ``[V, D]`` per-slot row gradients (zero on slots outside
        :meth:`ok`), for consumers that move gradients between ranks."""
        S = self.grad_seg.shape[0]
        segs = torch.where(self.segments >= 0, self.segments, S)
        rg = embedding_row_grads(self.grad_seg, segs, self.weights)
        return torch.where(self.ok()[:, None], rg, 0.0)

    @staticmethod
    def from_row_grads(ids: torch.Tensor, valid: torch.Tensor,
                       row_grads: torch.Tensor) -> "SparseSegGrad":
        """Per-id gradients already formed (the dedup'd row-wise dist's,
        summed over a source's duplicates before the wire) in the
        segment contract: slot ``v`` is segment ``v``, unweighted, so
        :meth:`row_grads` is the identity.  Ids may still repeat across
        sources; the fused update sums those."""
        V = ids.shape[0]
        return SparseSegGrad(
            ids, valid, torch.arange(V, dtype=torch.int32, device=ids.device),
            None, row_grads)


class EmbOptimType(enum.Enum):
    """The fused optimizer families, with the JAX package's names."""

    SGD = "sgd"
    LARS_SGD = "lars_sgd"
    ROWWISE_ADAGRAD = "rowwise_adagrad"
    ADAGRAD = "adagrad"
    ADAM = "adam"
    PARTIAL_ROWWISE_ADAM = "partial_rowwise_adam"
    LAMB = "lamb"
    PARTIAL_ROWWISE_LAMB = "partial_rowwise_lamb"


ADAM_FAMILY = (EmbOptimType.ADAM, EmbOptimType.PARTIAL_ROWWISE_ADAM,
               EmbOptimType.LAMB, EmbOptimType.PARTIAL_ROWWISE_LAMB)
# the port's fused update kernels: B2 and B6
FUSED_KERNELS = ("tbe", "dedup")
MOMENTUM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class FusedOptimConfig:
    """Hyperparameters of the fused sparse optimizer: family, lr, eps,
    the Adam/LAMB betas and weight decay (the JAX defaults), the
    optimizer state's dtype (:data:`MOMENTUM_DTYPES`; any other raises)
    and the bfloat16 tables' stochastic-rounding switch."""

    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD
    learning_rate: float = 0.01
    eps: float = 1.0e-8
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    momentum_dtype: torch.dtype = torch.float32
    stochastic_rounding: bool = True

    def __post_init__(self):
        if self.momentum_dtype not in MOMENTUM_DTYPES:
            raise ValueError(f"momentum_dtype must be one of "
                             f"{MOMENTUM_DTYPES}, got {self.momentum_dtype}")


def stochastic_round_to_bf16(x: torch.Tensor,
                             generator: torch.Generator) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: 16 uniform random
    bits from ``generator`` (on ``x``'s device) are added to the 16 bits
    bfloat16 drops before they are cut, so each output is one of the two
    bfloat16 neighbours of ``x`` and its mean over draws is ``x``.
    Non-finite values pass through unchanged.  The JAX function draws
    ``jax.random.bits``; the contract is the same, the bits are not."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic_round_to_bf16 takes float32, got "
                        f"{x.dtype}")
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          device=x.device, dtype=torch.int64)
    u = ((x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
         + noise) & 0xFFFF0000
    sr = torch.where(u > 2**31 - 1, u - 2**32, u).to(torch.int32)
    sr = sr.view(torch.float32)
    return torch.where(torch.isfinite(x), sr, x).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the process-wide sparse-update kernel (the JAX package's switch, its
# names): read when a DMP is built with no update kernel of its own
# ---------------------------------------------------------------------------
UPDATE_KERNELS = ("xla", "pallas", "pallas_dedup")
UPDATE_KERNEL_MAP = {"xla": "tbe", "pallas": "tbe", "pallas_dedup": "dedup"}
_UPDATE_KERNEL: str = os.environ.get("TORCHREC_TPU_SPARSE_UPDATE_KERNEL",
                                     "xla")
_UPDATE_PALLAS_OPTS = {"chunk": 1024, "group": 8, "interpret": False}
_UPDATE_DEDUP_OPTS = {"id_cap": None}


def set_sparse_update_kernel(
    kind: str,
    chunk: int = 1024,
    group: int = 8,
    interpret: bool = False,
    id_cap: Optional[int] = None,
) -> None:
    """Select the sparse-update kernel process-wide by its JAX name
    (:data:`UPDATE_KERNELS`); a DMP built afterwards with no
    ``update_kernel`` takes it.  ``chunk``, ``group``, ``interpret`` and
    ``id_cap`` are kept and do nothing in the port.  Thread-safe
    (``TRACE_KERNEL_LOCK``)."""
    global _UPDATE_KERNEL
    if kind not in UPDATE_KERNELS:
        raise ValueError(f"unknown sparse-update kernel {kind!r}")
    with TRACE_KERNEL_LOCK:
        _UPDATE_KERNEL = kind
        _UPDATE_PALLAS_OPTS.update(chunk=chunk, group=group,
                                   interpret=interpret)
        _UPDATE_DEDUP_OPTS.update(id_cap=id_cap)


def get_sparse_update_kernel() -> str:
    """The process-wide sparse-update kernel (one of
    :data:`UPDATE_KERNELS`)."""
    return _UPDATE_KERNEL


def resolve_update_kernel(update_kernel: Optional[str]) -> str:
    """The port's kernel (:data:`FUSED_KERNELS`) for ``update_kernel``:
    itself when it names one; for None the process-wide selection's,
    through :data:`UPDATE_KERNEL_MAP`.  Nothing maps to a plain version,
    and an explicit kernel takes the port's names only."""
    if update_kernel is None:
        with TRACE_KERNEL_LOCK:
            return UPDATE_KERNEL_MAP[_UPDATE_KERNEL]
    require_kernel(update_kernel)
    return update_kernel


def require_kernel(update_kernel: str) -> None:
    """Raise unless ``update_kernel`` names a fused update kernel of the
    port (both take every optimizer)."""
    if update_kernel not in FUSED_KERNELS:
        raise ValueError(f"unknown sparse-update kernel {update_kernel!r}")


def init_optimizer_state(
    config: FusedOptimConfig,
    num_rows: int,
    dim: int,
    device=None,
) -> State:
    """Per-table optimizer state in the layout of the module docstring,
    zeros of ``config.momentum_dtype`` (and ``step`` 0 for the Adam
    family)."""
    layout = STATE_LAYOUTS[config.optim.value]
    arrays = [
        torch.zeros((num_rows,) if kind == "row" else (num_rows, dim),
                    dtype=config.momentum_dtype, device=device)
        for kind in layout
    ]
    if config.optim in ADAM_FAMILY:
        return {"m": arrays[0], "v": arrays[1], "step": 0}
    return {"momentum": arrays[0]} if arrays else {}


def _states(config: FusedOptimConfig, state: State) -> Tuple[torch.Tensor,
                                                             ...]:
    if config.optim in ADAM_FAMILY:
        return state["m"], state["v"]
    return (state["momentum"],) if "momentum" in state else ()


def bias_corrections(config: FusedOptimConfig, step: int) -> Tuple[float,
                                                                    float]:
    """``(1 - beta1**t, 1 - beta2**t)`` for step ``t``, computed on the
    host in float32 (torch's CPU ``pow``), as the JAX package computes
    them from an f32 step (``fused_update.py:476-483``)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return tuple(
        float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
        for b in (config.beta1, config.beta2)
    )


def _adam_hypers(config: FusedOptimConfig, state: State) -> Tuple[int, Dict]:
    """The Adam family's incremented step and its kernel hyperparameters
    (other optimizers: the step unchanged and neutral corrections)."""
    if config.optim not in ADAM_FAMILY:
        return 0, {}
    step = int(state["step"]) + 1
    return step, {"betas": (config.beta1, config.beta2),
                  "bias_corrections": bias_corrections(config, step)}


def _sr_seed(config: FusedOptimConfig, table: torch.Tensor,
             sr_seed: Optional[int]) -> Optional[int]:
    """The seed the kernels take: ``sr_seed`` for a bfloat16 table with
    stochastic rounding on, else None (round to nearest once)."""
    if table.dtype != torch.bfloat16 or not config.stochastic_rounding:
        return None
    return sr_seed


def apply_sparse_update(
    table: torch.Tensor,
    state: State,
    ids: torch.Tensor,
    valid: torch.Tensor,
    row_grads: torch.Tensor,
    config: FusedOptimConfig,
    sr_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, State]:
    """The JAX package's XLA path: sum the per-slot ``row_grads`` [V, D]
    over duplicate ids (``aggregate_duplicate_rows``, slot order), then
    apply the optimizer once to each touched row, in place
    (``ops/tbe_backward.py::update_rows``, the op order of the JAX
    function).  Negative and out-of-range ids are dropped.  Returns
    ``(table, state)``, the inputs themselves (``step`` advanced for the
    Adam family)."""
    R = table.shape[0]
    rows, grads = aggregate_duplicate_rows(ids, valid & (ids >= 0),
                                           row_grads.to(torch.float32))
    keep = rows < R
    step, hyp = _adam_hypers(config, state)
    update_rows(config.optim.value, table, _states(config, state),
                rows[keep].to(torch.int64), grads[keep],
                config.learning_rate, config.eps, config.weight_decay,
                hyp.get("betas", (config.beta1, config.beta2)),
                hyp.get("bias_corrections", (1.0, 1.0)),
                _sr_seed(config, table, sr_seed))
    if hyp:
        state["step"] = step
    return table, state


def apply_sparse_update_segments(
    table: torch.Tensor,
    state: State,
    sg: SparseSegGrad,
    config: FusedOptimConfig,
    sr_seed: Optional[int] = None,
    update_kernel: str = "tbe",
    learning_rate: Optional[float] = None,
) -> Tuple[torch.Tensor, State]:
    """Apply the fused optimizer to the rows ``sg`` touches, in place,
    through the fused kernel ``update_kernel`` (its plain version on CPU
    tensors); the Adam family's ``step`` advances by one.  ``sr_seed``
    (an int32) rounds a bfloat16 table stochastically; without one it
    rounds to nearest.  ``learning_rate`` overrides the config's for this
    call (a schedule's value: a host float, so the launch waits for
    nothing).  With ``config.stochastic_rounding`` off no seed is passed.
    Returns ``(table, state)``, the inputs themselves."""
    require_kernel(update_kernel)
    lr = config.learning_rate if learning_rate is None else learning_rate
    seed = _sr_seed(config, table, sr_seed)
    step, hyp = _adam_hypers(config, state)
    states = _states(config, state)
    kw = {"eps": config.eps, "weight_decay": config.weight_decay,
          "sr_seed": seed, **hyp}
    if update_kernel == "tbe":
        adam = config.optim in ADAM_FAMILY
        fused_sparse_update(
            table, None if adam else state.get("momentum"), sg.ids,
            sg.valid, sg.segments, sg.weights, sg.grad_seg,
            lr, optim=config.optim.value,
            states=states if adam else None, **kw)
    else:
        dedup_fused_sparse_update(
            table, states, sg.ids, sg.valid, sg.segments, sg.weights,
            sg.grad_seg, config.optim.value, lr, **kw)
    if hyp:
        state["step"] = step
    return table, state
