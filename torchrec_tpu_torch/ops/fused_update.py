"""Fused sparse optimizer application, "optimizer in the backward"
(a subset of ``torchrec_tpu/ops/fused_update.py``).

The train step hands each sharded group's segment-level gradient
(:class:`SparseSegGrad`) to :func:`apply_sparse_update_segments`, which
runs one of the fused backward + optimizer kernels of
``ops/tbe_backward.py``: duplicate ids are aggregated and each touched
row's weight and optimizer state are read and written once, in place.
The kernel is an argument, where the JAX package reads a process-wide
switch at trace time (``set_sparse_update_kernel``): ``"tbe"`` is the
per-id kernel (the port of ``pallas_fused_sparse_update``, B2) and
``"dedup"`` the dedup kernel (the port of
``pallas_dedup_fused_sparse_update``, B6), each for all eight optimizers.
The Adam family's bias corrections are those of the incremented step, as
the JAX package computes them for either kernel
(``ops/fused_update.py:475-483``).

State layouts, as in the JAX package:

* sgd, lars_sgd: ``{}``;
* rowwise_adagrad: ``momentum`` ``[R]``; adagrad: ``momentum`` ``[R, D]``;
* adam, lamb: ``m`` and ``v`` ``[R, D]`` and ``step``;
* partial_rowwise_adam, partial_rowwise_lamb: ``m`` ``[R, D]``, ``v``
  ``[R]`` and ``step``.

The states are float32 tensors (the kernels' only momentum dtype) and
``step``, the Adam family's count of applied updates, is a Python int (the
JAX package keeps an int32 array).  :func:`apply_sparse_update` is the
JAX package's XLA path, ``aggregate_duplicate_rows`` + the optimizer
math, and is the dedup kernel's plain version.  Left out:
``SparseSegGrad.row_grads``/``from_row_grads``, ``momentum_dtype``, the
``stochastic_rounding`` switch (a bfloat16 table rounds stochastically
whenever the step hands a seed; the noise is the kernels' hash, since
``jax.random`` has no torch counterpart) and the ``dedup=False`` option
of ``apply_sparse_update``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple, Union

import torch

from torchrec_tpu_torch.ops.embedding_ops import aggregate_duplicate_rows
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
UPDATE_KERNELS = ("tbe", "dedup")


@dataclasses.dataclass(frozen=True)
class FusedOptimConfig:
    """Hyperparameters of the fused sparse optimizer: family, lr, eps,
    the Adam/LAMB betas and weight decay (the JAX defaults)."""

    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD
    learning_rate: float = 0.01
    eps: float = 1.0e-8
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0


def require_kernel(update_kernel: str) -> None:
    """Raise unless ``update_kernel`` names a fused update kernel (both
    take every optimizer)."""
    if update_kernel not in UPDATE_KERNELS:
        raise ValueError(f"unknown sparse-update kernel {update_kernel!r}")


def init_optimizer_state(
    config: FusedOptimConfig,
    num_rows: int,
    dim: int,
    device=None,
) -> State:
    """Per-table optimizer state in the layout of the module docstring,
    float32 zeros (and ``step`` 0 for the Adam family)."""
    layout = STATE_LAYOUTS[config.optim.value]
    arrays = [
        torch.zeros((num_rows,) if kind == "row" else (num_rows, dim),
                    dtype=torch.float32, device=device)
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
                sr_seed if table.dtype == torch.bfloat16 else None)
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
    nothing).  Returns ``(table, state)``, the inputs themselves."""
    require_kernel(update_kernel)
    lr = config.learning_rate if learning_rate is None else learning_rate
    seed = sr_seed if table.dtype == torch.bfloat16 else None
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
