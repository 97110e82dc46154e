"""Fused sparse optimizer application, "optimizer in the backward"
(a subset of ``torchrec_tpu/ops/fused_update.py``).

The train step hands each sharded group's segment-level gradient
(:class:`SparseSegGrad`) to :func:`apply_sparse_update_segments`, which
runs the fused backward + rowwise-Adagrad kernel of
``ops/tbe_backward.py`` (the port of the JAX package's Pallas
``pallas_fused_sparse_update``): duplicate ids are aggregated and each
touched row's weight and momentum are read and written once, in place.

Ported: ``EmbOptimType``, ``FusedOptimConfig``, ``SparseSegGrad`` and, for
rowwise Adagrad only, ``init_optimizer_state`` and
``apply_sparse_update_segments``.  The other seven optimizers raise
``NotImplementedError`` on every device: their kernel is not ported yet,
and there is no XLA-style path to fall back on.  ``FusedOptimConfig`` keeps
only the settings rowwise Adagrad reads: the Adam/LAMB betas, the
momentum dtype (float32 is the kernel's only one) and the
stochastic-rounding switch (bfloat16 tables always round stochastically
when the step hands a seed) come back with the kernels that read them.
Left out: ``SparseSegGrad.row_grads``, ``apply_sparse_update`` (the XLA
scatter path), ``_apply_row_delta`` and ``stochastic_round_to_bf16`` (its
``jax.random`` noise has no torch counterpart; the port rounds with the
kernel's hash noise), the per-call learning-rate override (sparse lr
schedules are not ported) and the process-wide kernel switch
``set_sparse_update_kernel``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import torch

from torchrec_tpu_torch.ops.tbe_backward import fused_sparse_update


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


@dataclasses.dataclass(frozen=True)
class FusedOptimConfig:
    """Hyperparameters of the fused sparse optimizer that rowwise Adagrad
    reads: family, lr, eps and weight decay (the JAX defaults)."""

    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD
    learning_rate: float = 0.01
    eps: float = 1.0e-8
    weight_decay: float = 0.0


def _require_ported(config: FusedOptimConfig) -> None:
    if config.optim != EmbOptimType.ROWWISE_ADAGRAD:
        raise NotImplementedError(
            f"fused optimizer {config.optim.value}: only rowwise_adagrad "
            "has a kernel in the port (ROADMAP B2)"
        )


def init_optimizer_state(
    config: FusedOptimConfig,
    num_rows: int,
    dim: int,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Per-table optimizer state: rowwise Adagrad's ``momentum`` ``[R]``
    float32 zeros.  (``dim`` is kept for the JAX signature.)"""
    _require_ported(config)
    return {"momentum": torch.zeros((num_rows,), dtype=torch.float32,
                                    device=device)}


def apply_sparse_update_segments(
    table: torch.Tensor,
    state: Dict[str, torch.Tensor],
    sg: SparseSegGrad,
    config: FusedOptimConfig,
    sr_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the fused optimizer to the rows ``sg`` touches, in place,
    through the fused kernel (its plain version on CPU tensors).
    ``sr_seed`` (an int32) rounds a bfloat16 table stochastically; without
    one it rounds to nearest.  Returns ``(table, state)``, the inputs
    themselves."""
    _require_ported(config)
    fused_sparse_update(
        table, state["momentum"], sg.ids, sg.valid, sg.segments,
        sg.weights, sg.grad_seg, config.learning_rate, eps=config.eps,
        weight_decay=config.weight_decay,
        sr_seed=sr_seed if table.dtype == torch.bfloat16 else None,
    )
    return table, state
