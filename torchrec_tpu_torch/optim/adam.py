"""The dense Adam of the sequence train step: Adam as ``optax.adam``
computes it (``SequenceModelParallel``'s default dense optimizer), which
``torch.optim.Adam`` does not (it folds the bias corrections into the
step size and adds eps to the corrected root in another order).

optax's chain is ``scale_by_adam(b1, b2, eps, eps_root=0)`` then
``scale_by_learning_rate``: per parameter ``p`` with gradient ``g``, first
moment ``mu``, second moment ``nu`` and the step count ``t`` after its
increment::

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    p = p + (-lr) * u

Each ``1 - b**t`` is formed in float32 on the host, as optax forms it
from its int32 count.  The port updates ``p``, ``mu`` and ``nu`` in place;
the JAX package returns new arrays that its jitted step donates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax-equivalent Adam over a dict of named parameters."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """The state: ``mu`` and ``nu`` zeros per parameter and the step
        ``count`` 0 (optax's ``ScaleByAdamState``)."""
        def zeros():
            return {k: torch.zeros_like(p,
                                        memory_format=torch.contiguous_format)
                    for k, p in params.items()}
        return {"mu": zeros(), "nu": zeros(), "count": 0}

    def bias_corrections(self, count: int):
        """``(1 - b1**count, 1 - b2**count)`` in float32."""
        t = np.int32(count)
        return tuple(_f32(np.float32(1) - np.float32(b) ** t)
                     for b in (self.b1, self.b2))

    @torch.no_grad()
    def update(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: Dict[str, Any],
        scale: Optional[float] = None,
    ) -> None:
        """One step, in place on ``params`` and ``state``; ``scale``
        multiplies the update after the learning rate (a schedule's
        value, ``optim/warmup.py``)."""
        state["count"] += 1
        c1, c2 = self.bias_corrections(state["count"])
        a1, a2 = _f32(1 - self.b1), _f32(1 - self.b2)
        for k, p in params.items():
            g = grads[k]
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_(a1 * g + self.b1 * mu)
            nu.copy_(a2 * (g * g) + self.b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = (-self.learning_rate) * u
            if scale is not None:
                u = u * scale
            p.add_(u)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """``optax.adam(learning_rate, b1, b2, eps)``."""
    return Adam(learning_rate, b1, b2, eps)
