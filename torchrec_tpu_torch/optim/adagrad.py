"""The dense optimizer of the train step: Adagrad as ``optax.adagrad``
computes it, which ``torch.optim.Adagrad`` does not (that one starts its
accumulator at 0, adds eps after the square root and uses eps 1e-10).

optax's chain is ``scale_by_rss(initial_accumulator_value=0.1,
eps=1e-7)`` then ``scale_by_learning_rate``: per parameter ``p`` with
gradient ``g`` and accumulator ``t``::

    t = g * g + t
    u = where(t > 0, rsqrt(t + eps), 0) * g
    p = p + (-lr) * u

The port updates ``p`` and ``t`` in place; the JAX package returns new
arrays that its jitted step donates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

# optax.adagrad's defaults, the only values the train step uses
INITIAL_ACCUMULATOR_VALUE = 0.1
EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class Adagrad:
    """optax-equivalent Adagrad over a dict of named parameters."""

    learning_rate: float

    def init(
        self, params: Mapping[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """The state: ``sum_of_squares`` per parameter, filled with
        :data:`INITIAL_ACCUMULATOR_VALUE`."""
        return {
            k: torch.full_like(p, INITIAL_ACCUMULATOR_VALUE,
                               memory_format=torch.contiguous_format)
            for k, p in params.items()
        }

    @torch.no_grad()
    def update(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: Mapping[str, torch.Tensor],
    ) -> None:
        """One step, in place on ``params`` and ``state``."""
        for k, p in params.items():
            g = grads[k]
            t = state[k]
            t.copy_(g * g + t)
            u = torch.where(t > 0, torch.rsqrt(t + EPS), 0.0) * g
            p.add_(u * -self.learning_rate)


def adagrad(learning_rate: float) -> Adagrad:
    """``optax.adagrad(learning_rate)`` with optax's defaults."""
    return Adagrad(learning_rate)
