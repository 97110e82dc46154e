"""Learning-rate warmup and decay schedules (``torchrec_tpu/optim/warmup.py``).

A schedule maps a step count to an lr *multiplier*, computed on the host
in float32 with the JAX package's operations in its order (``jnp`` on
float32 values: LINEAR's 1e-8 floor, POLY's square, INVSQRT's square
root, and after the last stage its end value held), so that it gives the
bits of the JAX schedule called on a step.  (Inside a jitted JAX step XLA
may rewrite a division by a stage's length as a product with its
reciprocal and fold constant factors, which moves some values by an
ulp.)  The count is a Python int that both the
train step and the optimizer keep on the host, so evaluating the
schedule waits for nothing on the device, and the value reaches a kernel
as a plain float argument.

One schedule drives both sides of a train step: pass
``warmup_schedule(stages)`` as the DMP's ``sparse_lr_schedule`` (the
fused update's lr is ``float32(schedule(step)) * learning_rate``) and wrap
the dense Adagrad with :func:`warmup_optimizer`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.optim.adagrad import Adagrad

Schedule = Callable[[int], float]
_F32 = np.float32


class WarmupPolicy(str, enum.Enum):
    """LR warmup/decay shapes (reference optim/warmup.py:31)."""

    NONE = "none"
    LINEAR = "linear"
    CONSTANT = "constant"
    POLY = "poly"
    STEP = "step"
    INVSQRT = "invsqrt"


@dataclasses.dataclass(frozen=True)
class WarmupStage:
    """One schedule stage: policy, duration and target multiplier."""

    policy: WarmupPolicy
    max_iters: int = 1
    value: float = 1.0  # target multiplier (LINEAR end / CONSTANT level)
    lr_scale: float = 1.0
    decay_iters: int = -1  # POLY/INVSQRT reference iteration count


def _stage_value(st: WarmupStage, local: np.float32) -> np.float32:
    """The multiplier of one stage at its float32 iteration ``local``."""
    if st.policy == WarmupPolicy.LINEAR:
        frac = local / _F32(max(st.max_iters, 1))
        return np.maximum(_F32(st.value) * frac, _F32(1e-8))
    if st.policy == WarmupPolicy.CONSTANT:
        return _F32(st.value)
    if st.policy == WarmupPolicy.POLY:
        n = _F32(max(st.decay_iters if st.decay_iters > 0 else st.max_iters,
                     1))
        x = _F32(1) - np.minimum(local / n, _F32(1))
        return _F32(st.value) * (x * x)
    if st.policy == WarmupPolicy.INVSQRT:
        n = _F32(max(st.decay_iters if st.decay_iters > 0 else st.max_iters,
                     1))
        return _F32(st.value) * np.sqrt(n / np.maximum(local + _F32(1),
                                                       _F32(1)))
    return _F32(1)  # NONE and STEP


def warmup_schedule(
    stages: Sequence[WarmupStage], base_multiplier: float = 1.0
) -> Schedule:
    """Compose ``stages`` into one schedule: ``count -> multiplier`` (a
    Python float holding a float32 value)."""
    stages = list(stages)
    total = sum(s.max_iters for s in stages)

    def schedule(count: int) -> float:
        c = _F32(count)
        if stages and c >= _F32(total):
            last = stages[-1]
            return float(_stage_value(last, _F32(last.max_iters))
                         * _F32(last.lr_scale))
        start = 0
        for st in stages:
            if _F32(start) <= c < _F32(start + st.max_iters):
                return float(_stage_value(st, c - _F32(start))
                             * _F32(st.lr_scale))
            start += st.max_iters
        return float(_F32(base_multiplier))

    return schedule


@dataclasses.dataclass(frozen=True)
class WarmupOptimizer:
    """``optax.chain(base, optax.scale_by_schedule(schedule))`` over the
    port's :class:`~torchrec_tpu_torch.optim.adagrad.Adagrad`: each
    update ``u = where(t > 0, rsqrt(t + eps), 0) * g``, ``u = u * -lr``,
    ``u = u * schedule(count)``, ``p = p + u``.  The state is the base's
    under ``"base"`` and the schedule's own ``"count"``, from 0, one up
    each update."""

    base: Adagrad
    schedule: Schedule

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"base": self.base.init(params), "count": 0}

    def update(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: Dict[str, Any],
    ) -> None:
        """One step, in place on ``params`` and ``state``."""
        self.base.update(params, grads, state["base"],
                         scale=self.schedule(state["count"]))
        state["count"] += 1


def warmup_optimizer(base: Adagrad,
                     stages: List[WarmupStage]) -> WarmupOptimizer:
    """The dense optimizer ``base`` scaled by ``warmup_schedule(stages)``
    (the JAX package's ``warmup_optimizer``)."""
    return WarmupOptimizer(base, warmup_schedule(stages))
