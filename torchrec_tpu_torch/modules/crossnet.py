"""Cross networks for DCN-style feature interaction (a subset of
``torchrec_tpu/modules/crossnet.py``): ``LowRankCrossNet``, the DCN-v2
low-rank cross of ``DLRM_DCN``.

The cross net computes in float32, as the JAX one does (it has no
``dtype``): its input is cast to float32 and its products run in full
float32.  The package keeps TF32 off (``torchrec_tpu_torch/__init__.py``),
so on the card ``torch.matmul`` rounds as the CPU's does.  Parameters keep
flax's names and layouts (``w_l [d, r]``, ``v_l [r, d]``, ``b_l [d]``), so
``convert.py`` carries them untransposed.  Left out: ``CrossNet``,
``VectorCrossNet`` and ``LowRankMixtureCrossNet``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax's lecun_normal: a normal truncated to +-2 standard deviations,
# rescaled by this constant so that its variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's ``lecun_normal`` in place: variance ``1 / fan_in``, a normal
    truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class LowRankCrossNet(nn.Module):
    """DCN-v2 low-rank cross: ``x_{l+1} = x0 * ((x_l @ v_l.T) @ w_l.T +
    b_l) + x_l`` for ``l < num_layers``, with ``w_l [d, r]``, ``v_l [r,
    d]``, ``b_l [d]`` (weights lecun-normal, biases zero)."""

    def __init__(self, in_features: int, num_layers: int, low_rank: int = 1):
        super().__init__()
        self.num_layers = num_layers
        for l in range(num_layers):
            w = torch.empty((in_features, low_rank))
            v = torch.empty((low_rank, in_features))
            lecun_normal_(w, in_features)  # flax's fan_in is shape[-2]
            lecun_normal_(v, low_rank)
            self.register_parameter(f"w_{l}", nn.Parameter(w))
            self.register_parameter(f"v_{l}", nn.Parameter(v))
            self.register_parameter(
                f"b_{l}", nn.Parameter(torch.zeros((in_features,))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, d] -> [B, d] float32."""
        x = x.to(torch.float32)
        x0 = x
        for l in range(self.num_layers):
            w = getattr(self, f"w_{l}")
            v = getattr(self, f"v_{l}")
            b = getattr(self, f"b_{l}")
            x = x0 * (((x @ v.T) @ w.T) + b) + x
        return x
