"""Cross networks for DCN-style feature interaction
(``torchrec_tpu/modules/crossnet.py``): ``CrossNet`` (full rank),
``LowRankCrossNet`` (DCN-v2, the cross of ``DLRM_DCN``), ``VectorCrossNet``
(DCN-v1) and ``LowRankMixtureCrossNet`` (DCN-v2's mixture of experts).

The cross nets compute in float32, as the JAX ones do (they have no
``dtype``): the input is cast to float32 and the products run in full
float32.  The package keeps TF32 off (``torchrec_tpu_torch/__init__.py``),
so on the card ``torch.matmul`` rounds as the CPU's does.  Parameters keep
flax's names and layouts (``w_l [d, r]``, ``v_l [r, d]``, ``b_l [d]``;
the mixture's ``U_l_e``, ``C_l_e``, ``V_l_e``, ``G_l_e``), so
``convert.py`` carries them untransposed; every matrix is drawn
lecun-normal over its ``shape[0]`` (flax's fan-in), every bias zero.
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


def _matrix(rows: int, cols: int) -> nn.Parameter:
    w = torch.empty((rows, cols))
    lecun_normal_(w, rows)  # flax's fan_in is shape[-2]
    return nn.Parameter(w)


class CrossNet(nn.Module):
    """Full-rank DCN: ``x_{l+1} = x0 * (x_l @ w_l.T + b_l) + x_l`` with
    ``w_l [d, d]``."""

    def __init__(self, in_features: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for l in range(num_layers):
            self.register_parameter(f"w_{l}", _matrix(in_features,
                                                      in_features))
            self.register_parameter(
                f"b_{l}", nn.Parameter(torch.zeros((in_features,))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, d] -> [B, d] float32."""
        x = x.to(torch.float32)
        x0 = x
        for l in range(self.num_layers):
            w, b = getattr(self, f"w_{l}"), getattr(self, f"b_{l}")
            x = x0 * (x @ w.T + b) + x
        return x


class VectorCrossNet(nn.Module):
    """DCN-v1: ``x_{l+1} = x0 * (x_l @ w_l) + b_l + x_l`` with ``w_l [d,
    1]``."""

    def __init__(self, in_features: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for l in range(num_layers):
            self.register_parameter(f"w_{l}", _matrix(in_features, 1))
            self.register_parameter(
                f"b_{l}", nn.Parameter(torch.zeros((in_features,))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, d] -> [B, d] float32."""
        x = x.to(torch.float32)
        x0 = x
        for l in range(self.num_layers):
            w, b = getattr(self, f"w_{l}"), getattr(self, f"b_{l}")
            x = x0 * (x @ w) + b + x
        return x


class LowRankMixtureCrossNet(nn.Module):
    """DCN-v2's mixture of low-rank experts: per layer and expert ``e``,
    ``h = act(act(x_l @ V.T) @ C.T)`` and the expert's ``x0 * (h @ U.T)``
    (``U [d, r]``, ``C [r, r]``, ``V [r, d]``); with several experts their
    outputs are mixed by ``softmax(x_l @ G)`` (``G [d, 1]`` an expert);
    ``x_{l+1}`` = the mix + ``x_l``.  ``activation``: ``"relu"`` or
    anything else for tanh, as in the JAX module."""

    def __init__(self, in_features: int, num_layers: int,
                 num_experts: int = 1, low_rank: int = 1,
                 activation: str = "relu"):
        super().__init__()
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.activation = activation
        d, r = in_features, low_rank
        for l in range(num_layers):
            for e in range(num_experts):
                # flax's order of creation: U, C, V, G
                for name, shape in (("U", (d, r)), ("C", (r, r)),
                                    ("V", (r, d)), ("G", (d, 1))):
                    self.register_parameter(f"{name}_{l}_{e}",
                                            _matrix(*shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, d] -> [B, d] float32."""
        act = torch.relu if self.activation == "relu" else torch.tanh
        x = x.to(torch.float32)
        x0 = x
        for l in range(self.num_layers):
            outs, gates = [], []
            for e in range(self.num_experts):
                p = {n: getattr(self, f"{n}_{l}_{e}") for n in "UCVG"}
                h = act(x @ p["V"].T)
                h = act(h @ p["C"].T)
                outs.append(x0 * (h @ p["U"].T))
                gates.append(x @ p["G"])
            if self.num_experts == 1:
                moe = outs[0]
            else:
                g = torch.softmax(torch.cat(gates, dim=-1), dim=-1)
                moe = torch.einsum("bde,be->bd", torch.stack(outs, dim=-1), g)
            x = moe + x
        return x


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
