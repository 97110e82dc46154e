"""Dense blocks: Perceptron / MLP (``torchrec_tpu/modules/mlp.py``).

``dtype`` is the compute dtype, as flax ``Dense(dtype=...)`` has it: the
parameters stay float32, and with ``dtype=torch.bfloat16`` the input,
weight and bias are cast to bfloat16 for the product and the output is
bfloat16.  Left out: custom activations, ``final_activation`` and
``SwishLayerNorm``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Perceptron(nn.Module):
    """One linear layer + ReLU, computed in ``dtype`` (float32 when
    None)."""

    def __init__(self, in_size: int, out_size: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(in_size, out_size, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return torch.relu(self.linear(x))
        # flax casts input, kernel and bias to the compute dtype, takes the
        # product, then adds the bias: two roundings, as here
        y = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        if self.linear.bias is not None:
            y = y + self.linear.bias.to(self.dtype)
        return torch.relu(y)


class MLP(nn.Module):
    """Stack of perceptrons, every layer ReLU (the JAX ``MLP`` with no
    ``final_activation``)."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int],
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        sizes = [in_size, *layer_sizes]
        self.layers = nn.ModuleList(
            Perceptron(a, b, bias=bias, dtype=dtype)
            for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
