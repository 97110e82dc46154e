"""Dense blocks: Perceptron / MLP (``torchrec_tpu/modules/mlp.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class Perceptron(nn.Module):
    """One float32 linear layer + ReLU."""

    def __init__(self, in_size: int, out_size: int, bias: bool = True):
        super().__init__()
        self.linear = nn.Linear(in_size, out_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.linear(x))


class MLP(nn.Module):
    """Stack of perceptrons, every layer ReLU (the JAX ``MLP`` with no
    ``final_activation``)."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int],
                 bias: bool = True):
        super().__init__()
        sizes = [in_size, *layer_sizes]
        self.layers = nn.ModuleList(
            Perceptron(a, b, bias=bias) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
