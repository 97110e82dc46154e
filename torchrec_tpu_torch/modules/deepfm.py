"""DeepFM interaction modules (``torchrec_tpu/modules/deepfm.py``):
``DeepFM``, the deep component, and ``FactorizationMachine``, the
second-order term."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.mlp import MLP


class DeepFM(nn.Module):
    """Each input flattened to ``[B, -1]``, concatenated (``in_features``
    columns in all), then an MLP of ``hidden_layer_sizes`` and
    ``deep_fm_dimension``, every layer ReLU: ``[B, deep_fm_dimension]``."""

    def __init__(self, in_features: int, hidden_layer_sizes: Sequence[int],
                 deep_fm_dimension: int):
        super().__init__()
        self.mlp = MLP(in_features,
                       list(hidden_layer_sizes) + [deep_fm_dimension])

    def forward(self, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
        B = embeddings[0].shape[0]
        return self.mlp(torch.cat([e.reshape(B, -1) for e in embeddings],
                                  dim=-1))


class FactorizationMachine(nn.Module):
    """The FM term of equal-width inputs ``[B, D]``: ``0.5 * sum((sum_f
    v_f)^2 - sum_f v_f^2)``, ``[B, 1]``."""

    def forward(self, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
        B = embeddings[0].shape[0]
        if len({e.shape[-1] for e in embeddings}) != 1:
            raise ValueError("FactorizationMachine needs equal embedding "
                             "dims")
        x = torch.stack([e.reshape(B, -1) for e in embeddings], dim=1)
        sum_sq = torch.square(x.sum(dim=1))
        sq_sum = torch.square(x).sum(dim=1)
        return 0.5 * (sum_sq - sq_sum).sum(dim=1, keepdim=True)
