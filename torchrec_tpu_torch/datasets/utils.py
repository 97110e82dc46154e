"""Batch container (``torchrec_tpu/datasets/utils.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from torchrec_tpu_torch.sparse import KeyedJaggedTensor


@dataclasses.dataclass
class Batch:
    """One batch: dense [B, D], sparse KJT, labels [B] (+ optional
    per-example weights; 0 marks padded examples)."""

    dense_features: torch.Tensor
    sparse_features: KeyedJaggedTensor
    labels: torch.Tensor
    weights: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.sparse_features.stride()

    def to(self, device: Union[str, torch.device]) -> "Batch":
        """The same batch with every tensor on ``device``."""
        return Batch(
            self.dense_features.to(device),
            self.sparse_features.to(device),
            self.labels.to(device),
            None if self.weights is None else self.weights.to(device),
        )
