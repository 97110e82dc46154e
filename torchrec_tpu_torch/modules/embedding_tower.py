"""Embedding towers (``torchrec_tpu/modules/embedding_tower.py``): an
embedding module and the interaction module that consumes it, authored
as one unit (``EmbeddingTower``), and a collection of towers each over
its own features (``EmbeddingTowerCollection``).  Placing a tower's
tables on one rank is a sharding plan's business, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from torchrec_tpu_torch.sparse import KeyedJaggedTensor


class EmbeddingTower(nn.Module):
    """``interaction_module(embedding_module(kjt))``."""

    def __init__(self, embedding_module: nn.Module,
                 interaction_module: nn.Module):
        super().__init__()
        self.embedding_module = embedding_module
        self.interaction_module = interaction_module

    def forward(self, features: KeyedJaggedTensor) -> torch.Tensor:
        return self.interaction_module(self.embedding_module(features))


class EmbeddingTowerCollection(nn.Module):
    """Each tower on its features (``tower_features``, in tower order),
    the outputs concatenated along the last dim."""

    def __init__(self, towers: Sequence[EmbeddingTower],
                 tower_features: Sequence[Sequence[str]]):
        super().__init__()
        if len(towers) != len(tower_features):
            raise ValueError(f"{len(towers)} towers but "
                             f"{len(tower_features)} feature groups")
        self.towers = nn.ModuleList(towers)
        self.tower_features = [tuple(f) for f in tower_features]

    def forward(self, features: KeyedJaggedTensor) -> torch.Tensor:
        return torch.cat([t(features.select_keys(list(f)))
                          for t, f in zip(self.towers, self.tower_features)],
                         dim=-1)
