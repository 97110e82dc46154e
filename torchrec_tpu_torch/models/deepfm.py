"""The DeepFM model (``torchrec_tpu/models/deepfm.py``): ``FMSparseArch``,
``FMInteractionArch`` and ``SimpleDeepFMNN``.  A deep MLP over the dense
embedding and the pooled sparse embeddings, beside their
factorization-machine term, concatenated after the dense embedding into
the final logit layer.  ``forward(dense, kjt)`` runs the collection;
``forward_from_embeddings(dense, kt)`` is the dense side, the entry of
the sharded runtime (``parallel/model_parallel.py``), whose collection
is built on ``torch.device("meta")``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.deepfm import DeepFM, FactorizationMachine
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.mlp import MLP
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, KeyedTensor


def _per_feature(kt: KeyedTensor) -> List[torch.Tensor]:
    d = kt.to_dict()
    return [d[k] for k in kt.keys()]


class FMSparseArch(nn.Module):
    """The collection's pooled embeddings as a list of ``[B, D]``, one a
    feature."""

    def __init__(self, embedding_bag_collection: EmbeddingBagCollection):
        super().__init__()
        self.embedding_bag_collection = embedding_bag_collection

    def forward(self, features: KeyedJaggedTensor) -> List[torch.Tensor]:
        return _per_feature(self.embedding_bag_collection(features))


class FMInteractionArch(nn.Module):
    """dense ``[B, D]`` and ``F`` sparse ``[B, D]`` -> ``[B, D +
    deep_fm_dimension + 1]``: the dense embedding, the deep branch (one
    hidden layer) and the FM term."""

    def __init__(self, embedding_dim: int, num_sparse_features: int,
                 hidden_layer_size: int, deep_fm_dimension: int):
        super().__init__()
        self.deep_fm = DeepFM((num_sparse_features + 1) * embedding_dim,
                              [hidden_layer_size], deep_fm_dimension)
        self.fm = FactorizationMachine()

    def forward(self, dense_embedding: torch.Tensor,
                sparse_embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
        inputs = [dense_embedding] + list(sparse_embeddings)
        return torch.cat([dense_embedding, self.deep_fm(inputs),
                          self.fm(inputs)], dim=1)


class SimpleDeepFMNN(nn.Module):
    """The DeepFM network: dense features through an MLP of
    ``(hidden_layer_size, D)``, the interaction, a linear logit layer;
    every table of one width ``D``."""

    def __init__(self, embedding_bag_collection: EmbeddingBagCollection,
                 num_dense_features: int, hidden_layer_size: int,
                 deep_fm_dimension: int):
        super().__init__()
        configs = embedding_bag_collection.embedding_bag_configs()
        dims = {c.embedding_dim for c in configs}
        if len(dims) != 1:
            raise ValueError(f"DeepFM needs one embedding dim, got "
                             f"{sorted(dims)}")
        d = dims.pop()
        num_features = sum(len(c.feature_names) for c in configs)
        self.num_dense_features = num_dense_features
        self.sparse_arch = FMSparseArch(embedding_bag_collection)
        self.dense_embedding = MLP(num_dense_features,
                                   [hidden_layer_size, d])
        self.inter_arch = FMInteractionArch(d, num_features,
                                            hidden_layer_size,
                                            deep_fm_dimension)
        self.over_arch = nn.Linear(d + deep_fm_dimension + 1, 1)

    def forward(self, dense_features: torch.Tensor,
                sparse_features: KeyedJaggedTensor) -> torch.Tensor:
        """(dense [B, I], KJT) -> logits [B, 1]."""
        if dense_features.shape[-1] != self.num_dense_features:
            raise ValueError(f"expected {self.num_dense_features} dense "
                             f"features, got {dense_features.shape[-1]}")
        combined = self.inter_arch(self.dense_embedding(dense_features),
                                   self.sparse_arch(sparse_features))
        return self.over_arch(combined)

    def forward_from_embeddings(self, dense_features: torch.Tensor,
                                sparse_kt: KeyedTensor) -> torch.Tensor:
        """(dense [B, I], pooled embeddings KeyedTensor) -> logits [B, 1]."""
        combined = self.inter_arch(self.dense_embedding(dense_features),
                                   _per_feature(sparse_kt))
        return self.over_arch(combined)
