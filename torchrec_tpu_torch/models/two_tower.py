"""The two-tower retrieval model (``torchrec_tpu/models/two_tower.py``):
``TwoTower``, ``in_batch_negatives_loss`` and ``BruteForceKNN``.

Each tower pools its features through its own ``EmbeddingBagCollection``
(B1 on the card), projects them with an MLP (every layer ReLU, as the
JAX ``MLP``) and L2-normalizes; the in-batch scores are the ``[B, B]``
products of the query and candidate embeddings.  ``BruteForceKNN`` is
the exact top-k over a candidate matrix: one ``[Q, D] x [D, N]`` product
and ``torch.topk`` (the JAX package's matmul and ``lax.top_k``).  Left
out: the int8 candidate tower of the reference's serving path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.mlp import MLP
from torchrec_tpu_torch.sparse import KeyedJaggedTensor


def _in_features(ebc: EmbeddingBagCollection) -> int:
    return sum(c.embedding_dim * len(c.feature_names)
               for c in ebc.embedding_bag_configs())


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-12)


class TwoTower(nn.Module):
    """Query tower and candidate tower -> dot-product scores."""

    def __init__(self, query_ebc: EmbeddingBagCollection,
                 candidate_ebc: EmbeddingBagCollection,
                 layer_sizes: Sequence[int] = (64, 32)):
        super().__init__()
        self.query_ebc = query_ebc
        self.candidate_ebc = candidate_ebc
        self.query_proj = MLP(_in_features(query_ebc), layer_sizes)
        self.candidate_proj = MLP(_in_features(candidate_ebc), layer_sizes)

    def embed_query(self, kjt: KeyedJaggedTensor) -> torch.Tensor:
        """``[B, layer_sizes[-1]]``, rows of unit norm."""
        return _normalize(self.query_proj(self.query_ebc(kjt).values()))

    def embed_candidate(self, kjt: KeyedJaggedTensor) -> torch.Tensor:
        """``[B, layer_sizes[-1]]``, rows of unit norm."""
        return _normalize(
            self.candidate_proj(self.candidate_ebc(kjt).values()))

    def forward(self, query: KeyedJaggedTensor,
                candidate: KeyedJaggedTensor) -> torch.Tensor:
        """In-batch scores ``[B, B]``; the diagonal holds the positives."""
        return self.embed_query(query) @ self.embed_candidate(candidate).T


def in_batch_negatives_loss(scores: torch.Tensor,
                            temperature: float = 0.05) -> torch.Tensor:
    """Sampled softmax over in-batch negatives: the mean negative
    log-probability of each row's diagonal at ``temperature``."""
    logp = torch.log_softmax(scores / temperature, dim=-1)
    return -logp.diagonal().mean()


class BruteForceKNN:
    """Exact top-k retrieval over ``candidate_embeddings`` ``[N, D]``
    (rows L2-normalized by the tower)."""

    def __init__(self, candidate_embeddings: torch.Tensor):
        self.candidates = candidate_embeddings

    def query(self, queries: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores ``[Q, k]``, indices ``[Q, k]``), highest first."""
        scores = queries @ self.candidates.T
        return torch.topk(scores, k, dim=-1)
