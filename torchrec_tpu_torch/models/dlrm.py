"""DLRM dense side (``torchrec_tpu/models/dlrm.py``): DenseArch,
InteractionArch, InteractionDCNArch, OverArch,
``DLRM.forward_from_embeddings``, ``DLRM_DCN.forward_from_embeddings`` and
``bce_with_logits_loss``.

``dense_dtype`` is the compute dtype of the hidden layers (parameters stay
float32): with ``torch.bfloat16`` the dense arch and the over arch's
hidden layers run in bfloat16 while the final logit layer runs in float32,
and the interaction concatenates the bfloat16 dense output with the pooled
embeddings in the wider of their dtypes (float32 embeddings give a float32
interaction), as ``jnp.concatenate`` promotes.  The package turns TF32 off
at import, so the card's float32 matmuls round like the CPU's.  The sparse
side is the caller's (``QuantEmbeddingBagCollection`` in serving, the
sharded collection in training), handed in as a KeyedTensor.
``DLRM_DCN``'s cross net computes in float32 whatever ``dense_dtype`` is
(``modules/crossnet.py``).  Left out: ``SparseArch``/``__call__`` with an
in-model collection, DLRM_Projection and DLRMTrain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.crossnet import LowRankCrossNet
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.mlp import MLP
from torchrec_tpu_torch.sparse import KeyedTensor


class DenseArch(nn.Module):
    """Bottom MLP over dense features: [B, in] -> [B, D]."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = MLP(in_features, layer_sizes, dtype=dtype)

    def forward(self, dense_features: torch.Tensor) -> torch.Tensor:
        return self.mlp(dense_features)


class InteractionArch(nn.Module):
    """Pairwise dot interactions: output ``[B, D + F*(F-1)/2]`` with
    ``F = num_sparse_features + 1``, the pairs in ``jnp.tril_indices(F,
    k=-1)`` order (row-major over the strict lower triangle)."""

    def __init__(self, num_sparse_features: int):
        super().__init__()
        F = num_sparse_features + 1
        li, lj = torch.tril_indices(F, F, offset=-1)
        self.register_buffer("li", li, persistent=False)
        self.register_buffer("lj", lj, persistent=False)

    def forward(
        self, dense_features: torch.Tensor, sparse_features: torch.Tensor
    ) -> torch.Tensor:
        dt = torch.promote_types(dense_features.dtype, sparse_features.dtype)
        dense_features = dense_features.to(dt)
        combined = torch.cat(
            [dense_features[:, None, :], sparse_features.to(dt)], dim=1
        )  # [B, F, D]
        inter = torch.bmm(combined, combined.transpose(1, 2))
        flat = inter[:, self.li, self.lj]
        return torch.cat([dense_features, flat], dim=1)


class InteractionDCNArch(nn.Module):
    """DCN-v2 interaction: the dense output and the pooled embeddings
    concatenated to ``[B, (F + 1) * D]`` (in the wider of their dtypes),
    then the cross net."""

    def __init__(self, num_sparse_features: int, crossnet: nn.Module):
        super().__init__()
        self.num_sparse_features = num_sparse_features
        self.crossnet = crossnet

    def forward(
        self, dense_features: torch.Tensor, sparse_features: torch.Tensor
    ) -> torch.Tensor:
        B = dense_features.shape[0]
        dt = torch.promote_types(dense_features.dtype, sparse_features.dtype)
        combined = torch.cat(
            [dense_features[:, None, :].to(dt), sparse_features.to(dt)], dim=1
        ).reshape(B, -1)
        return self.crossnet(combined)


class OverArch(nn.Module):
    """Top MLP -> logit: hidden layers ReLU in ``dtype``, final layer
    linear in float32."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = list(layer_sizes[:-1])
        self.mlp = MLP(in_features, hidden, dtype=dtype) if hidden else None
        self.final = nn.Linear(
            hidden[-1] if hidden else in_features, layer_sizes[-1]
        )

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features if self.mlp is None else self.mlp(features)
        return self.final(x.to(self.final.weight.dtype))


class DLRM(nn.Module):
    """Classic DLRM dense side over the tables' pooled embeddings.

    ``tables`` fixes the sparse feature count and the embedding dim,
    which the dense arch's last layer must equal."""

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        dense_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        num_features = sum(len(c.feature_names) for c in tables)
        d = tables[0].embedding_dim
        if dense_arch_layer_sizes[-1] != d:
            raise ValueError(
                f"dense arch output {dense_arch_layer_sizes[-1]} must match "
                f"the embedding dim {d}"
            )
        F = num_features + 1
        self.dense_arch = DenseArch(dense_in_features, dense_arch_layer_sizes,
                                    dtype=dense_dtype)
        self.inter_arch = InteractionArch(num_features)
        self.over_arch = OverArch(d + F * (F - 1) // 2, over_arch_layer_sizes,
                                  dtype=dense_dtype)

    def forward_from_embeddings(
        self, dense_features: torch.Tensor, sparse_kt: KeyedTensor
    ) -> torch.Tensor:
        """(dense [B, I], pooled embeddings KeyedTensor) -> logits [B, 1]."""
        B = dense_features.shape[0]
        d = sparse_kt.length_per_key()[0]
        embedded_sparse = sparse_kt.values().reshape(B, -1, d)
        embedded_dense = self.dense_arch(dense_features)
        concat = self.inter_arch(embedded_dense, embedded_sparse)
        return self.over_arch(concat)

    forward = forward_from_embeddings


class DLRM_DCN(nn.Module):
    """DLRM with the DCN-v2 low-rank cross interaction: the dense arch,
    ``LowRankCrossNet(dcn_num_layers, dcn_low_rank_dim)`` over the
    ``(F + 1) * D``-wide concat (float32), the over arch.  ``tables`` fix
    the sparse feature count and the embedding dim, which the dense arch's
    last layer must equal."""

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        dcn_num_layers: int,
        dcn_low_rank_dim: int,
        dense_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        num_features = sum(len(c.feature_names) for c in tables)
        d = tables[0].embedding_dim
        if dense_arch_layer_sizes[-1] != d:
            raise ValueError(
                f"dense arch output {dense_arch_layer_sizes[-1]} must match "
                f"the embedding dim {d}"
            )
        width = (num_features + 1) * d
        self.dense_arch = DenseArch(dense_in_features, dense_arch_layer_sizes,
                                    dtype=dense_dtype)
        self.inter_arch = InteractionDCNArch(
            num_features,
            LowRankCrossNet(width, dcn_num_layers, dcn_low_rank_dim))
        self.over_arch = OverArch(width, over_arch_layer_sizes,
                                  dtype=dense_dtype)

    forward_from_embeddings = DLRM.forward_from_embeddings
    forward = forward_from_embeddings


def bce_with_logits_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically stable (weighted-)mean BCE with logits, in the JAX
    package's formula: ``max(x, 0) - x * y + log1p(exp(-|x|))``."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    per = (
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    if weights is None:
        return per.mean()
    w = weights.reshape(-1).to(logits.dtype)
    return (per * w).sum() / torch.clamp_min(w.sum(), 1e-12)
