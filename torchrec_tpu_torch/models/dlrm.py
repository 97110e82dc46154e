"""The DLRM model family (``torchrec_tpu/models/dlrm.py``): SparseArch,
DenseArch, InteractionArch, InteractionDCNArch, InteractionProjectionArch,
OverArch, ``DLRM``, ``DLRM_DCN``, ``DLRM_Projection``, ``DLRMTrain`` and
``bce_with_logits_loss``.

Each model takes its ``embedding_bag_collection`` as the JAX one does and
has two entry points: ``forward(dense, kjt)``, the whole model through
its collection (``SparseArch``), and ``forward_from_embeddings(dense,
kt)``, the dense side given the pooled embeddings, which the sharded
runtime (``parallel/model_parallel.py``) and serving
(``inference/modules.py``) call with their own tables; there the
collection is built on ``torch.device("meta")`` and never allocated.

``dense_dtype`` is the compute dtype of the hidden layers (parameters stay
float32): with ``torch.bfloat16`` the dense arch and the over arch's
hidden layers run in bfloat16 while the final logit layer runs in float32,
and the interaction concatenates the bfloat16 dense output with the pooled
embeddings in the wider of their dtypes (float32 embeddings give a float32
interaction), as ``jnp.concatenate`` promotes.  The package turns TF32 off
at import, so the card's float32 matmuls round like the CPU's.
``DLRM_DCN``'s cross net computes in float32 whatever ``dense_dtype`` is
(``modules/crossnet.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from torchrec_tpu_torch.modules.crossnet import LowRankCrossNet
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.mlp import MLP
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, KeyedTensor

# the state-dict prefix of a model's tables (``DLRM.sparse_arch``)
SPARSE_PREFIX = "sparse_arch."


class SparseArch(nn.Module):
    """The collection's pooled embeddings as ``[B, F, D]`` (every table
    one dim)."""

    def __init__(self, embedding_bag_collection: EmbeddingBagCollection):
        super().__init__()
        self.embedding_bag_collection = embedding_bag_collection

    def forward(self, features: KeyedJaggedTensor) -> torch.Tensor:
        kt = self.embedding_bag_collection(features)
        return _stack_features(kt, features.stride())


def _stack_features(kt: KeyedTensor, B: int) -> torch.Tensor:
    dims = set(kt.length_per_key())
    if len(dims) != 1:
        raise ValueError(f"DLRM needs one embedding dim, got {sorted(dims)}")
    return kt.values().reshape(B, len(kt.keys()), dims.pop())


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


class InteractionProjectionArch(nn.Module):
    """MLP-projected interaction: the ``[B, (F + 1) * D]`` concat through
    two MLPs, reshaped to ``[B, X, D]`` and ``[B, D, Y]``, their product
    flattened to ``X * Y`` columns after the dense output."""

    def __init__(self, num_sparse_features: int,
                 interaction_branch1: nn.Module,
                 interaction_branch2: nn.Module):
        super().__init__()
        self.num_sparse_features = num_sparse_features
        self.interaction_branch1 = interaction_branch1
        self.interaction_branch2 = interaction_branch2

    def forward(
        self, dense_features: torch.Tensor, sparse_features: torch.Tensor
    ) -> torch.Tensor:
        B, D = dense_features.shape
        dt = torch.promote_types(dense_features.dtype, sparse_features.dtype)
        combined = torch.cat(
            [dense_features[:, None, :].to(dt), sparse_features.to(dt)], dim=1
        ).reshape(B, -1)
        a = self.interaction_branch1(combined).reshape(B, -1, D)
        b = self.interaction_branch2(combined).reshape(B, D, -1)
        inter = torch.bmm(a, b).reshape(B, -1)
        dt = torch.promote_types(dense_features.dtype, inter.dtype)
        return torch.cat([dense_features.to(dt), inter.to(dt)], dim=1)


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


class _DLRMBase(nn.Module):
    """The parts every DLRM shares: the sparse arch over the collection,
    the dense arch, an interaction and the over arch."""

    def __init__(self, embedding_bag_collection: EmbeddingBagCollection,
                 dense_in_features: int,
                 dense_arch_layer_sizes: Sequence[int],
                 dense_dtype: Optional[torch.dtype]):
        super().__init__()
        configs = embedding_bag_collection.embedding_bag_configs()
        self.num_sparse_features = sum(len(c.feature_names) for c in configs)
        self.embedding_dim = configs[0].embedding_dim
        if dense_arch_layer_sizes[-1] != self.embedding_dim:
            raise ValueError(
                f"dense arch output {dense_arch_layer_sizes[-1]} must match "
                f"the embedding dim {self.embedding_dim}"
            )
        self.sparse_arch = SparseArch(embedding_bag_collection)
        self.dense_arch = DenseArch(dense_in_features, dense_arch_layer_sizes,
                                    dtype=dense_dtype)

    @property
    def embedding_bag_collection(self) -> EmbeddingBagCollection:
        return self.sparse_arch.embedding_bag_collection

    def forward(
        self, dense_features: torch.Tensor, sparse_features: KeyedJaggedTensor
    ) -> torch.Tensor:
        """(dense [B, I], KJT) -> logits [B, 1] through the collection."""
        embedded_dense = self.dense_arch(dense_features)
        embedded_sparse = self.sparse_arch(sparse_features)
        concat = self.inter_arch(embedded_dense, embedded_sparse)
        return self.over_arch(concat)

    def forward_from_embeddings(
        self, dense_features: torch.Tensor, sparse_kt: KeyedTensor
    ) -> torch.Tensor:
        """(dense [B, I], pooled embeddings KeyedTensor) -> logits [B, 1]:
        the dense side alone (the collection is not called)."""
        embedded_sparse = _stack_features(sparse_kt, dense_features.shape[0])
        embedded_dense = self.dense_arch(dense_features)
        concat = self.inter_arch(embedded_dense, embedded_sparse)
        return self.over_arch(concat)


class DLRM(_DLRMBase):
    """Classic DLRM: the dense arch's output and the pooled embeddings
    through the pairwise-dot interaction, then the over arch.  The dense
    arch's last layer must equal the embedding dim."""

    def __init__(
        self,
        embedding_bag_collection: EmbeddingBagCollection,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        dense_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(embedding_bag_collection, dense_in_features,
                         dense_arch_layer_sizes, dense_dtype)
        F = self.num_sparse_features + 1
        self.inter_arch = InteractionArch(self.num_sparse_features)
        self.over_arch = OverArch(self.embedding_dim + F * (F - 1) // 2,
                                  over_arch_layer_sizes, dtype=dense_dtype)


class DLRM_DCN(_DLRMBase):
    """DLRM with the DCN-v2 low-rank cross interaction: the dense arch,
    ``LowRankCrossNet(dcn_num_layers, dcn_low_rank_dim)`` over the
    ``(F + 1) * D``-wide concat (float32), the over arch."""

    def __init__(
        self,
        embedding_bag_collection: EmbeddingBagCollection,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        dcn_num_layers: int,
        dcn_low_rank_dim: int,
        dense_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(embedding_bag_collection, dense_in_features,
                         dense_arch_layer_sizes, dense_dtype)
        width = (self.num_sparse_features + 1) * self.embedding_dim
        self.inter_arch = InteractionDCNArch(
            self.num_sparse_features,
            LowRankCrossNet(width, dcn_num_layers, dcn_low_rank_dim))
        self.over_arch = OverArch(width, over_arch_layer_sizes,
                                  dtype=dense_dtype)


class DLRM_Projection(_DLRMBase):
    """DLRM with MLP-projected interactions: two MLPs over the ``(F + 1)
    * D`` concat (``interaction_branch{1,2}_layer_sizes``, each last size
    a multiple of D), their ``[B, X, D] x [B, D, Y]`` product after the
    dense output, the over arch."""

    def __init__(
        self,
        embedding_bag_collection: EmbeddingBagCollection,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        interaction_branch1_layer_sizes: Sequence[int],
        interaction_branch2_layer_sizes: Sequence[int],
        dense_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(embedding_bag_collection, dense_in_features,
                         dense_arch_layer_sizes, dense_dtype)
        d = self.embedding_dim
        b1, b2 = interaction_branch1_layer_sizes, interaction_branch2_layer_sizes
        if b1[-1] % d or b2[-1] % d:
            raise ValueError(f"interaction branch outputs {b1[-1]}, {b2[-1]} "
                             f"must be multiples of the embedding dim {d}")
        width = (self.num_sparse_features + 1) * d
        self.inter_arch = InteractionProjectionArch(
            self.num_sparse_features,
            MLP(width, b1, dtype=dense_dtype),
            MLP(width, b2, dtype=dense_dtype))
        self.over_arch = OverArch(d + (b1[-1] // d) * (b2[-1] // d),
                                  over_arch_layer_sizes, dtype=dense_dtype)


def dense_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A DLRM's state dict without its tables (the keys under
    :data:`SPARSE_PREFIX`): what ``DistributedModelParallel`` trains as
    ``state["dense"]`` and an artifact's ``dense.npz`` holds."""
    return {k: v for k, v in model.state_dict().items()
            if not k.startswith(SPARSE_PREFIX)}


def load_dense_state_dict(model: nn.Module,
                          state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a DLRM's dense parameters (:func:`dense_state_dict`'s keys,
    every one of them and no other), leaving its tables as they are."""
    res = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in res.missing_keys if not k.startswith(SPARSE_PREFIX)]
    if missing or res.unexpected_keys:
        raise KeyError(f"dense state dict: missing {missing}, unexpected "
                       f"{res.unexpected_keys}")


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


class DLRMTrain(nn.Module):
    """The train task: ``forward(batch)`` -> ``(loss, (loss.detach(),
    logits.detach(), labels))``, the mean BCE with logits of the model's
    logits ``[B]`` against ``batch.labels``."""

    def __init__(self, dlrm: nn.Module):
        super().__init__()
        self.dlrm = dlrm

    def forward(self, batch) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        logits = self.dlrm(batch.dense_features,
                           batch.sparse_features).reshape(-1)
        loss = bce_with_logits_loss(logits, batch.labels)
        return loss, (loss.detach(), logits.detach(), batch.labels)
