"""DLRM with a transformer-encoder interaction
(``torchrec_tpu/models/experimental/transformerdlrm.py``):
``InteractionTransformerArch`` and ``DLRM_Transformer``.

The interaction runs BERT4Rec's ``TransformerBlock`` (flax's attention
arithmetic, ``models/experimental/bert4rec.py``) over the ``[B, F + 1,
D]`` token stack (the dense arch's output first, every token attending),
flattened to ``[B, (F + 1) * D]`` for the over arch.  The rest is the DLRM
skeleton of ``models/dlrm.py``: ``forward(dense, kjt)`` through the
collection, ``forward_from_embeddings(dense, kt)`` for the sharded
runtime, whose collection is built on ``torch.device("meta")``.  The
encoder computes in float32; ``dense_dtype`` sets the dense and over
arches' hidden layers, as for ``DLRM``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from torchrec_tpu_torch.models.dlrm import OverArch, _DLRMBase
from torchrec_tpu_torch.models.experimental.bert4rec import TransformerBlock
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)


class InteractionTransformerArch(nn.Module):
    """dense ``[B, D]`` + sparse ``[B, F, D]`` -> ``[B, (F + 1) * D]``
    through ``ntransformer_layers`` blocks of ``nhead`` heads."""

    def __init__(self, num_sparse_features: int, embedding_dim: int,
                 nhead: int = 8, ntransformer_layers: int = 4):
        super().__init__()
        self.num_sparse_features = num_sparse_features
        self.blocks = nn.ModuleList(
            TransformerBlock(nhead, embedding_dim)
            for _ in range(ntransformer_layers))

    def forward(self, dense_features: torch.Tensor,
                sparse_features: torch.Tensor) -> torch.Tensor:
        if self.num_sparse_features <= 0:
            return dense_features
        B = dense_features.shape[0]
        dt = torch.promote_types(dense_features.dtype, sparse_features.dtype)
        x = torch.cat([dense_features[:, None, :].to(dt),
                       sparse_features.to(dt)], dim=1)
        mask = torch.ones((B, x.shape[1]), dtype=torch.bool,
                          device=x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return x.reshape(B, -1)


class DLRM_Transformer(_DLRMBase):
    """The DLRM skeleton with :class:`InteractionTransformerArch` (the
    embedding dim a multiple of ``nhead``)."""

    def __init__(
        self,
        embedding_bag_collection: EmbeddingBagCollection,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        nhead: int = 8,
        ntransformer_layers: int = 4,
        dense_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(embedding_bag_collection, dense_in_features,
                         dense_arch_layer_sizes, dense_dtype)
        d = self.embedding_dim
        if d % nhead:
            raise ValueError(f"embedding dim {d} must divide into {nhead} "
                             "heads")
        self.inter_arch = InteractionTransformerArch(
            self.num_sparse_features, d, nhead, ntransformer_layers)
        self.over_arch = OverArch((self.num_sparse_features + 1) * d,
                                  over_arch_layer_sizes, dtype=dense_dtype)
