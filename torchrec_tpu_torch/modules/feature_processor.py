"""Feature processors: learned per-position weights written into a KJT's
weights (``torchrec_tpu/modules/feature_processor.py``):
``positions_in_bag``, ``PositionWeightedModule`` (one feature),
``PositionWeightedModuleCollection`` and
``FeatureProcessedEmbeddingBagCollection`` (the processors, then a
weighted EBC).

An id's position in its bag is its slot minus its example's first slot,
from the lengths' running sums (the padding slots get positions too; they
pool nothing).  Each position weight is a parameter ``[max_length]``,
ones at the start, indexed by the position clipped to ``max_length -
1`` and multiplied into any weight the KJT already carries.  The pooled
lookup is the weighted SUM of the collection: on the card one B1 launch a
table with the per-slot weights (``csrc/tbe_float.cu``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.sparse import JaggedTensor, KeyedJaggedTensor, KeyedTensor


def positions_in_bag(lengths: torch.Tensor, cap: int) -> torch.Tensor:
    """``[cap]`` int64: each buffer slot's position within its example's
    bag (slots past the last example belong to it, clipped to ``cap -
    1``)."""
    offs = torch.cat([lengths.new_zeros((1,)),
                      torch.cumsum(lengths, 0, dtype=lengths.dtype)])
    pos = torch.arange(cap, device=lengths.device, dtype=offs.dtype)
    b = torch.searchsorted(offs, pos, right=True) - 1
    b = b.clamp(0, max(lengths.shape[0] - 1, 0))
    return (pos - offs[b]).clamp(0, max(cap - 1, 0)).to(torch.int64)


def _position_weights(weight: torch.Tensor, lengths: torch.Tensor,
                      cap: int) -> torch.Tensor:
    pos = positions_in_bag(lengths, cap)
    return weight[pos.clamp(max=weight.shape[0] - 1)]


class PositionWeightedModule(nn.Module):
    """Learned position weights of one feature: JT -> the same JT with
    ``position_weight[position]`` (times its own weights) as weights."""

    def __init__(self, max_feature_length: int):
        super().__init__()
        self.position_weight = nn.Parameter(torch.ones(max_feature_length))

    def forward(self, jt: JaggedTensor) -> JaggedTensor:
        pw = _position_weights(self.position_weight, jt.lengths(),
                               jt.capacity)
        base = jt.weights_or_none()
        if base is not None:
            pw = pw * base
        return JaggedTensor(jt.values(), jt.lengths(), pw)


class PositionWeightedModuleCollection(nn.Module):
    """Position weights of the features in ``max_feature_lengths``
    (``position_weight_<feature>``); the other features keep their
    weights (1 where the KJT has none)."""

    def __init__(self, max_feature_lengths: Mapping[str, int]):
        super().__init__()
        self.max_feature_lengths: Dict[str, int] = dict(max_feature_lengths)
        for key, L in self.max_feature_lengths.items():
            self.register_parameter(f"position_weight_{key}",
                                    nn.Parameter(torch.ones(L)))

    def forward(self, kjt: KeyedJaggedTensor) -> KeyedJaggedTensor:
        offs = kjt.cap_offsets()
        w = kjt.weights_or_none()
        pieces = []
        for f, key in enumerate(kjt.keys()):
            s, e = offs[f], offs[f + 1]
            base = (torch.ones((e - s,), dtype=torch.float32,
                               device=kjt.values().device)
                    if w is None else w[s:e].to(torch.float32))
            if key in self.max_feature_lengths:
                base = base * _position_weights(
                    getattr(self, f"position_weight_{key}"),
                    kjt.lengths_for_key(f), e - s)
            pieces.append(base)
        return kjt.with_values(kjt.values(), torch.cat(pieces))


class FeatureProcessedEmbeddingBagCollection(nn.Module):
    """The position-weighted EBC: the processors write per-id weights,
    then the weighted-SUM pooled lookup of ``embedding_bag_collection``
    (built with ``is_weighted=True``)."""

    def __init__(self, embedding_bag_collection: EmbeddingBagCollection,
                 max_feature_lengths: Mapping[str, int]):
        super().__init__()
        if not embedding_bag_collection.is_weighted:
            raise ValueError("FeatureProcessedEmbeddingBagCollection needs "
                             "EmbeddingBagCollection(is_weighted=True)")
        self.embedding_bag_collection = embedding_bag_collection
        self.position_weights = PositionWeightedModuleCollection(
            max_feature_lengths)

    def forward(self, kjt: KeyedJaggedTensor) -> KeyedTensor:
        return self.embedding_bag_collection(self.position_weights(kjt))
