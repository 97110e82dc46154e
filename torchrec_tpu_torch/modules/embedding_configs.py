"""Embedding table configuration (a subset of
``torchrec_tpu/modules/embedding_configs.py``): plain dataclasses and
enums with the same names and values, so configs and artifact metadata
read the same in both packages.  ``EmbeddingBagConfig.init_fn`` draws
from an explicit ``torch.Generator``; left out: ``weight_init_min/max``
overrides, ``EmbeddingConfig`` and the dtype maps."""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List

import torch


class PoolingType(enum.Enum):
    """How per-id rows combine per example."""

    SUM = "SUM"
    MEAN = "MEAN"
    NONE = "NONE"


class DataType(enum.Enum):
    """Storage type of table weights."""

    FP32 = "FP32"
    FP16 = "FP16"
    BF16 = "BF16"
    INT8 = "INT8"
    INT4 = "INT4"
    INT2 = "INT2"


@dataclasses.dataclass
class EmbeddingBagConfig:
    """One pooled table: rows, dim, name, the features that look it up,
    storage type and pooling."""

    num_embeddings: int
    embedding_dim: int
    name: str = ""
    data_type: DataType = DataType.FP32
    feature_names: List[str] = dataclasses.field(default_factory=list)
    pooling: PoolingType = PoolingType.SUM

    def init_fn(self, generator: torch.Generator) -> torch.Tensor:
        """Initial weights ``[num_embeddings, embedding_dim]`` float32,
        uniform in ``[-sqrt(1 / R), sqrt(1 / R))``, drawn from
        ``generator`` on its device (the JAX package draws the same range
        from a ``jax.random`` key; the numbers differ)."""
        bound = math.sqrt(1.0 / self.num_embeddings)
        out = torch.empty((self.num_embeddings, self.embedding_dim),
                          dtype=torch.float32, device=generator.device)
        return out.uniform_(-bound, bound, generator=generator)


def pooling_type_to_str(p: PoolingType) -> str:
    """PoolingType -> lowercase string."""
    return p.value.lower()
