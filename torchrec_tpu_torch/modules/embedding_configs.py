"""Embedding table configuration (the serving subset of
``torchrec_tpu/modules/embedding_configs.py``): plain dataclasses and
enums with the same names and values, so configs and artifact metadata
read the same in both packages."""

from __future__ import annotations

import dataclasses
import enum
from typing import List


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


def pooling_type_to_str(p: PoolingType) -> str:
    """PoolingType -> lowercase string."""
    return p.value.lower()
