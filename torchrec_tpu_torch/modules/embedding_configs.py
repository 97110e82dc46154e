"""Embedding table configuration (``torchrec_tpu/modules/embedding_configs.py``):
plain dataclasses and enums with the same names, fields and values, so
configs and artifact metadata read the same in both packages, and the
maps between ``DataType`` and torch dtypes.  ``init_fn`` draws from an
explicit ``torch.Generator``.  Left out: ``DATA_TYPE_NUM_BITS`` and
``pooling_type_to_pooling_mode`` (the port's lookups take no pooling
mode)."""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional

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


def data_type_to_dtype(data_type: DataType) -> torch.dtype:
    """DataType -> torch dtype; the quantized types map to their storage
    dtype, ``torch.int8`` (sub-byte widths are a packing, not a dtype)."""
    return {
        DataType.FP32: torch.float32,
        DataType.FP16: torch.float16,
        DataType.BF16: torch.bfloat16,
        DataType.INT8: torch.int8,
        DataType.INT4: torch.int8,
        DataType.INT2: torch.int8,
    }[data_type]


def dtype_to_data_type(dtype: torch.dtype) -> DataType:
    """torch dtype -> DataType; ``int8`` and ``uint8`` map to INT8."""
    out = {
        torch.float32: DataType.FP32,
        torch.float16: DataType.FP16,
        torch.bfloat16: DataType.BF16,
        torch.int8: DataType.INT8,
        torch.uint8: DataType.INT8,
    }.get(dtype)
    if out is None:
        raise ValueError(f"no DataType for dtype {dtype}")
    return out


@dataclasses.dataclass
class BaseEmbeddingConfig:
    """The fields every table has: rows, dim, name, storage type, the
    features that look it up, the init range and the static id capacity
    per feature per batch (None: the runtime's default)."""

    num_embeddings: int
    embedding_dim: int
    name: str = ""
    data_type: DataType = DataType.FP32
    feature_names: List[str] = dataclasses.field(default_factory=list)
    weight_init_max: Optional[float] = None
    weight_init_min: Optional[float] = None
    ids_per_feature_capacity: Optional[int] = None

    def get_weight_init_max(self) -> float:
        if self.weight_init_max is not None:
            return self.weight_init_max
        return math.sqrt(1.0 / self.num_embeddings)

    def get_weight_init_min(self) -> float:
        if self.weight_init_min is not None:
            return self.weight_init_min
        return -math.sqrt(1.0 / self.num_embeddings)

    def init_fn(self, generator: torch.Generator) -> torch.Tensor:
        """Initial weights ``[num_embeddings, embedding_dim]`` float32,
        uniform in ``[get_weight_init_min(), get_weight_init_max())``,
        drawn from ``generator`` on its device (the JAX package draws the
        same range from a ``jax.random`` key, so the numbers differ, and
        casts to the storage type; here the caller casts)."""
        lo, hi = self.get_weight_init_min(), self.get_weight_init_max()
        out = torch.empty((self.num_embeddings, self.embedding_dim),
                          dtype=torch.float32, device=generator.device)
        return out.uniform_(lo, hi, generator=generator)


@dataclasses.dataclass
class EmbeddingBagConfig(BaseEmbeddingConfig):
    """Pooled table (``EmbeddingBagCollection``)."""

    pooling: PoolingType = PoolingType.SUM


@dataclasses.dataclass
class EmbeddingConfig(BaseEmbeddingConfig):
    """Sequence table (``EmbeddingCollection``)."""


def pooling_type_to_str(p: PoolingType) -> str:
    """PoolingType -> lowercase string."""
    return p.value.lower()
