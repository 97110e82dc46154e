"""MLPerf DLRM-v2 Criteo-1TB table spec (``torchrec_tpu/datasets/criteo.py``
:25-64): per-feature row counts after the 40M frequency-threshold cap,
the multi-hot lookup counts of the synthetic multi-hot dataset, and the
standard embedding dim."""

from __future__ import annotations

from typing import List, Tuple

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)

CAT_FEATURE_COUNT = 26
DEFAULT_CAT_NAMES = [f"cat_{i}" for i in range(CAT_FEATURE_COUNT)]

MLPERF_DLRM_V2_ROWS: List[int] = [
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36,
]
MLPERF_DLRM_V2_MULTI_HOT: List[int] = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
    27, 10, 3, 1, 1,
]
MLPERF_DLRM_V2_EMBEDDING_DIM = 128


def mlperf_dlrm_v2_tables(
    embedding_dim: int = MLPERF_DLRM_V2_EMBEDDING_DIM,
) -> Tuple[EmbeddingBagConfig, ...]:
    """The 26 MLPerf DLRM-v2 Criteo-1TB embedding table configs."""
    return tuple(
        EmbeddingBagConfig(
            num_embeddings=rows,
            embedding_dim=embedding_dim,
            name=f"t_{name}",
            feature_names=[name],
            pooling=PoolingType.SUM,
        )
        for rows, name in zip(MLPERF_DLRM_V2_ROWS, DEFAULT_CAT_NAMES)
    )
