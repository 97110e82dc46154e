"""Criteo 1TB / Kaggle data (``torchrec_tpu/datasets/criteo.py``): the
MLPerf DLRM-v2 Criteo-1TB table spec (per-feature row counts after the 40M
frequency-threshold cap, the multi-hot lookup counts of the synthetic
multi-hot dataset, the standard embedding dim), the TSV -> npy
preprocessing, and the in-memory loader that serves preprocessed npy
arrays as ready batches.

Format: label, 13 integer dense features, 26 hex categorical ids.  Dense
features are log1p-transformed; categorical ids fold into per-feature id
spaces modulo their hash sizes.  Criteo is one id per feature, so every
feature's capacity is the batch size.  The batches are host tensors, as
the JAX loader's are host-built; the caller moves them to its device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

INT_FEATURE_COUNT = 13
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


class BinaryCriteoUtils:
    """TSV -> npy preprocessing (reference BinaryCriteoUtils :198)."""

    @staticmethod
    def tsv_to_npys(
        tsv_path: str,
        out_dense_path: str,
        out_sparse_path: str,
        out_labels_path: str,
        max_rows: Optional[int] = None,
    ) -> int:
        """Write ``[N, 13]`` int32 dense, ``[N, 26]`` int64 sparse and
        ``[N]`` int32 labels from a TSV file; returns N."""
        dense_rows: List[np.ndarray] = []
        sparse_rows: List[np.ndarray] = []
        labels: List[int] = []
        with open(tsv_path) as f:
            for i, line in enumerate(f):
                if max_rows is not None and i >= max_rows:
                    break
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 1 + INT_FEATURE_COUNT + CAT_FEATURE_COUNT:
                    raise ValueError(f"{tsv_path}:{i + 1}: {len(parts)} "
                                     "fields")
                labels.append(int(parts[0]) if parts[0] else 0)
                dense_rows.append(np.asarray(
                    [int(x) if x else 0 for x in parts[1:14]], np.int32))
                sparse_rows.append(np.asarray(
                    [int(x, 16) if x else 0 for x in parts[14:]], np.int64))
        dense = (np.stack(dense_rows) if dense_rows
                 else np.zeros((0, 13), np.int32))
        sparse = (np.stack(sparse_rows) if sparse_rows
                  else np.zeros((0, 26), np.int64))
        np.save(out_dense_path, dense)
        np.save(out_sparse_path, sparse)
        np.save(out_labels_path, np.asarray(labels, np.int32))
        return len(labels)


class InMemoryBinaryCriteoIterDataPipe:
    """Serve preprocessed npy arrays as ready batches (reference :715).
    ``hashes``: per-feature id-space sizes (raw ids fold in modulo them).
    A partial last batch (``drop_last=False``) is padded to the batch
    size, its fabricated examples weighted 0."""

    def __init__(
        self,
        dense: np.ndarray,  # [N, 13] int or float
        sparse: np.ndarray,  # [N, 26] int64
        labels: np.ndarray,  # [N]
        batch_size: int,
        hashes: Optional[Sequence[int]] = None,
        shuffle_batches: bool = False,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if dense.shape[1] != INT_FEATURE_COUNT or (
                sparse.shape[1] != CAT_FEATURE_COUNT):
            raise ValueError(f"dense {dense.shape} / sparse {sparse.shape}: "
                             f"want {INT_FEATURE_COUNT} / "
                             f"{CAT_FEATURE_COUNT} columns")
        self.dense = np.log1p(np.maximum(dense, 0).astype(np.float32))
        self.hashes = (list(hashes) if hashes
                       else [1 << 31] * CAT_FEATURE_COUNT)
        self.sparse = np.stack(
            [(sparse[:, f] % self.hashes[f]).astype(np.int64)
             for f in range(CAT_FEATURE_COUNT)], axis=1)
        self.labels = labels.astype(np.float32)
        self.batch_size = batch_size
        self.shuffle_batches = shuffle_batches
        self.seed = seed
        self.drop_last = drop_last
        self.keys = list(DEFAULT_CAT_NAMES)
        self.caps = [batch_size] * CAT_FEATURE_COUNT

    def __len__(self) -> int:
        n = len(self.labels) // self.batch_size
        if not self.drop_last and len(self.labels) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Batch]:
        B = self.batch_size
        order = np.arange(len(self))
        if self.shuffle_batches:
            np.random.RandomState(self.seed).shuffle(order)
        for bi in order:
            s, e = bi * B, min((bi + 1) * B, len(self.labels))
            n = e - s
            dense = np.zeros((B, INT_FEATURE_COUNT), np.float32)
            dense[:n] = self.dense[s:e]
            labels = np.zeros((B,), np.float32)
            labels[:n] = self.labels[s:e]
            lengths = np.zeros((CAT_FEATURE_COUNT, B), np.int32)
            lengths[:, :n] = 1
            # key-major packing: feature f's n real ids, front-packed
            kjt = KeyedJaggedTensor.from_lengths_packed(
                self.keys, self.sparse[s:e].T.reshape(-1),
                lengths.reshape(-1), caps=self.caps)
            weights = None
            if n < B:
                w = np.zeros((B,), np.float32)
                w[:n] = 1.0
                weights = torch.from_numpy(w)
            yield Batch(torch.from_numpy(dense), kjt,
                        torch.from_numpy(labels), weights)


def criteo_dataset(
    npy_prefix: str,
    batch_size: int,
    hashes: Optional[Sequence[int]] = None,
    **kwargs,
) -> InMemoryBinaryCriteoIterDataPipe:
    """Load ``{prefix}_dense.npy`` / ``_sparse.npy`` / ``_labels.npy``."""
    return InMemoryBinaryCriteoIterDataPipe(
        np.load(npy_prefix + "_dense.npy"),
        np.load(npy_prefix + "_sparse.npy"),
        np.load(npy_prefix + "_labels.npy"),
        batch_size, hashes=hashes, **kwargs)
