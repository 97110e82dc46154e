"""The MovieLens loader (``torchrec_tpu/datasets/movielens.py``):
``ratings.csv`` (userId, movieId, rating, timestamp) served as batches of
the two id features with the rating as the label.  Batches are built on
the host, as the JAX loader's are; the caller moves them to its device.
"""

from __future__ import annotations

import csv
from typing import Iterator, Optional

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

DEFAULT_RATINGS_COLUMN_NAMES = ["userId", "movieId", "rating", "timestamp"]


def load_ratings_csv(path: str, max_rows: Optional[int] = None):
    """``ratings.csv`` -> (users [N] int64, movies [N] int64, ratings [N]
    float32), at most ``max_rows`` rows."""
    users, movies, ratings = [], [], []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        if header[:3] != DEFAULT_RATINGS_COLUMN_NAMES[:3]:
            raise ValueError(f"{path}: header {header}")
        for i, row in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            users.append(int(row[0]))
            movies.append(int(row[1]))
            ratings.append(float(row[2]))
    return (np.asarray(users, np.int64), np.asarray(movies, np.int64),
            np.asarray(ratings, np.float32))


class MovieLensIterDataPipe:
    """(user, movie) -> rating batches of ``batch_size``: one id a feature
    an example (keys ``userId``, ``movieId``, caps ``batch_size``), the
    label binarized at ``threshold`` (rating >= threshold -> 1) unless
    ``binarize`` is off, a constant-1 dense column, and, for a short last
    batch (``drop_last=False``), per-example weights 1 on its real rows
    and 0 on the padding."""

    def __init__(self, users: np.ndarray, movies: np.ndarray,
                 ratings: np.ndarray, batch_size: int,
                 binarize: bool = True, threshold: float = 3.5,
                 drop_last: bool = True):
        self.users = users % (1 << 31)
        self.movies = movies % (1 << 31)
        self.labels = ((ratings >= threshold).astype(np.float32) if binarize
                       else ratings.astype(np.float32))
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.keys = ["userId", "movieId"]
        self.caps = [batch_size, batch_size]

    def __len__(self) -> int:
        n = len(self.labels) // self.batch_size
        if not self.drop_last and len(self.labels) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Batch]:
        B = self.batch_size
        for bi in range(len(self)):
            s, e = bi * B, min((bi + 1) * B, len(self.labels))
            n = e - s
            labels = np.zeros((B,), np.float32)
            labels[:n] = self.labels[s:e]
            lengths = np.zeros((2, B), np.int32)
            lengths[:, :n] = 1
            values = np.concatenate([self.users[s:e], self.movies[s:e]])
            kjt = KeyedJaggedTensor.from_lengths_packed(
                self.keys, values, lengths.reshape(-1), caps=self.caps)
            weights = None
            if n < B:
                w = np.zeros((B,), np.float32)
                w[:n] = 1.0
                weights = torch.from_numpy(w)
            yield Batch(torch.ones((B, 1), dtype=torch.float32), kjt,
                        torch.from_numpy(labels), weights)
