"""RandomRecDataset — synthetic rec batches
(``torchrec_tpu/datasets/random.py``).

Draws from ``np.random.RandomState`` in the JAX package's order, so the
same seed gives the identical stream of ids, lengths, dense features and
labels in both packages.  Batches are built on the CPU.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.sparse import KeyedJaggedTensor


def _zipf_pmf(n: int, s: float) -> np.ndarray:
    """``p(k) ~ 1 / k^s`` over ranks ``k = 1..n``, as float64."""
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), float(s))
    return p / p.sum()


class RandomRecDataset:
    """Per-key id streams with fixed caps, dense features and binary
    labels.

    Args: ``keys`` feature names; ``batch_size`` examples per batch;
    ``hash_sizes`` id range per key; ``ids_per_features`` max ids per
    example per key (the static caps are ``ids * batch_size``);
    ``num_dense`` dense feature count; ``manual_seed``; ``num_batches``
    (None = unbounded); ``min_ids_per_features`` per-key length floors;
    ``weighted`` per-id weights.  Lengths and ids are uniform."""

    def __init__(
        self,
        keys: Sequence[str],
        batch_size: int,
        hash_sizes: Sequence[int],
        ids_per_features: Sequence[int],
        num_dense: int = 13,
        manual_seed: int = 0,
        num_batches: Optional[int] = None,
        min_ids_per_features: Optional[Sequence[int]] = None,
        weighted: bool = False,
        zipf_lengths: Optional[float] = None,
        zipf_ids: Optional[float] = None,
    ):
        if not len(keys) == len(hash_sizes) == len(ids_per_features):
            raise ValueError("keys, hash_sizes and ids_per_features differ "
                             "in length")
        self.keys = list(keys)
        self.batch_size = batch_size
        self.hash_sizes = list(hash_sizes)
        self.ids_per_features = list(ids_per_features)
        self.min_ids = (
            list(min_ids_per_features)
            if min_ids_per_features is not None
            else [0] * len(keys)
        )
        self.num_dense = num_dense
        self.num_batches = num_batches
        self.weighted = weighted
        self.manual_seed = manual_seed
        self.caps = [
            max(1, ids * batch_size) for ids in self.ids_per_features
        ]
        self.zipf_lengths = zipf_lengths
        self.zipf_ids = zipf_ids
        self._len_p = None
        if zipf_lengths is not None:
            self._len_p = [
                _zipf_pmf(hi - lo + 1, zipf_lengths)
                for lo, hi in zip(self.min_ids, self.ids_per_features)
            ]
        self._id_p = None
        if zipf_ids is not None:
            perm_rng = np.random.RandomState(manual_seed + 0x5A1F)
            self._id_p = [_zipf_pmf(h, zipf_ids) for h in self.hash_sizes]
            self._id_perm = [perm_rng.permutation(h) for h in self.hash_sizes]

    def __iter__(self) -> Iterator[Batch]:
        # per-iterator RNG: every iterator replays the same sequence
        rng = np.random.RandomState(self.manual_seed)
        n = 0
        while self.num_batches is None or n < self.num_batches:
            yield self._make_batch(rng)
            n += 1

    def _make_batch(self, rng: np.random.RandomState) -> Batch:
        B, F = self.batch_size, len(self.keys)
        lengths = np.empty((F * B,), dtype=np.int32)
        for f in range(F):
            if self._len_p is not None:
                lengths[f * B : (f + 1) * B] = self.min_ids[f] + rng.choice(
                    len(self._len_p[f]), size=(B,), p=self._len_p[f]
                )
            else:
                lengths[f * B : (f + 1) * B] = rng.randint(
                    self.min_ids[f], self.ids_per_features[f] + 1, size=(B,)
                )
        values = np.empty((int(lengths.sum()),), dtype=np.int64)
        pos = 0
        for f in range(F):
            cnt = int(lengths[f * B : (f + 1) * B].sum())
            if self._id_p is not None:
                ranks = rng.choice(
                    self.hash_sizes[f], size=(cnt,), p=self._id_p[f]
                )
                values[pos : pos + cnt] = self._id_perm[f][ranks]
            else:
                values[pos : pos + cnt] = rng.randint(
                    0, self.hash_sizes[f], size=(cnt,)
                )
            pos += cnt
        weights = (
            rng.rand(len(values)).astype(np.float32) if self.weighted else None
        )
        kjt = KeyedJaggedTensor.from_lengths_packed(
            self.keys, values, lengths, weights, caps=self.caps
        )
        dense = torch.from_numpy(rng.rand(B, self.num_dense).astype(np.float32))
        labels = torch.from_numpy(rng.randint(0, 2, size=(B,)).astype(np.float32))
        return Batch(dense, kjt, labels)
