"""Port parity: the sparse layout and the synthetic data stream are
element-equal between ``torchrec_tpu_torch`` and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.datasets.random import RandomRecDataset as JRandom
from torchrec_tpu.parallel.sharding.common import (
    per_slot_segments as j_per_slot_segments,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import regroup_request_major as j_regroup
from torchrec_tpu_torch.datasets.random import RandomRecDataset as TRandom
from torchrec_tpu_torch.parallel.sharding.common import (
    per_slot_segments as t_per_slot_segments,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT
from torchrec_tpu_torch.sparse import regroup_request_major as t_regroup


def _assert_kjt_equal(j, t):
    assert j.keys() == t.keys()
    assert j.stride() == t.stride()
    assert tuple(j.caps) == tuple(t.caps)
    np.testing.assert_array_equal(np.asarray(j.values()), t.values().numpy())
    np.testing.assert_array_equal(np.asarray(j.lengths()),
                                  t.lengths().numpy())
    assert (j.weights_or_none() is None) == (t.weights_or_none() is None)
    if t.weights_or_none() is not None:
        np.testing.assert_array_equal(np.asarray(j.weights_or_none()),
                                      t.weights_or_none().numpy())
    np.testing.assert_array_equal(np.asarray(j.length_per_key()),
                                  t.length_per_key().numpy())
    for k in t.keys():
        jj, tt = j[k], t[k]
        assert jj.capacity == tt.capacity
        np.testing.assert_array_equal(np.asarray(jj.values()),
                                      tt.values().numpy())
        np.testing.assert_array_equal(np.asarray(jj.lengths()),
                                      tt.lengths().numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_from_lengths_packed_equal(seed, weighted):
    rng = np.random.RandomState(seed)
    F, B = 3, 5
    lengths = rng.randint(0, 4, size=(F * B,)).astype(np.int32)
    values = rng.randint(0, 1000, size=(int(lengths.sum()),))
    weights = rng.rand(len(values)).astype(np.float32) if weighted else None
    keys = ["a", "b", "c"]
    for caps in (None, 16, [12, 15, 20]):
        j = JKJT.from_lengths_packed(keys, values, lengths, weights, caps=caps)
        t = TKJT.from_lengths_packed(keys, values, lengths, weights, caps=caps)
        _assert_kjt_equal(j, t)


def test_from_lengths_packed_over_capacity_raises():
    with pytest.raises(ValueError):
        TKJT.from_lengths_packed(["a"], np.arange(5), np.array([3, 2]),
                                 caps=4)


@pytest.mark.parametrize(
    "lengths,cap",
    [([2, 0, 3, 1], 8), ([0, 0, 0], 4), ([4, 4], 8), ([1, 0, 0, 2, 0], 3)],
)
def test_per_slot_segments_equal(lengths, cap):
    lengths = np.asarray(lengths, np.int32)
    a = np.asarray(j_per_slot_segments(jnp.asarray(lengths), cap))
    b = t_per_slot_segments(torch.from_numpy(lengths), cap).numpy()
    np.testing.assert_array_equal(a, b)


def test_per_slot_segments_batched_equal():
    lengths = np.random.RandomState(3).randint(0, 3, size=(4, 6))
    lengths = lengths.astype(np.int32)
    a = np.asarray(j_per_slot_segments(jnp.asarray(lengths), 12))
    b = t_per_slot_segments(torch.from_numpy(lengths), 12).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_regroup_request_major_equal(seed):
    rng = np.random.RandomState(seed)
    n, F = 6, 4
    lengths = rng.randint(0, 4, size=(n, F)).astype(np.int32)
    ids = rng.randint(0, 100, size=(int(lengths.sum()),)).astype(np.int64)
    np.testing.assert_array_equal(j_regroup(ids, lengths),
                                  t_regroup(ids, lengths))
    empty = np.zeros((n, F), np.int32)
    assert t_regroup(np.zeros((0,), np.int64), empty).shape == (0,)


@pytest.mark.parametrize("weighted", [False, True])
def test_random_rec_dataset_stream_equal(weighted):
    kw = dict(keys=["f0", "f1", "f2"], batch_size=8,
              hash_sizes=[100, 50, 7], ids_per_features=[3, 1, 5],
              num_dense=4, manual_seed=11, num_batches=3,
              min_ids_per_features=[0, 1, 2], weighted=weighted)
    jb = list(JRandom(**kw))
    tb = list(TRandom(**kw))
    assert len(jb) == len(tb) == 3
    for j, t in zip(jb, tb):
        _assert_kjt_equal(j.sparse_features, t.sparse_features)
        np.testing.assert_array_equal(np.asarray(j.dense_features),
                                      t.dense_features.numpy())
        np.testing.assert_array_equal(np.asarray(j.labels), t.labels.numpy())
        assert t.batch_size == 8
