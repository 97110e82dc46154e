"""The port's MovieLens loader against the JAX package's, as
``tests/test_models_datasets.py::test_movielens_pipe`` holds the JAX one:
the same rows from a ``ratings.csv`` the test writes, and every batch
equal (ids, lengths, labels, the padding weights of a short last
batch)."""

import numpy as np
import pytest

from torchrec_tpu.datasets.movielens import (
    MovieLensIterDataPipe as JPipe,
)
from torchrec_tpu.datasets.movielens import load_ratings_csv as j_load
from torchrec_tpu_torch.datasets.movielens import (
    MovieLensIterDataPipe,
    load_ratings_csv,
)


def _csv(tmp_path, n):
    rows = ["userId,movieId,rating,timestamp"]
    rng = np.random.RandomState(0)
    for i in range(n):
        rows.append(f"{rng.randint(1, 50)},{rng.randint(1, 200)},"
                    f"{rng.choice([1.0, 3.0, 4.5, 5.0])},{1000 + i}")
    path = tmp_path / "ratings.csv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_movielens_pipe(tmp_path):
    path = _csv(tmp_path, 10)
    users, movies, ratings = load_ratings_csv(path)
    assert len(users) == 10
    for a, b in zip((users, movies, ratings), j_load(path)):
        np.testing.assert_array_equal(a, b)
    assert len(load_ratings_csv(path, max_rows=4)[0]) == 4
    ds = MovieLensIterDataPipe(users, movies, ratings, batch_size=4)
    batches = list(ds)
    assert len(batches) == 2
    b = batches[0]
    assert b.sparse_features.keys() == ("userId", "movieId")
    assert set(b.labels.numpy()) <= {0.0, 1.0}


@pytest.mark.parametrize("binarize", [True, False])
def test_movielens_batches_match_jax(tmp_path, binarize):
    data = load_ratings_csv(_csv(tmp_path, 10))
    port = list(MovieLensIterDataPipe(*data, batch_size=4,
                                      binarize=binarize, drop_last=False))
    want = list(JPipe(*data, batch_size=4, binarize=binarize,
                      drop_last=False))
    assert len(port) == len(want) == 3
    for p, w in zip(port, want):
        np.testing.assert_array_equal(p.labels.numpy(),
                                      np.asarray(w.labels))
        np.testing.assert_array_equal(p.dense_features.numpy(),
                                      np.asarray(w.dense_features))
        pk, wk = p.sparse_features, w.sparse_features
        np.testing.assert_array_equal(pk.values().numpy(),
                                      np.asarray(wk.values()))
        np.testing.assert_array_equal(pk.lengths().numpy(),
                                      np.asarray(wk.lengths()))
        assert pk.caps == tuple(wk.caps)
        if w.weights is None:
            assert p.weights is None
        else:
            np.testing.assert_array_equal(p.weights.numpy(),
                                          np.asarray(w.weights))
    assert port[-1].weights is not None  # the short last batch


def test_movielens_rejects_a_foreign_header(tmp_path):
    path = tmp_path / "x.csv"
    path.write_text("a,b,c\n1,2,3\n")
    with pytest.raises(ValueError):
        load_ratings_csv(str(path))
