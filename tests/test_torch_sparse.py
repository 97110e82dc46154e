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


# ---------------------------------------------------------------------------
# the rest of the KJT/KT surface: each against the JAX KeyedJaggedTensor on
# the same numpy batch (the claims of tests/test_jagged_tensor.py)
# ---------------------------------------------------------------------------

from torchrec_tpu.sparse import KeyedTensor as JKT  # noqa: E402
from torchrec_tpu.sparse import tensor_dict as jtd  # noqa: E402
from torchrec_tpu.sparse import validator as jval  # noqa: E402
from torchrec_tpu_torch.sparse import KeyedTensor as TKT  # noqa: E402
from torchrec_tpu_torch.sparse import tensor_dict as ttd  # noqa: E402
from torchrec_tpu_torch.sparse import validator as tval  # noqa: E402

A1_KEYS = ["a", "b", "c", "d"]


def _a1_batch(seed, weighted=True, vbe=False, caps=None):
    """(JAX KJT, port KJT) from one numpy batch: B = 6, up to 3 ids per
    example, per-key caps; with ``vbe`` keys b and d have reduced batches
    and inverse indices."""
    rng = np.random.RandomState(seed)
    strides = [6, 4, 6, 2] if vbe else [6] * 4
    lengths = np.concatenate([rng.randint(0, 4, size=s)
                              for s in strides]).astype(np.int32)
    values = rng.randint(0, 50, size=int(lengths.sum())).astype(np.int64)
    weights = rng.rand(len(values)).astype(np.float32) if weighted else None
    kw = {}
    if vbe:
        kw = dict(stride_per_key=strides, inverse_indices=np.stack(
            [rng.randint(0, s, size=6) for s in strides]))
    caps = caps or [3 * s + 1 for s in strides]
    return (JKJT.from_lengths_packed(A1_KEYS, values, lengths, weights,
                                     caps=caps, **kw),
            TKJT.from_lengths_packed(A1_KEYS, values, lengths, weights,
                                     caps=caps, **kw))


def _assert_full_equal(j, t):
    """Every buffer and static field, VBE ones included."""
    if not t.variable_stride_per_key:
        _assert_kjt_equal(j, t)
    assert j.keys() == t.keys() and tuple(j.caps) == t.caps
    assert j.stride() == t.stride()
    assert tuple(j.stride_per_key()) == t.stride_per_key()
    assert j.variable_stride_per_key == t.variable_stride_per_key
    for a, b in ((j.values(), t.values()), (j.lengths(), t.lengths()),
                 (j.weights_or_none(), t.weights_or_none()),
                 (j.inverse_indices_or_none(), t.inverse_indices_or_none())):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("vbe", [False, True])
def test_segment_ids_valid_mask_and_lengths_equal(vbe):
    j, t = _a1_batch(0, vbe=vbe)
    assert t.total_stride == j.total_stride
    np.testing.assert_array_equal(np.asarray(j.segment_ids()),
                                  t.segment_ids().numpy())
    np.testing.assert_array_equal(np.asarray(j.valid_mask()),
                                  t.valid_mask().numpy())
    np.testing.assert_array_equal(np.asarray(j.length_per_key()),
                                  t.length_per_key().numpy())
    assert j._length_offsets() == t._length_offsets()
    for f in range(4):
        np.testing.assert_array_equal(np.asarray(j.lengths_for_key(f)),
                                      t.lengths_for_key(f).numpy())


@pytest.mark.parametrize("vbe", [False, True])
@pytest.mark.parametrize("order", [[2, 0, 3, 1], [1, 1, 3], [3], []])
def test_permute_and_select_keys_equal(order, vbe):
    j, t = _a1_batch(1, vbe=vbe)
    if not order:
        assert t.permute(order).keys() == ()
        return
    _assert_full_equal(j.permute(order), t.permute(order))
    names = [A1_KEYS[i] for i in order]
    _assert_full_equal(j.select_keys(names), t.select_keys(names))


@pytest.mark.parametrize("vbe", [False, True])
@pytest.mark.parametrize("segments", [[1, 3], [2, 2], [1, 1, 2], [4]])
def test_split_concat_round_trip_equal(segments, vbe):
    """``split`` then ``concat`` gives the batch back, the inverse indices
    kept; each part equals the JAX part."""
    j, t = _a1_batch(2, vbe=vbe)
    jparts, tparts = j.split(segments), t.split(segments)
    assert len(tparts) == len(segments)
    for a, b in zip(jparts, tparts):
        _assert_full_equal(a, b)
    _assert_full_equal(JKJT.concat(jparts), TKJT.concat(tparts))
    _assert_full_equal(j, TKJT.concat(tparts))


def test_concat_mixed_weights_and_strides_equal():
    """An unweighted part gets weight 1 beside a weighted one, a uniform
    part the identity expansion beside a variable-batch one."""
    ju, tu = _a1_batch(3, weighted=False)
    jv, tv = _a1_batch(4, vbe=True)
    ju, tu = ju.select_keys(["a"]), tu.select_keys(["a"])
    jv, tv = jv.select_keys(["b", "d"]), tv.select_keys(["b", "d"])
    _assert_full_equal(JKJT.concat([ju, jv]), TKJT.concat([tu, tv]))
    assert TKJT.concat([]).keys() == ()


@pytest.mark.parametrize("seed", [5, 6])
def test_pad_strides_equal(seed):
    j, t = _a1_batch(seed, vbe=True)
    jp, tp = j.pad_strides(), t.pad_strides()
    assert not tp.variable_stride_per_key
    _assert_full_equal(jp, tp)
    _, u = _a1_batch(seed)
    assert u.pad_strides() is u


@pytest.mark.parametrize("caps", [None, [19, 7, 30, 2]])
def test_overflow_counts_and_scalar_metrics_equal(caps):
    """Caps under a key's occupancy (a device-side relayout's saturation)
    show as overflow in both packages."""
    j, t = _a1_batch(7, caps=[20, 20, 20, 20])
    if caps is not None:
        # the same buffers under smaller caps, as a shrink leaves them
        j = JKJT(j.keys(), j.values()[: sum(caps)], j.lengths(),
                 stride=j.stride(), caps=caps)
        t = TKJT(t.keys(), t.values()[: sum(caps)], t.lengths(),
                 stride=t.stride(), caps=caps)
    np.testing.assert_array_equal(np.asarray(j.overflow_counts()),
                                  t.overflow_counts().numpy())
    assert j.scalar_metrics("kjt") == t.scalar_metrics("kjt")
    if caps is not None:
        assert t.overflow_counts().sum() > 0


def test_constructors_and_with_values_equal():
    rng = np.random.RandomState(8)
    lengths = rng.randint(0, 3, size=12).astype(np.int32)
    values = rng.randint(0, 9, size=int(lengths.sum()))
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    keys = ["x", "y", "z"]
    _assert_full_equal(JKJT.from_offsets_packed(keys, values, offsets, caps=9),
                       TKJT.from_offsets_packed(keys, values, offsets, caps=9))
    j, t = _a1_batch(9)
    _assert_full_equal(JKJT.from_jt_dict(j.to_dict()),
                       TKJT.from_jt_dict(t.to_dict()))
    _assert_full_equal(JKJT.empty_like(j), TKJT.empty_like(t))
    assert TKJT.empty().keys() == () and TKJT.empty().stride() == 0
    nv = np.arange(t.values().shape[0])
    _assert_full_equal(j.with_values(jnp.asarray(nv)),
                       t.with_values(torch.from_numpy(nv)))


def test_jagged_tensor_accessors_equal():
    j, t = _a1_batch(10)
    for k in A1_KEYS:
        jj, tt = j[k], t[k]
        np.testing.assert_array_equal(np.asarray(jj.offsets()),
                                      tt.offsets().numpy())
        assert int(jj.total()) == int(tt.total())
        np.testing.assert_array_equal(np.asarray(jj.valid_mask()),
                                      tt.valid_mask().numpy())
        for L in (None, 2, 5):
            np.testing.assert_array_equal(
                np.asarray(jj.to_padded_dense(L, padding_value=-1)),
                tt.to_padded_dense(L, padding_value=-1).numpy())


def test_keyed_tensor_regroup_equal():
    rng = np.random.RandomState(11)
    parts = {k: rng.rand(5, d).astype(np.float32)
             for k, d in zip("abcd", (2, 3, 1, 4))}
    j1 = JKT.from_dict({k: jnp.asarray(parts[k]) for k in "ab"})
    t1 = TKT.from_dict({k: torch.from_numpy(parts[k]) for k in "ab"})
    j2 = JKT.from_tensor_list(["c", "d"], [jnp.asarray(parts[k]) for k in "cd"])
    t2 = TKT.from_tensor_list(["c", "d"],
                              [torch.from_numpy(parts[k]) for k in "cd"])
    assert t1.length_per_key() == j1.length_per_key()
    for k in "ab":
        np.testing.assert_array_equal(np.asarray(j1[k]), t1[k].numpy())
        np.testing.assert_array_equal(np.asarray(j1.to_dict()[k]),
                                      t1.to_dict()[k].numpy())
    groups = [["d", "a"], ["c"], ["b", "c", "a"]]
    for a, b in zip(JKT.regroup([j1, j2], groups),
                    TKT.regroup([t1, t2], groups)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jd = JKT.regroup_as_dict([j1, j2], groups, ["p", "q", "r"])
    td = TKT.regroup_as_dict([t1, t2], groups, ["p", "q", "r"])
    assert sorted(jd) == sorted(td) == ["p", "q", "r"]
    for k in td:
        np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy())


def _broken(kind):
    """(JAX KJT, port KJT) that break one invariant."""
    j, t = _a1_batch(12, vbe=kind == "inverse_range")
    if kind == "duplicate_keys":
        return (JKJT(["a", "a", "c", "d"], j.values(), j.lengths(),
                     caps=j.caps),
                TKJT(["a", "a", "c", "d"], t.values(), t.lengths(),
                     caps=t.caps))
    if kind == "negative_length":
        jl, tl = np.asarray(j.lengths()).copy(), t.lengths().clone()
        jl[3] = tl[3] = -1
        return (JKJT(A1_KEYS, j.values(), jnp.asarray(jl), caps=j.caps),
                TKJT(A1_KEYS, t.values(), tl, caps=t.caps))
    if kind == "over_capacity":
        jl, tl = np.asarray(j.lengths()).copy(), t.lengths().clone()
        jl[0] = tl[0] = 100
        return (JKJT(A1_KEYS, j.values(), jnp.asarray(jl), caps=j.caps),
                TKJT(A1_KEYS, t.values(), tl, caps=t.caps))
    if kind == "weights_misaligned":
        return (JKJT(A1_KEYS, j.values(), j.lengths(), j.weights()[:-1],
                     caps=j.caps),
                TKJT(A1_KEYS, t.values(), t.lengths(),
                     t.weights_or_none()[:-1], caps=t.caps))
    # inverse indices past a key's stride
    ji = np.asarray(j.inverse_indices()).copy()
    ti = t.inverse_indices().clone()
    ji[3, 0] = ti[3, 0] = 5
    return (JKJT(A1_KEYS, j.values(), j.lengths(), j.weights(),
                 caps=j.caps, stride_per_key=j.stride_per_key(),
                 inverse_indices=jnp.asarray(ji)),
            TKJT(A1_KEYS, t.values(), t.lengths(), t.weights_or_none(),
                 caps=t.caps, stride_per_key=t.stride_per_key(),
                 inverse_indices=ti))


@pytest.mark.parametrize("kind", ["duplicate_keys", "negative_length",
                                  "over_capacity", "weights_misaligned",
                                  "inverse_range"])
def test_validator_rejections_equal(kind):
    j, t = _broken(kind)
    with pytest.raises(jval.KjtValidationError) as je:
        jval.validate_keyed_jagged_tensor(j)
    with pytest.raises(tval.KjtValidationError) as te:
        tval.validate_keyed_jagged_tensor(t)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("vbe", [False, True])
def test_validator_passes_valid_batches(vbe):
    j, t = _a1_batch(13, vbe=vbe)
    jval.validate_keyed_jagged_tensor(j)
    tval.validate_keyed_jagged_tensor(t)


def test_dict_to_kjt_equal():
    rng = np.random.RandomState(14)
    j, t = _a1_batch(14, weighted=False)
    entries = {
        "u": (rng.randint(0, 9, size=4), np.array([1, 0, 2, 1, 0, 0])),
        "v": (rng.randint(0, 9, size=3), np.array([0, 1, 1, 0, 1, 0]),
              rng.rand(3).astype(np.float32)),
    }
    _assert_full_equal(jtd.dict_to_kjt(entries, caps={"u": 5, "v": 4}),
                       ttd.dict_to_kjt(entries, caps={"u": 5, "v": 4}))
    _assert_full_equal(jtd.dict_to_kjt({"a": j["a"], "c": j["c"]}),
                       ttd.dict_to_kjt({"a": t["a"], "c": t["c"]}))
    assert ttd.maybe_dict_to_kjt(t) is t
    with pytest.raises(ValueError):
        ttd.dict_to_kjt({})
    with pytest.raises(ValueError):
        ttd.dict_to_kjt({"u": entries["u"], "w": (np.arange(2), [1, 1])})
