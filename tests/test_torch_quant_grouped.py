"""Port parity for the grouped quantized lookups
(``torchrec_tpu_torch/ops/tbe.py``: ``quant_pooled_lookup_int8_grouped``
and ``dedup_quant_pooled_lookup_grouped``, one launch for every feature of
a served batch) and their sync-free dedup preparation.

* The grouped plain versions equal the per-feature plain versions bit for
  bit (``torch.equal``): the same function, pooled from a cumsum CSR
  instead of a segment sort.
* They agree with the JAX package's ``QuantEmbeddingBagCollection`` (its
  XLA lookups) and with its Pallas kernels run per feature in interpret
  mode within ``rtol = atol = 1e-5``: XLA on the CPU may contract the JAX
  side's ``q * scale + bias`` and ``acc + v * w`` into FMAs, which the port
  rounds as separate operations (as in ``tests/test_torch_tbe.py``).
* The CUDA kernels cannot run here: their walk (ends clipped to the cap,
  the MEAN weight, slot order) and the dedup gather's word-wide unpacking
  are emulated in numpy float32, one rounding per operation, and must
  equal the plain versions bit for bit — what ``chip_smoke.py`` and
  ``tests/test_torch_cuda_kernels.py`` check on the card.

Sizes are small (4 features over 3 tables, D = 16, B = 12): the CPU
comparisons stay bitwise only at sizes where torch's CPU kernels take no
other summation order (ROADMAP C).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.modules.embedding_configs import DataType as JDataType
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JConfig,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops import embedding_ops as jeo
from torchrec_tpu.ops import pallas_tbe as jtbe
from torchrec_tpu.parallel.sharding.common import (
    per_slot_segments as j_per_slot_segments,
)
from torchrec_tpu.quant.embedding_modules import (
    QuantEmbeddingBagCollection as JQEBC,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.ops.embedding_ops import mean_pooling_weights
from torchrec_tpu_torch.parallel.sharding.common import per_slot_segments
from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

RTOL = ATOL = 1e-5
D, B = 16, 12
ROWS = [50, 30, 70]
# the collection's features in table order: t0 serves f0 and f3
TABLE_FEATURES = [["f0", "f3"], ["f1"], ["f2"]]
MAX_LEN = {"f0": 3, "f1": 5, "f2": 2, "f3": 4}
# the batch's keys: another order, and a key no table reads
KJT_KEYS = ["f2", "fx", "f0", "f3", "f1"]
FULL_CAP = "f1"  # its cap is its lengths' sum: no padding
# (kernel, bits): every kernel at every packed width it serves
KERNELS = [("tbe", 8), ("dedup", 8), ("dedup", 4), ("dedup", 2)]
DATA_TYPES = {8: DataType.INT8, 4: DataType.INT4, 2: DataType.INT2}
J_DATA_TYPES = {8: JDataType.INT8, 4: JDataType.INT4, 2: JDataType.INT2}
# pooling per table: all SUM, all MEAN, or MEAN on t0 only
POOLINGS = {"sum": ("SUM", "SUM", "SUM"), "mean": ("MEAN", "MEAN", "MEAN"),
            "mixed": ("MEAN", "SUM", "SUM")}


def _tables(bits, pooling, cls=EmbeddingBagConfig, pool_cls=PoolingType,
            dt=DATA_TYPES):
    return tuple(
        cls(num_embeddings=r, embedding_dim=D, name=f"t{i}",
            feature_names=list(feats), data_type=dt[bits],
            pooling=pool_cls[POOLINGS[pooling][i]])
        for i, (r, feats) in enumerate(zip(ROWS, TABLE_FEATURES))
    )


def _params(bits, seed=0):
    """Random codes, scales and biases per table (numpy)."""
    rng = np.random.RandomState(seed + bits)
    return {
        f"t{i}": {
            "q": rng.randint(0, 256, size=(r, D * bits // 8)).astype(np.uint8),
            "scale": ((rng.rand(r) + 0.5) * 0.01).astype(np.float32),
            "bias": rng.randn(r).astype(np.float32),
        }
        for i, r in enumerate(ROWS)
    }


def _batch(case, seed=0):
    """(values, lengths [K * B] int32, caps) for the keys KJT_KEYS: empty
    examples (example 3 of every key, example 0 of f0), ids partly outside
    [0, R) (clipped), junk ids in every padding slot (never read), and
    FULL_CAP with no padding; "no_valid_ids": every length 0;
    "over_cap": keys f0 and f2 with caps 2 under their lengths' sum (the
    saturation a device-side relayout leaves: a key's first ``cap`` ids
    are pooled, the rest dropped)."""
    rng = np.random.RandomState(seed)
    lengths = np.zeros((len(KJT_KEYS), B), np.int32)
    if case != "no_valid_ids":
        for k, name in enumerate(KJT_KEYS):
            lengths[k] = rng.randint(0, MAX_LEN.get(name, 2) + 1, size=B)
        lengths[:, 3] = 0
        lengths[KJT_KEYS.index("f0"), 0] = 0
    caps = [int(n) + (0 if KJT_KEYS[k] == FULL_CAP else 5)
            for k, n in enumerate(lengths.sum(axis=1))]
    if case == "over_cap":
        for name in ("f0", "f2"):
            k = KJT_KEYS.index(name)
            caps[k] = int(lengths[k].sum()) - 2
    regions = []
    for k, cap in enumerate(caps):
        n = int(lengths[k].sum())
        ids = rng.randint(-3, max(ROWS) + 4, size=n)
        junk = rng.randint(-10**6, 10**6, size=max(cap - n, 0))
        regions.append(np.concatenate([ids, junk])[:cap])
    values = np.concatenate(regions).astype(np.int64)
    return values, lengths.reshape(-1), caps


def _offsets(caps):
    return tuple(int(x) for x in np.concatenate([[0], np.cumsum(caps)]))


def _features(params, pooling):
    """The group in the collection's order: (table, feature, column, MEAN)
    per feature, as GroupFeatures over torch tensors."""
    feats, col = [], 0
    for i, names in enumerate(TABLE_FEATURES):
        p = {k: torch.from_numpy(v) for k, v in params[f"t{i}"].items()}
        for f in names:
            feats.append(tbe.GroupFeature(
                p["q"], p["scale"], p["bias"], KJT_KEYS.index(f), col,
                POOLINGS[pooling][i] == "MEAN"))
            col += D
    return feats


def _grouped(kernel, bits, values, lengths, caps, feats):
    out = torch.full((B, D * len(feats)), float("nan"))
    args = (torch.from_numpy(values), torch.from_numpy(lengths),
            _offsets(caps), feats, out)
    if kernel == "tbe":
        return tbe.quant_pooled_lookup_int8_grouped(*args)
    return tbe.dedup_quant_pooled_lookup_grouped(*args, bits=bits)


def _per_feature_plain(kernel, bits, values, lengths, caps, f):
    """One feature through the per-feature plain version, as the
    collection called it before grouping."""
    offs = _offsets(caps)
    ids = torch.from_numpy(values[offs[f.key]:offs[f.key + 1]])
    f_len = torch.from_numpy(lengths[f.key * B:(f.key + 1) * B])
    seg = per_slot_segments(f_len, caps[f.key])
    w = mean_pooling_weights(seg, f_len) if f.mean else None
    if kernel == "tbe":
        return tbe.quant_pooled_lookup_int8_plain(f.q, f.scale, f.bias, ids,
                                                  seg, B, w)
    return tbe.dedup_quant_pooled_lookup_plain(f.q, f.scale, f.bias, ids, seg,
                                               B, w, bits)


@pytest.mark.parametrize("case", ["mixed", "no_valid_ids", "over_cap"])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("kernel,bits", KERNELS)
def test_grouped_plain_equals_per_feature_plain(kernel, bits, pooling, case):
    values, lengths, caps = _batch(case, seed=bits)
    feats = _features(_params(bits), pooling)
    out = _grouped(kernel, bits, values, lengths, caps, feats)
    for f in feats:
        ref = _per_feature_plain(kernel, bits, values, lengths, caps, f)
        assert torch.equal(out[:, f.col:f.col + D], ref), f
    if case == "no_valid_ids":
        assert not out.any()
    else:
        assert not out[3].any() and out.abs().sum() > 0
    # the overflow the batch carries, as both packages count it
    t_over = KeyedJaggedTensor(KJT_KEYS, torch.from_numpy(values),
                               torch.from_numpy(lengths), stride=B,
                               caps=caps).overflow_counts()
    j_over = JKJT(KJT_KEYS, jnp.asarray(values), jnp.asarray(lengths),
                  stride=B, caps=caps).overflow_counts()
    np.testing.assert_array_equal(t_over.numpy(), np.asarray(j_over))
    want = [2 if case == "over_cap" and k in ("f0", "f2") else 0
            for k in KJT_KEYS]
    assert t_over.tolist() == want


@pytest.mark.parametrize("pooling", ["sum", "mixed"])
@pytest.mark.parametrize("kernel,bits", KERNELS)
def test_collection_matches_jax_collection(kernel, bits, pooling):
    """The port's collection (one grouped lookup) against the JAX
    package's (its XLA lookups, one per feature) on the same batch."""
    values, lengths, caps = _batch("mixed", seed=10 + bits)
    params = _params(bits)
    tparams = {t: {k: torch.from_numpy(v) for k, v in p.items()}
               for t, p in params.items()}
    qebc = QuantEmbeddingBagCollection(_tables(bits, pooling), tparams,
                                       lookup_kernel=kernel)
    kjt = KeyedJaggedTensor(KJT_KEYS, torch.from_numpy(values),
                            torch.from_numpy(lengths), stride=B, caps=caps)
    got = qebc(kjt)
    jqebc = JQEBC(
        _tables(bits, pooling, JConfig, JPooling, J_DATA_TYPES),
        {t: {k: jnp.asarray(v) for k, v in p.items()}
         for t, p in params.items()})
    jkjt = JKJT(KJT_KEYS, jnp.asarray(values), jnp.asarray(lengths),
                stride=B, caps=caps)
    want = jqebc(jkjt)
    assert got.keys() == tuple(want.keys())
    np.testing.assert_allclose(got.values().numpy(),
                               np.asarray(want.values()), rtol=RTOL,
                               atol=ATOL)


_pallas_q8 = jax.jit(functools.partial(
    jtbe.pallas_quantized_pooled_lookup, num_segments=B, chunk=32, group=8,
    interpret=True))
_pallas_dedup = {
    bits: jax.jit(functools.partial(
        jtbe.pallas_ragged_dedup_quantized_lookup, num_segments=B, bits=bits,
        chunk=32, group=8, interpret=True))
    for bits in (8, 4, 2)
}


@pytest.mark.parametrize("kernel,bits", KERNELS)
def test_grouped_plain_matches_pallas_per_feature(kernel, bits):
    """Each feature's columns of the grouped lookup against the Pallas
    kernel it replaces, run on that feature alone (interpret mode); every
    feature's slots padded to one length with invalid segments, so each
    kernel compiles once."""
    values, lengths, caps = _batch("mixed", seed=20 + bits)
    feats = _features(_params(bits), "mixed")
    out = _grouped(kernel, bits, values, lengths, caps, feats).numpy()
    offs, V = _offsets(caps), max(caps)
    for f in feats:
        cap = caps[f.key]
        f_len = jnp.asarray(lengths[f.key * B:(f.key + 1) * B])
        seg = j_per_slot_segments(f_len, cap)
        w = (jeo.mean_pooling_weights(seg, f_len) if f.mean
             else jnp.ones((cap,), jnp.float32))
        ids = jnp.asarray(np.pad(values[offs[f.key]:offs[f.key + 1]],
                                 (0, V - cap)).astype(np.int32))
        seg = jnp.pad(seg, (0, V - cap), constant_values=B)
        w = jnp.pad(w, (0, V - cap))
        tables = (jnp.asarray(f.q.numpy()), jnp.asarray(f.scale.numpy()),
                  jnp.asarray(f.bias.numpy()))
        if kernel == "tbe":
            want = _pallas_q8(*tables, ids, seg, weights=w)
        else:
            want = _pallas_dedup[bits](*tables, ids, seg, weights=w)
        np.testing.assert_allclose(out[:, f.col:f.col + D], np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=str(f.key))


def test_collection_groups_by_type_kernel_and_width():
    """An int8 table, an int4 table and an int8 table of another width:
    three groups, written into one [B, sum D] buffer in table order, each
    feature equal to its per-feature plain lookup."""
    values, lengths, caps = _batch("mixed", seed=3)
    rng = np.random.RandomState(4)
    specs = [("t0", 8, 16, ["f0", "f3"]), ("t1", 4, 16, ["f1"]),
             ("t2", 8, 8, ["f2"])]
    tables, params = [], {}
    for (name, bits, dim, feats), rows in zip(specs, ROWS):
        tables.append(EmbeddingBagConfig(
            num_embeddings=rows, embedding_dim=dim, name=name,
            feature_names=feats, data_type=DATA_TYPES[bits],
            pooling=PoolingType.MEAN if name == "t2" else PoolingType.SUM))
        params[name] = {
            "q": torch.from_numpy(rng.randint(
                0, 256, size=(rows, dim * bits // 8)).astype(np.uint8)),
            "scale": torch.from_numpy(rng.rand(rows).astype(np.float32)),
            "bias": torch.from_numpy(rng.randn(rows).astype(np.float32))}
    qebc = QuantEmbeddingBagCollection(tables, params)
    assert [(dt, k, len(m)) for dt, k, m in qebc._groups] == [
        (DataType.INT8, "tbe", 2), (DataType.INT4, "dedup", 1),
        (DataType.INT8, "tbe", 1)]
    kjt = KeyedJaggedTensor(KJT_KEYS, torch.from_numpy(values),
                            torch.from_numpy(lengths), stride=B, caps=caps)
    kt = qebc(kjt)
    assert kt.keys() == ("f0", "f3", "f1", "f2")
    assert kt.length_per_key() == (16, 16, 16, 8)
    cols = kt.offset_per_key()
    for i, (f, (name, bits, _, _)) in enumerate(zip(
            kt.keys(), [specs[0], specs[0], specs[1], specs[2]])):
        p = params[name]
        feat = tbe.GroupFeature(p["q"], p["scale"], p["bias"],
                                KJT_KEYS.index(f), cols[i], name == "t2")
        kernel = "tbe" if bits == 8 else "dedup"
        ref = _per_feature_plain(kernel, bits, values, lengths, caps, feat)
        assert torch.equal(kt.values()[:, cols[i]:cols[i + 1]], ref), f


def test_collection_raises_on_a_missing_feature():
    values, lengths, caps = _batch("mixed")
    tparams = {t: {k: torch.from_numpy(v) for k, v in p.items()}
               for t, p in _params(8).items()}
    qebc = QuantEmbeddingBagCollection(_tables(8, "sum"), tparams)
    kjt = KeyedJaggedTensor(["f0", "f1", "f2"],
                            torch.zeros(6, dtype=torch.int64),
                            torch.zeros(3 * B, dtype=torch.int32), stride=B)
    with pytest.raises(KeyError, match="f3"):
        qebc(kjt)


# ---------------------------------------------------------------------------
# the sync-free dedup preparation
# ---------------------------------------------------------------------------

S, R, V = 9, 40, 60
# name -> (id range, segment range)
PREP_CASES = {
    "uniform": ((0, R), (0, S)),
    "duplicate_heavy": ((0, 5), (0, S)),
    "ids_out_of_range": ((-7, R + 9), (0, S)),
    "bad_segments": ((0, R), (-3, S + 3)),
    "no_valid_slots": ((0, R), (S, S + 4)),
    "empty": None,
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_sized_prep_equals_dedup_prepare(case):
    """``dedup_prepare_sized`` (one sort, boundary flags, cumsum; U on the
    device) gives ``dedup_prepare``'s unique rows, per-slot unique index,
    sorted weights, offsets and U (masks and ``torch.unique``)."""
    rng = np.random.RandomState(len(case))
    if PREP_CASES[case] is None:
        ids = segs = torch.zeros((0,), dtype=torch.int64)
    else:
        (ilo, ihi), (slo, shi) = PREP_CASES[case]
        ids = torch.from_numpy(rng.randint(ilo, ihi, size=V))
        segs = torch.from_numpy(rng.randint(slo, shi, size=V))
    w = torch.from_numpy(rng.rand(ids.shape[0]).astype(np.float32))
    uids, suidx, sw, offsets = tbe.dedup_prepare(ids, segs, w, S, R)
    ukeys, inv, sw2, offsets2 = tbe.dedup_prepare_sized(ids, segs, w, S)
    U = tbe.num_unique(ukeys)
    assert U.dim() == 0 and int(U) == uids.numel()
    assert ukeys.shape == inv.shape == ids.shape  # static sizes
    assert torch.equal(tbe.key_rows(ukeys[:int(U)], R), uids)
    assert bool((ukeys[int(U):] == tbe.SENTINEL).all())
    n = int(offsets[-1])
    assert torch.equal(inv[:n], suidx)
    assert torch.equal(sw2[:n], sw)
    assert torch.equal(offsets2, offsets)


def test_grouped_keys_with_no_valid_ids():
    """A batch with no valid id: every key is the sentinel, U = 0."""
    values, lengths, caps = _batch("no_valid_ids")
    feats = _features(_params(8), "sum")
    keys = tbe.group_keys_plain(torch.from_numpy(values),
                                torch.from_numpy(lengths), _offsets(caps),
                                feats, B)
    assert bool((keys == tbe.SENTINEL).all())
    ukeys, inv = tbe.sized_unique(keys)
    assert int(tbe.num_unique(ukeys)) == 0 and not inv.any()


def test_grouped_keys_are_per_feature():
    """The unique is over (feature, id): features sharing a table keep
    their own distinct rows, as the per-feature calls of the reference do;
    the keys of the key no feature reads and of padding are sentinels."""
    values, lengths, caps = _batch("mixed", seed=5)
    feats = _features(_params(8), "sum")
    offs = _offsets(caps)
    keys = tbe.group_keys_plain(torch.from_numpy(values),
                                torch.from_numpy(lengths), offs, feats, B)
    ends = lengths.reshape(len(KJT_KEYS), B).sum(axis=1)
    for i, f in enumerate(feats):
        lo = offs[f.key]
        n = int(ends[f.key])
        mine = keys[lo:lo + n]
        assert torch.equal(mine >> 32, torch.full((n,), i))
        assert torch.equal(tbe.key_rows(mine, ROWS[0] * 10),
                           torch.from_numpy(values[lo:lo + n]).clamp(0))
        assert bool((keys[lo + n:offs[f.key + 1]] == tbe.SENTINEL).all())
    fx = KJT_KEYS.index("fx")
    assert bool((keys[offs[fx]:offs[fx + 1]] == tbe.SENTINEL).all())


# ---------------------------------------------------------------------------
# numpy emulations of the CUDA kernels
# ---------------------------------------------------------------------------


def _dequant_np(codes, s, b):
    return codes.astype(np.float32) * np.float32(s) + np.float32(b)


def _walk_np(values, lengths, caps, feats, slot_row):
    """The grouped kernels' walk: one owner per (feature, example),
    segment ``[min(ends[b-1], cap), min(ends[b], cap))`` of the region,
    weight 1 or float32(1) / float32(len), ``acc = acc + v * w`` in slot
    order."""
    offs = _offsets(caps)
    ends = np.cumsum(lengths.reshape(len(KJT_KEYS), B), axis=1)
    out = np.zeros((B, D * len(feats)), np.float32)
    for i, f in enumerate(feats):
        cap = caps[f.key]
        for b in range(B):
            hi = int(ends[f.key, b])
            lo = int(ends[f.key, b - 1]) if b else 0
            w = np.float32(1)
            if f.mean:
                w = np.float32(1) / np.float32(hi - lo) if hi > lo else \
                    np.float32(0)
            acc = np.zeros((D,), np.float32)
            for p in range(min(lo, cap), min(max(hi, lo), cap)):
                acc = acc + slot_row(i, f, offs[f.key] + p) * w
            out[b, f.col:f.col + D] = acc
    return out


def _gather_np(q, s, b, r, bits):
    """The dedup gather for one row: one 4-byte little-endian word per
    thread, code e of a word = bits [e * bits, (e + 1) * bits)."""
    words = q[r].view("<u4")
    per = 32 // bits
    codes = np.stack([(words >> np.uint32(e * bits)) & np.uint32(
        (1 << bits) - 1) for e in range(per)], axis=1).reshape(-1)
    return _dequant_np(codes, s[r], b[r])


@pytest.mark.parametrize("pooling", ["sum", "mixed"])
@pytest.mark.parametrize("kernel,bits", KERNELS)
def test_grouped_kernel_emulation_bit_equal(kernel, bits, pooling):
    values, lengths, caps = _batch("mixed", seed=30 + bits)
    feats = _features(_params(bits), pooling)
    np_tables = [(f.q.numpy(), f.scale.numpy(), f.bias.numpy())
                 for f in feats]
    if kernel == "tbe":
        def slot_row(i, f, pos):
            q, s, b = np_tables[i]
            r = min(max(int(values[pos]), 0), q.shape[0] - 1)
            return _dequant_np(q[r], s[r], b[r])
    else:
        # the keys kernel, then a sort-unique, then the word-wide gather
        keys = tbe.group_keys_plain(torch.from_numpy(values),
                                    torch.from_numpy(lengths),
                                    _offsets(caps), feats, B).numpy()
        ukeys, inv = np.unique(keys, return_inverse=True)
        rows = {}
        for u, key in enumerate(ukeys):
            if key == tbe.SENTINEL:
                continue
            i = int(key >> 32)
            q, s, b = np_tables[i]
            r = min(max(int(key & 0xFFFFFFFF) - 2**31, 0), q.shape[0] - 1)
            rows[u] = _gather_np(q, s, b, r, bits)

        def slot_row(i, f, pos):
            return rows[int(inv[pos])]

    emu = _walk_np(values, lengths, caps, feats, slot_row)
    got = _grouped(kernel, bits, values, lengths, caps, feats).numpy()
    np.testing.assert_array_equal(emu, got)


# ---------------------------------------------------------------------------
# dispatch and checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,bits", KERNELS)
def test_grouped_cpu_tensors_launch_nothing(kernel, bits):
    values, lengths, caps = _batch("mixed")
    feats = _features(_params(bits), "mixed")
    tbe.reset_launch_counts()
    _grouped(kernel, bits, values, lengths, caps, feats)
    assert not any(tbe.launch_counts().values())


@pytest.mark.parametrize("kernel,bits", KERNELS)
def test_grouped_empty_batch_writes_nothing(kernel, bits):
    """B = 0: an empty [0, sum D] output and no work."""
    feats = _features(_params(bits), "sum")
    out = torch.empty((0, D * len(feats)))
    values = torch.zeros((len(KJT_KEYS) * 2,), dtype=torch.int64)
    lengths = torch.zeros((0,), dtype=torch.int32)
    offs = tuple(range(0, 2 * len(KJT_KEYS) + 1, 2))
    fn = (tbe.quant_pooled_lookup_int8_grouped if kernel == "tbe" else
          functools.partial(tbe.dedup_quant_pooled_lookup_grouped,
                            bits=bits))
    assert fn(values, lengths, offs, feats, out) is out


def test_grouped_non_cpu_tensors_never_take_the_plain_version():
    meta = torch.device("meta")
    q = torch.empty((10, 16), dtype=torch.uint8, device=meta)
    f = torch.empty((10,), dtype=torch.float32, device=meta)
    feats = [tbe.GroupFeature(q, f, f, 0, 0)]
    values = torch.empty((4,), dtype=torch.int64, device=meta)
    lengths = torch.empty((2,), dtype=torch.int32, device=meta)
    out = torch.empty((2, 16), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        tbe.quant_pooled_lookup_int8_grouped(values, lengths, (0, 4), feats,
                                             out)
    with pytest.raises(ValueError, match="CUDA"):
        tbe.dedup_quant_pooled_lookup_grouped(values, lengths, (0, 4), feats,
                                              out, bits=8)


def test_grouped_input_checks():
    q = torch.zeros((10, 16), dtype=torch.uint8)
    s = torch.ones((10,))
    values = torch.zeros((4,), dtype=torch.int64)
    lengths = torch.zeros((2,), dtype=torch.int32)
    out = torch.zeros((2, 32))
    ok = tbe.GroupFeature(q, s, s, 0, 0)
    fn = tbe.quant_pooled_lookup_int8_grouped
    fn(values, lengths, (0, 4), [ok], out)
    with pytest.raises(ValueError):  # no features
        fn(values, lengths, (0, 4), [], out)
    with pytest.raises(ValueError):  # more than one launch takes
        fn(values, lengths, (0, 4), [ok] * (tbe.MAX_GROUP_FEATURES + 1), out)
    with pytest.raises(ValueError):  # regions do not cover values
        fn(values, lengths, (0, 3), [ok], out)
    with pytest.raises(ValueError):  # lengths are not [K * B]
        fn(values, lengths[:1], (0, 4), [ok], out)
    with pytest.raises(ValueError):  # columns past the output
        fn(values, lengths, (0, 4), [ok._replace(col=20)], out)
    with pytest.raises(ValueError):  # a key the batch does not have
        fn(values, lengths, (0, 4), [ok._replace(key=1)], out)
    with pytest.raises(ValueError):  # tables of two widths
        fn(values, lengths, (0, 4),
           [ok, tbe.GroupFeature(q[:, :8], s, s, 0, 16)], out)
    with pytest.raises(TypeError):  # not a float32 output
        fn(values, lengths, (0, 4), [ok], out.double())
    with pytest.raises(TypeError):  # not uint8 codes
        fn(values, lengths, (0, 4), [ok._replace(q=q.float())], out)
    with pytest.raises(ValueError):
        tbe.dedup_quant_pooled_lookup_grouped(values, lengths, (0, 4), [ok],
                                              out, bits=3)
