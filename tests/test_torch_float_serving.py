"""Port parity for the FP16/BF16 serving tables: the collection against
the JAX ``QuantEmbeddingBagCollection`` (float32 output, and
``output_dtype=bfloat16``), artifacts in both directions, and the plain
versions of B1 and B4 with a float16 table and a float32 output from a
16-bit table (the entries the serving collection launches, one a
feature, straight into the KeyedTensor's columns).

Tolerances: against JAX ``rtol = atol = 1e-5`` on float32 output (the
widening of a 16-bit row is exact and both pool in float32; XLA may sum
a segment in another order); ``output_dtype=bfloat16`` within one bf16
ulp (``rtol = 2**-7``, tighter than the JAX package's own bf16 bound of
``rtol=0.05``): the float32 sums differ by at most the tolerance above,
so their bf16 roundings differ by at most one ulp.  Within the port,
bitwise: a 16-bit table pooled into float32 equals the same lookup over
``table.float()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.inference import predict_factory as jpf
from torchrec_tpu.modules.embedding_configs import DataType as JDataType
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JTable,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.quant import QuantEmbeddingBagCollection as JQEBC
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.inference import load_packaged_model, package_model
from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.ops.embedding_ops import SlotRegions
from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection
from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-6)
D, NUM_DENSE = 8, 3
FEATURES = ["f0", "f1", "f2"]
CAPS = [4, 2, 5]
ROWS = [70, 40, 120]
DIMS = [8, 8, 12]


def _tables(cls=EmbeddingBagConfig, pooling=PoolingType):
    return tuple(
        cls(num_embeddings=r, embedding_dim=d, name=f"t{i}",
            feature_names=[f],
            pooling=pooling.MEAN if i == 1 else pooling.SUM)
        for i, (r, d, f) in enumerate(zip(ROWS, DIMS, FEATURES)))


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {f"t{i}": (rng.randn(r, d) * 0.3).astype(np.float32)
            for i, (r, d) in enumerate(zip(ROWS, DIMS))}


def _batch(seed, B=7):
    rng = np.random.RandomState(seed)
    lengths = np.concatenate(
        [rng.randint(0, c + 1, size=(B,)) for c in CAPS]).astype(np.int32)
    values = np.concatenate([
        rng.randint(0, r, size=(int(lengths[f * B:(f + 1) * B].sum()),))
        for f, r in enumerate(ROWS)]).astype(np.int64)
    caps = [c * B for c in CAPS]
    return (JKJT.from_lengths_packed(FEATURES, values, lengths, caps=caps),
            TKJT.from_lengths_packed(FEATURES, values, lengths, caps=caps))


DTYPES = [(DataType.FP16, JDataType.FP16), (DataType.BF16, JDataType.BF16)]


@pytest.mark.parametrize("kernel", ["tbe", "dedup"])
@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_float_collection_matches_jax(dt, jdt, kernel):
    j = JQEBC.from_float(_tables(JTable, JPooling), _weights(), jdt)
    t = QuantEmbeddingBagCollection.from_float(_tables(), _weights(), dt,
                                               lookup_kernel=kernel)
    assert t.params["t0"].q.dtype == {DataType.FP16: torch.float16,
                                      DataType.BF16: torch.bfloat16}[dt]
    # the 16-bit rows are JAX's rounding of the same weights
    np.testing.assert_array_equal(
        t.params["t2"].q.float().numpy(),
        np.asarray(j.params["t2"]["q"].astype(jnp.float32)))
    for seed in (1, 2):
        jkjt, tkjt = _batch(seed)
        ref = np.asarray(j(jkjt).values())
        got = t(tkjt).values()
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        assert t(tkjt).keys() == tuple(FEATURES)


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_output_dtype_bf16_matches_jax(dt, jdt):
    j = JQEBC.from_float(_tables(JTable, JPooling), _weights(), jdt)
    j = JQEBC(j.tables, j.params, jnp.bfloat16)
    for data_type in (dt, DataType.INT8):
        t = QuantEmbeddingBagCollection.from_float(
            _tables(), _weights(), data_type, output_dtype=torch.bfloat16)
        jkjt, tkjt = _batch(3)
        got = t(tkjt).values()
        assert got.dtype == torch.bfloat16
        if data_type == dt:
            np.testing.assert_allclose(
                got.float().numpy(),
                np.asarray(j(jkjt).values().astype(jnp.float32)), **BF16_TOL)
        f32 = QuantEmbeddingBagCollection.from_float(
            _tables(), _weights(), data_type)(tkjt).values()
        assert torch.equal(got, f32.to(torch.bfloat16))
    with pytest.raises(TypeError):
        QuantEmbeddingBagCollection.from_float(_tables(), _weights(), dt,
                                               output_dtype=torch.int32)


@pytest.mark.parametrize("quant_dtype", ["fp16", "bf16"])
def test_float_artifacts_both_ways(tmp_path, quant_dtype):
    w = _weights(4)
    tables = tuple(EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                      name=f"t{i}", feature_names=[f])
                   for i, (r, f) in enumerate(zip(ROWS, FEATURES)))
    jtables = tuple(JTable(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                           feature_names=[f])
                    for i, (r, f) in enumerate(zip(ROWS, FEATURES)))
    w = {k: v[:, :D] for k, v in w.items()}
    caps = dict(zip(FEATURES, CAPS))
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jpf.package_model(jpath, jtables, w, caps, NUM_DENSE,
                      quant_dtype=quant_dtype)
    package_model(tpath, tables, w, caps, NUM_DENSE, quant_dtype=quant_dtype)
    with np.load(f"{jpath}/tables.npz") as a, np.load(
            f"{tpath}/tables.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.RandomState(5)
    dense = rng.rand(7, NUM_DENSE).astype(np.float32)
    jkjt, tkjt = _batch(6)
    for path in (jpath, tpath):
        jfn, jmeta = jpf.load_packaged_model(path)
        tfn, tmeta = load_packaged_model(path, device="cpu")
        assert jmeta["quant_dtype"] == tmeta["quant_dtype"] == quant_dtype
        assert tfn.quant_ebc.params["t0"].q.dtype == (
            torch.float16 if quant_dtype == "fp16" else torch.bfloat16)
        np.testing.assert_allclose(
            tfn(torch.from_numpy(dense), tkjt).numpy(),
            np.asarray(jfn(jnp.asarray(dense), jkjt)), **TOL)


# ---------------------------------------------------------------------------
# B1 and B4 plain versions: float16 tables, float32 output
# ---------------------------------------------------------------------------


def _slots(seed, R=50, V=60, S=9):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(-2, R + 3, size=V).astype(np.int64))
    segs = torch.from_numpy(rng.randint(-1, S + 1, size=V).astype(np.int64))
    w = torch.from_numpy(rng.rand(V).astype(np.float32))
    table = torch.from_numpy((rng.randn(R, 12) * 2).astype(np.float32))
    return table, ids, segs, w, S


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_b1_b4_plain_16bit_into_float32(dtype, weighted):
    table, ids, segs, w, S = _slots(7)
    t16 = table.to(dtype)
    w = w if weighted else None
    over_f32 = tbe.pooled_lookup(t16.float(), ids, segs, S, w)
    for fn in (tbe.pooled_lookup, tbe.dedup_pooled_lookup,
               tbe.pooled_lookup_plain, tbe.dedup_pooled_lookup_plain):
        got = fn(t16, ids, segs, S, w, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert torch.equal(got, over_f32), fn.__name__
        same = fn(t16, ids, segs, S, w)
        assert same.dtype == dtype
        assert torch.equal(same, over_f32.to(dtype)), fn.__name__
    with pytest.raises(TypeError):
        tbe.pooled_lookup(t16, ids, segs, S, w, out_dtype=torch.bfloat16
                          if dtype == torch.float16 else torch.float16)
    with pytest.raises(TypeError):
        tbe.pooled_lookup(table, ids, segs, S, w, out_dtype=torch.float16)


def test_b1_regions_plain_16bit_into_float32():
    rng = np.random.RandomState(8)
    B, caps = 5, (7, 3, 11)
    lengths = torch.from_numpy(np.concatenate(
        [rng.randint(0, c + 2, size=B) for c in caps]).astype(np.int32))
    starts = tuple(int(x) for x in np.cumsum((0,) + caps[:-1]))
    regions = SlotRegions(lengths, starts, caps, (B,) * 3)
    ids = torch.from_numpy(rng.randint(0, 40, size=sum(caps)))
    table = torch.from_numpy(rng.randn(40, 8).astype(np.float32))
    for dtype in (torch.float16, torch.bfloat16):
        t16 = table.to(dtype)
        got = tbe.pooled_lookup_regions(t16, ids, regions,
                                        out_dtype=torch.float32)
        assert torch.equal(got, tbe.pooled_lookup_regions(
            t16.float(), ids, regions))


@pytest.mark.parametrize("kernel", ["tbe", "dedup"])
def test_float_grouped_plain_writes_each_feature_columns(kernel):
    """The grouped float lookup (the collection's FP16/BF16 path) writes
    each feature's pooled rows into its columns of a wider buffer, equal
    to the per-feature lookups over ``table.float()``; MEAN by ``1/len``
    weights; other columns untouched."""
    B = 6
    _, tkjt = _batch(9, B)
    rng = np.random.RandomState(10)
    dtypes = (torch.float16, torch.bfloat16, torch.float16)
    feats, width = [], 0
    for k, (r, d, dt) in enumerate(zip(ROWS, (8, 8, 8), dtypes)):
        t = torch.from_numpy(rng.randn(r, d).astype(np.float32)).to(dt)
        feats.append(tbe.FloatFeature(t, k, width + 2, mean=k == 1))
        width += d + 2
    out = torch.full((B, width + 2), 7.0)
    tbe.float_pooled_lookup_grouped(tkjt.values(), tkjt.lengths(),
                                    tkjt.cap_offsets(), feats, out, kernel)
    seg = tkjt.segment_ids()
    keep = torch.ones_like(out, dtype=torch.bool)
    for f in feats:
        lo, hi = tkjt.cap_offsets()[f.key], tkjt.cap_offsets()[f.key + 1]
        s = seg[lo:hi] - f.key * B
        w = None
        if f.mean:
            lens = tkjt.lengths()[f.key * B:(f.key + 1) * B].float()
            inv = torch.where(lens > 0, 1.0 / lens.clamp(min=1), 0.0)
            w = torch.cat([inv, inv.new_zeros(1)])[s.clamp(0, B)]
        ref = tbe.pooled_lookup(f.table.float(), tkjt.values()[lo:hi], s, B,
                                w)
        assert torch.equal(out[:, f.col:f.col + 8], ref)
        keep[:, f.col:f.col + 8] = False
    assert (out[keep] == 7.0).all()
    with pytest.raises(ValueError, match="kernel"):
        tbe.float_pooled_lookup_grouped(tkjt.values(), tkjt.lengths(),
                                        tkjt.cap_offsets(), feats, out, "b5")
    with pytest.raises(TypeError):
        tbe.float_pooled_lookup_grouped(tkjt.values(), tkjt.lengths(),
                                        tkjt.cap_offsets(), feats,
                                        out.to(torch.float16), kernel)
