"""Port parity for the unsharded authoring path: ``EmbeddingBagCollection``
and ``EmbeddingCollection``, ``DLRM``, ``DLRM_DCN`` and ``DLRM_Projection``
built on a collection, and ``DLRMTrain``, against the flax modules on the
CPU (their default ``"xla"`` lookup) on the same numpy inputs, the
weights carried across with ``convert.py``.

Tolerances, with their reasons:

* collection forwards, ``rtol = atol = 1e-5``: the port pools each
  segment in slot order with separately rounded multiplies and adds, XLA
  with its own gather and segment sum.
* model logits, ``rtol = 1e-5, atol = 1e-6``: XLA and PyTorch sum the
  float32 matmuls in different orders.
* the pooled lookup's gradients against the JAX custom VJPs of its
  Pallas kernels (interpret mode), ``rtol = atol = 1e-6``: the same
  scatter-add in slot order; XLA may contract a multiply-add.
* ``DLRMTrain`` gradients, ``rtol = 1e-4, atol = 1e-7``: the same orders,
  carried through the backward of every layer (a gradient is a sum of
  products whose terms cancel, so its relative error grows where it is
  small); the loss ``rtol = 1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.models import dlrm as jdlrm
from torchrec_tpu.modules import embedding_configs as jcfg
from torchrec_tpu.modules import embedding_modules as jmod
from torchrec_tpu.ops import embedding_ops as jops
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.convert import (
    dlrm_state_dict_from_flax,
    flax_params_from_dlrm_state_dict,
)
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import (
    DLRM,
    DLRM_DCN,
    DLRM_Projection,
    DLRMTrain,
)
from torchrec_tpu_torch.modules import embedding_configs as tcfg
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
    EmbeddingCollection,
    key_regions,
)
from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.ops.embedding_ops import (
    mean_pooling_weights,
    pooled_embedding_lookup,
    pooled_embedding_lookup_regions,
)
from torchrec_tpu.ops import pallas_tbe as jtbe
from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT

D, B, DENSE_IN = 16, 32, 7
ROWS = (500, 1000, 300)
KEYS = ("f0", "f1", "f2", "f3")
# (table, rows, its features): t0 is shared by two features
LAYOUT = (("t0", ROWS[0], ("f0", "f1")), ("t1", ROWS[1], ("f2",)),
          ("t2", ROWS[2], ("f3",)))
MAX_IDS = 4
DENSE_ARCH, OVER_ARCH = (32, D), (32, 16, 1)
FWD = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-7)


def _tables(mod, cls="EmbeddingBagConfig", pooling="SUM", dtype="FP32"):
    kw = {} if cls == "EmbeddingConfig" else {
        "pooling": getattr(mod.PoolingType, pooling)}
    return tuple(
        getattr(mod, cls)(num_embeddings=r, embedding_dim=D, name=n,
                          feature_names=list(f),
                          data_type=getattr(mod.DataType, dtype), **kw)
        for n, r, f in LAYOUT)


def _rows_of(key):
    return next(r for _, r, f in LAYOUT if key in f)


def _batch(seed, weighted=False, vbe=False):
    """(JAX KJT, port KJT) of one batch from a numpy seed; with ``vbe``
    keys f1 and f3 carry reduced batches and inverse indices."""
    rng = np.random.RandomState(seed)
    strides = [B, B // 2, B, B // 4] if vbe else [B] * len(KEYS)
    lengths = np.concatenate([rng.randint(0, MAX_IDS + 1, size=s)
                              for s in strides]).astype(np.int32)
    lo = np.cumsum([0] + strides)
    values = np.concatenate([
        rng.randint(0, _rows_of(k), size=int(lengths[lo[f]: lo[f + 1]].sum()))
        for f, k in enumerate(KEYS)]).astype(np.int64)
    weights = rng.rand(len(values)).astype(np.float32) if weighted else None
    kw = {}
    if vbe:
        inv = np.stack([rng.randint(0, s, size=B) for s in strides])
        kw = dict(stride_per_key=strides, inverse_indices=inv)
    caps = [MAX_IDS * s for s in strides]
    return (JKJT.from_lengths_packed(KEYS, values, lengths, weights,
                                     caps=caps, **kw),
            TKJT.from_lengths_packed(KEYS, values, lengths, weights,
                                     caps=caps, **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_ebc(params, **kw):
    ebc = EmbeddingBagCollection(device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)
    ebc.load_state_dict(dlrm_state_dict_from_flax(_np_tree(params)))
    return ebc


@pytest.mark.parametrize("case", ["sum", "mean", "weighted", "vbe",
                                  "bf16_table"])
def test_ebc_forward_matches_flax(case):
    pooling = "MEAN" if case == "mean" else "SUM"
    dtype = "BF16" if case == "bf16_table" else "FP32"
    weighted = case == "weighted"
    jkjt, tkjt = _batch(1, weighted=weighted, vbe=case == "vbe")
    jebc = jmod.EmbeddingBagCollection(
        tables=_tables(jcfg, pooling=pooling, dtype=dtype),
        is_weighted=weighted)
    params = jebc.init(jax.random.key(0), jkjt)
    want = jebc.apply(params, jkjt)
    tebc = _port_ebc(params, tables=_tables(tcfg, pooling=pooling,
                                            dtype=dtype),
                     is_weighted=weighted)
    assert getattr(tebc, "t0").dtype == (
        torch.bfloat16 if dtype == "BF16" else torch.float32)
    got = tebc(tkjt)
    assert got.keys() == want.keys() == KEYS  # t0 pools f0 and f1
    assert got.length_per_key() == want.length_per_key()
    # float32 out, the half-precision table's sum never rounded to 16 bits
    assert got.values().dtype == torch.float32
    assert got.values().shape == (B, D * len(KEYS))
    np.testing.assert_allclose(got.values().detach().numpy(),
                               np.asarray(want.values()), **FWD)


def test_configs_match_jax():
    """Fields, the dtype maps both ways and the init range, as the JAX
    package has them."""
    import dataclasses

    for cls in ("BaseEmbeddingConfig", "EmbeddingBagConfig",
                "EmbeddingConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(tcfg, cls))]
                == [f.name for f in dataclasses.fields(getattr(jcfg, cls))])
    for name in ("FP32", "FP16", "BF16", "INT8", "INT4", "INT2"):
        jd = jcfg.data_type_to_dtype(getattr(jcfg.DataType, name))
        td = tcfg.data_type_to_dtype(getattr(tcfg.DataType, name))
        assert np.dtype(jd).name == str(td).replace("torch.", "")
        assert (tcfg.dtype_to_data_type(td).value
                == jcfg.dtype_to_data_type(jd).value)
    with pytest.raises(ValueError):
        tcfg.dtype_to_data_type(torch.float64)
    for kw in ({}, {"weight_init_min": -0.5, "weight_init_max": 0.25}):
        j = jcfg.EmbeddingConfig(num_embeddings=400, embedding_dim=4, **kw)
        t = tcfg.EmbeddingConfig(num_embeddings=400, embedding_dim=4, **kw)
        lo, hi = t.get_weight_init_min(), t.get_weight_init_max()
        assert (lo, hi) == (j.get_weight_init_min(), j.get_weight_init_max())
        w = t.init_fn(torch.Generator().manual_seed(0))
        assert w.dtype == torch.float32 and w.shape == (400, 4)
        assert lo <= float(w.min()) and float(w.max()) < hi


def _lookup_case(clipped):
    """A table, Zipf ids (duplicates; with ``clipped`` some past either
    end of the table), segments with dropped slots, weights and an
    upstream gradient (numpy)."""
    rng = np.random.RandomState(6)
    R, V, S = 40, 96, 20
    ids = np.minimum(rng.zipf(1.3, size=V) - 1, R - 1)
    if clipped:
        ids[::7] = R + 2
        ids[3::11] = -1
    return (rng.randn(R, D).astype(np.float32), ids.astype(np.int32),
            rng.randint(0, S + 3, size=V).astype(np.int32),
            rng.rand(V).astype(np.float32),
            rng.randn(S, D).astype(np.float32))


def _port_lookup_grads(kernel, table, ids, segs, w, g):
    t = torch.from_numpy(table).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = pooled_embedding_lookup(t, torch.from_numpy(ids),
                                  torch.from_numpy(segs), g.shape[0], wt,
                                  kernel=kernel)
    return torch.autograd.grad((out * torch.from_numpy(g)).sum(), [t, wt])


@pytest.mark.parametrize("kernel,jkernel,clipped", [
    ("tbe", "pallas", False), ("tbe", "pallas", True),
    ("dedup", "pallas_dedup", False)])
def test_pooled_lookup_grads_match_pallas_vjp(kernel, jkernel, clipped):
    """The autograd Function's table and weight gradients against
    ``jax.grad`` through ``_pallas_pooled_bwd`` / ``_pallas_dedup_pooled_
    bwd``: duplicate ids, dropped slots, and for the per-id kernel ids
    past the table (clipped, as its forward reads them)."""
    table, ids, segs, w, g = _lookup_case(clipped)

    def jloss(t, wt):
        out = jops.pooled_embedding_lookup(t, jnp.asarray(ids),
                                           jnp.asarray(segs), g.shape[0], wt)
        return jnp.sum(out * g)

    with jops.trace_kernels(pooled=jkernel, chunk=32, group=8,
                            interpret=True):
        jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                             jnp.asarray(w))
    for a, b in zip(_port_lookup_grads(kernel, table, ids, segs, w, g), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_pooled_lookup_grads_of_clipped_ids_equal_across_kernels():
    """Ids past the table: both kernels' forwards read the clipped row,
    and the one backward sends its gradient there (the JAX package's
    dedup VJP drops an id at or past the table and wraps a negative one
    instead, so it is held to the per-id VJP here)."""
    case = _lookup_case(True)
    for a, b in zip(_port_lookup_grads("tbe", *case),
                    _port_lookup_grads("dedup", *case)):
        assert torch.equal(a, b)


# (keys of the lookup, batch options, pooling, table dtype): a table's two
# adjacent keys, one key, keys out of order (a permute), a variable batch
REGION_CASES = {
    "adjacent_sum": ((0, 1), {}, "SUM", torch.float32),
    "weighted": ((0, 1), {"weighted": True}, "SUM", torch.float32),
    "mean": ((2, 3), {"weighted": True}, "MEAN", torch.float32),
    "permuted": ((3, 1), {"weighted": True}, "SUM", torch.float32),
    "vbe": ((1, 2, 3), {"vbe": True}, "SUM", torch.float32),
    "bf16": ((0, 1), {"weighted": True}, "SUM", torch.bfloat16),
    "overflow": ((1, 2), {"weighted": True}, "SUM", torch.float32),
    "empty": ((0,), {}, "SUM", torch.float32),
}


def _region_case(name):
    """A KJT's keys read in place as slot regions (``key_regions``), and
    the same keys the sorted way (the permuted KJT's segment ids), each
    with the weights the EBC forward gives them.  Returns (table, regions
    inputs, sorted inputs)."""
    keys, kw, pooling, dtype = REGION_CASES[name]
    _, kjt = _batch(11, **kw)
    if name == "overflow":  # key f1 claims more ids than its cap
        lengths = kjt.lengths().clone()
        lengths[B:2 * B] = MAX_IDS + 2
        kjt = TKJT(KEYS, kjt.values(), lengths, kjt.weights_or_none(),
                   caps=kjt.caps)
    if name == "empty":
        kjt = TKJT(KEYS, kjt.values(), torch.zeros_like(kjt.lengths()),
                   caps=kjt.caps)
    rng = np.random.RandomState(12)
    table = torch.from_numpy(rng.randn(40, D).astype(np.float32)).to(dtype)
    ids, w, regions, _ = key_regions(kjt, keys)
    sub = kjt.permute(keys)
    seg = sub.segment_ids()
    w_sorted = sub.weights_or_none()
    if pooling == "MEAN":
        w = mean_pooling_weights(regions.segment_ids(ids.shape[0]),
                                 regions.lengths, w)
        w_sorted = mean_pooling_weights(seg, sub.lengths(), w_sorted)
    return (table, (ids, regions, w),
            (sub.values(), seg, sub.total_stride, w_sorted))


@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_key_regions_lookup_equals_sorted_plain(case):
    """The region entry's plain version over a KJT's keys read in place
    is ``torch.equal`` to the sorted plain version over the permuted KJT
    (ids clipped: the batch draws ids up to each table's rows, past this
    40-row table), and its regions give the permuted KJT's segment ids."""
    table, (ids, regions, w), (sids, seg, S, sw) = _region_case(case)
    got = tbe.pooled_lookup_regions_plain(table, ids, regions, w)
    assert got.shape == (S, D) and regions.num_segments == S
    assert torch.equal(got, tbe.pooled_lookup_plain(table, sids, seg, S, sw))
    assert torch.equal(regions.segment_ids(ids.shape[0]), seg.to(torch.int64))
    assert torch.equal(got, pooled_embedding_lookup_regions(table, ids,
                                                            regions, w))
    if case == "empty":
        assert not got.any()


@pytest.mark.parametrize("case", ["weighted", "mean", "vbe", "bf16"])
def test_key_regions_lookup_matches_pallas(case):
    """Against the JAX package's Pallas lookup (interpret mode) on the
    permuted KJT's ids and segments: ``rtol = atol = 1e-5`` (bf16 one
    bfloat16 ulp, ``rtol = 2**-7``)."""
    table, (ids, regions, w), (sids, seg, S, sw) = _region_case(case)
    got = tbe.pooled_lookup_regions_plain(table, ids, regions, w)
    jt = jnp.asarray(table.float().numpy()).astype(
        jnp.bfloat16 if case == "bf16" else jnp.float32)
    want = jtbe.pallas_pooled_embedding_lookup(
        jt, jnp.asarray(sids.numpy()), jnp.asarray(seg.numpy()),
        num_segments=S, weights=None if sw is None else jnp.asarray(
            sw.numpy()), chunk=32, group=8, interpret=True)
    tol = (dict(rtol=2.0**-7, atol=1e-6) if case == "bf16" else FWD)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_key_regions_read_adjacent_keys_in_place():
    """A table's adjacent keys in order are views of the KJT's own values,
    weights and lengths (no permute); keys out of order are not."""
    _, kjt = _batch(13, weighted=True)
    ids, w, regions, _ = key_regions(kjt, [1, 2])
    co = kjt.cap_offsets()
    assert ids.data_ptr() == kjt.values()[co[1]:].data_ptr()
    assert w.data_ptr() == kjt.weights_or_none()[co[1]:].data_ptr()
    assert regions.lengths.data_ptr() == kjt.lengths()[B:].data_ptr()
    assert regions.starts == (0, co[2] - co[1])
    ids, _, regions, _ = key_regions(kjt, [2, 1])
    assert ids.data_ptr() != kjt.values()[co[2]:].data_ptr()
    assert regions.starts == (0, kjt.caps[2])


def test_ebc_kernels_agree_and_meta_allocates_nothing():
    _, tkjt = _batch(2, weighted=True)
    gen = torch.Generator().manual_seed(3)
    tbe = EmbeddingBagCollection(_tables(tcfg), is_weighted=True,
                                 device="cpu", generator=gen)
    dedup = EmbeddingBagCollection(_tables(tcfg), is_weighted=True,
                                   device="meta", kernel="dedup")
    assert dedup.is_meta and dedup.to("cpu").is_meta
    dedup.load_state_dict(tbe.state_dict(), assign=True)
    assert torch.equal(tbe(tkjt).values(), dedup(tkjt).values())
    with pytest.raises(ValueError):
        EmbeddingBagCollection(_tables(tcfg), device="cpu")  # no generator
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card by default, and none
            EmbeddingBagCollection(_tables(tcfg),
                                   generator=torch.Generator())
    with pytest.raises(ValueError):
        EmbeddingBagCollection(_tables(tcfg, dtype="INT8"), device="meta")


def test_ec_forward_matches_flax():
    jkjt, tkjt = _batch(3)
    jec = jmod.EmbeddingCollection(
        tables=_tables(jcfg, cls="EmbeddingConfig"))
    params = jec.init(jax.random.key(1), jkjt)
    want = jec.apply(params, jkjt)
    tec = EmbeddingCollection(_tables(tcfg, cls="EmbeddingConfig"),
                              device="cpu",
                              generator=torch.Generator().manual_seed(0))
    tec.load_state_dict(dlrm_state_dict_from_flax(_np_tree(params)))
    got = tec(tkjt)
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].lengths().numpy(),
                                      np.asarray(want[k].lengths()))
        # a gather: the same bits
        np.testing.assert_array_equal(got[k].values().detach().numpy(),
                                      np.asarray(want[k].values()))


ARCHS = {
    "dlrm": (jdlrm.DLRM, DLRM, {}),
    "dcn": (jdlrm.DLRM_DCN, DLRM_DCN,
            dict(dcn_num_layers=2, dcn_low_rank_dim=8)),
    "projection": (jdlrm.DLRM_Projection, DLRM_Projection,
                   dict(interaction_branch1_layer_sizes=(32, 2 * D),
                        interaction_branch2_layer_sizes=(24, 3 * D))),
}


def _models(arch, weighted=False):
    """(flax model, its whole-model params, the port model with those
    weights, the JAX and port batches)."""
    jcls, tcls, kw = ARCHS[arch]
    jkjt, tkjt = _batch(4, weighted=weighted)
    rng = np.random.RandomState(5)
    dense = rng.rand(B, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=B).astype(np.float32)
    jmodel = jcls(
        embedding_bag_collection=jmod.EmbeddingBagCollection(
            tables=_tables(jcfg), is_weighted=weighted),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH, **kw)
    params = jmodel.init(jax.random.key(6), jnp.asarray(dense), jkjt)
    ebc = EmbeddingBagCollection(_tables(tcfg), is_weighted=weighted,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    tmodel = tcls(ebc, DENSE_IN, DENSE_ARCH, OVER_ARCH, *kw.values())
    tmodel.load_state_dict(dlrm_state_dict_from_flax(_np_tree(params)))
    jb = JBatch(jnp.asarray(dense), jkjt, jnp.asarray(labels))
    tb = Batch(torch.from_numpy(dense), tkjt, torch.from_numpy(labels))
    return jmodel, params, tmodel, jb, tb


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_forward_matches_flax(arch):
    jmodel, params, tmodel, jb, tb = _models(arch)
    want = jmodel.apply(params, jb.dense_features, jb.sparse_features)
    got = tmodel(tb.dense_features, tb.sparse_features)
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGITS)
    # the dense side alone, on the collection's own pooled embeddings
    kt = tmodel.embedding_bag_collection(tb.sparse_features)
    np.testing.assert_allclose(
        tmodel.forward_from_embeddings(tb.dense_features, kt)
        .detach().numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_whole_model_params_round_trip_bitwise(arch):
    """The whole flax tree, tables included, to the port and back: every
    leaf equal, the tables untransposed, ``DLRM_Projection``'s two
    interaction MLPs under their own names."""
    _, params, tmodel, _, _ = _models(arch)
    np_params = _np_tree(params)
    sd = dlrm_state_dict_from_flax(np_params)
    assert sorted(sd) == sorted(tmodel.state_dict())
    assert sd["sparse_arch.embedding_bag_collection.t1"].shape == (ROWS[1], D)
    if arch == "projection":
        assert ("inter_arch.interaction_branch2.layers.1.linear.weight"
                in sd)
    back = flax_params_from_dlrm_state_dict(tmodel.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_dlrm_train_loss_and_grads_match_jax():
    """``DLRMTrain``'s loss, and its gradients for every table, every
    dense parameter and the per-id weights, against ``jax.grad``."""
    jmodel, params, tmodel, jb, tb = _models("dlrm", weighted=True)
    jtrain = jdlrm.DLRMTrain(jmodel)
    jparams = {"params": {"dlrm": params["params"]}}
    jkjt = jb.sparse_features

    def loss_fn(p, w):
        batch = JBatch(jb.dense_features, jkjt.with_values(jkjt.values(), w),
                       jb.labels)
        return jtrain.apply(p, batch)[0]

    jloss = loss_fn(jparams, jkjt.weights())
    jg_params, jg_w = jax.grad(loss_fn, argnums=(0, 1))(jparams,
                                                        jkjt.weights())
    train = DLRMTrain(tmodel)
    w = tb.sparse_features.weights_or_none().clone().requires_grad_()
    batch = Batch(tb.dense_features,
                  tb.sparse_features.with_values(tb.sparse_features.values(),
                                                 w), tb.labels)
    loss, (loss_d, logits, labels) = train(batch)
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(loss, list(tmodel.parameters()) + [w])
    assert not loss_d.requires_grad and not logits.requires_grad
    assert labels is batch.labels and logits.shape == (B,)
    np.testing.assert_allclose(float(loss_d), float(jloss), rtol=1e-6)
    want = dlrm_state_dict_from_flax(_np_tree(jg_params["params"]["dlrm"]))
    assert sorted(want) == sorted(names)
    for n, g in zip(names, grads[:-1]):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), **GRADS,
                                   err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_w), **GRADS)
    assert (grads[-1].numpy()[~tb.sparse_features.valid_mask().numpy()]
            == 0).all()
