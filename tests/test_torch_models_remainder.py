"""Port parity for the remaining model families against the JAX package's
forwards, the weights carried by ``convert.py``: ``DLRM_Transformer``
(and one one-device DMP train step of it, the port on its per-id
kernels' plain versions), ``SimpleDeepFMNN``, ``TwoTower`` with
``in_batch_negatives_loss`` and ``BruteForceKNN``, ``CrossNet``,
``VectorCrossNet`` and ``LowRankMixtureCrossNet``, the position-weighted
EBC (``FeatureProcessedEmbeddingBagCollection``, B1's plain version with
per-slot weights), ``KTRegroupAsDict`` and ``JaggedTensor``'s dense
constructors and converters.

Tolerances: float32 forwards ``rtol = 1e-5, atol = 1e-5`` (XLA and
PyTorch sum the products and the LayerNorm moments in other orders; the
transformer's outputs reach magnitude 5); the KNN's scores ``atol =
1e-5`` and its indices exact (no ties in random scores); the regroup,
the position weights, ``positions_in_bag`` and the jagged conversions
exact; the DMP step's loss ``atol = 1e-6``, its dense parameters ``atol =
1e-5`` and its table ``atol = 1e-6`` (one rowwise-Adagrad step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
from torchrec_tpu.models.deepfm import SimpleDeepFMNN as JDeepFM
from torchrec_tpu.models.experimental.transformerdlrm import (
    DLRM_Transformer as JDLRMT,
)
from torchrec_tpu.models.two_tower import BruteForceKNN as JKNN
from torchrec_tpu.models.two_tower import TwoTower as JTwoTower
from torchrec_tpu.models.two_tower import (
    in_batch_negatives_loss as j_ibn_loss,
)
from torchrec_tpu.modules.crossnet import CrossNet as JCrossNet
from torchrec_tpu.modules.crossnet import (
    LowRankMixtureCrossNet as JMixture,
)
from torchrec_tpu.modules.crossnet import VectorCrossNet as JVector
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_modules import (
    EmbeddingBagCollection as JEBC,
)
from torchrec_tpu.modules.feature_processor import (
    FeatureProcessedEmbeddingBagCollection as JFPEBC,
)
from torchrec_tpu.modules.feature_processor import (
    positions_in_bag as j_positions,
)
from torchrec_tpu.modules.regroup import KTRegroupAsDict as JRegroup
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import JaggedTensor as JJT
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import KeyedTensor as JKT
from torchrec_tpu_torch.convert import (
    state_dict_from_flax,
    train_state_from_jax,
    train_state_to_jax,
)
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.deepfm import SimpleDeepFMNN
from torchrec_tpu_torch.models.dlrm import load_dense_state_dict
from torchrec_tpu_torch.models.experimental.transformerdlrm import (
    DLRM_Transformer,
)
from torchrec_tpu_torch.models.two_tower import (
    BruteForceKNN,
    TwoTower,
    in_batch_negatives_loss,
)
from torchrec_tpu_torch.modules.crossnet import (
    CrossNet,
    LowRankMixtureCrossNet,
    VectorCrossNet,
)
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.embedding_tower import (
    EmbeddingTower,
    EmbeddingTowerCollection,
)
from torchrec_tpu_torch.modules.feature_processor import (
    FeatureProcessedEmbeddingBagCollection,
    PositionWeightedModule,
    positions_in_bag,
)
from torchrec_tpu_torch.modules.regroup import KTRegroupAsDict
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import table_wise_plan
from torchrec_tpu_torch.sparse import (
    JaggedTensor,
    KeyedJaggedTensor,
    KeyedTensor,
)

KEYS = ["f0", "f1", "f2"]
ROWS, D, B, DENSE_IN = 500, 16, 8, 13
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _tables(cls, keys=KEYS, rows=ROWS, dim=D, prefix="t_"):
    return tuple(cls(num_embeddings=rows, embedding_dim=dim,
                     name=f"{prefix}{k}", feature_names=[k]) for k in keys)


def _kt_inputs(seed, keys=KEYS):
    rng = np.random.RandomState(seed)
    dense = rng.rand(B, DENSE_IN).astype(np.float32)
    emb = rng.randn(B, len(keys) * D).astype(np.float32)
    return (dense, emb, JKT(keys, [D] * len(keys), jnp.asarray(emb)),
            KeyedTensor(keys, [D] * len(keys), torch.from_numpy(emb)))


def _kjt_data(seed, keys=KEYS, max_ids=4, weighted=False):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, max_ids + 1, size=(len(keys) * B,)).astype(
        np.int32)
    values = rng.randint(0, ROWS, size=(int(lengths.sum()),))
    weights = (rng.rand(values.shape[0]).astype(np.float32) if weighted
               else None)
    return keys, values, lengths, weights, [max_ids * B] * len(keys)


def _kjts(data):
    keys, values, lengths, weights, caps = data
    return (JKJT.from_lengths_packed(keys, values, lengths, weights,
                                     caps=caps),
            KeyedJaggedTensor.from_lengths_packed(keys, values, lengths,
                                                  weights, caps=caps))


# -- DLRM_Transformer --------------------------------------------------------

DENSE_ARCH, OVER_ARCH, NHEAD, NLAYERS = (32, D), (32, 1), 4, 2


def _jax_dlrmt(ebc_tables=None):
    return JDLRMT(embedding_bag_collection=JEBC(
        tables=ebc_tables or _tables(JCfg)), dense_in_features=DENSE_IN,
        dense_arch_layer_sizes=DENSE_ARCH, over_arch_layer_sizes=OVER_ARCH,
        nhead=NHEAD, ntransformer_layers=NLAYERS)


def _port_dlrmt():
    return DLRM_Transformer(EmbeddingBagCollection(
        _tables(EmbeddingBagConfig), device="meta"), DENSE_IN, DENSE_ARCH,
        OVER_ARCH, NHEAD, NLAYERS)


def test_dlrm_transformer_matches_flax():
    dense, _, jkt, tkt = _kt_inputs(0)
    jm = _jax_dlrmt()
    params = jm.init(jax.random.key(0), jnp.asarray(dense), jkt,
                     method=JDLRMT.forward_from_embeddings)
    want = np.asarray(jm.apply(params, jnp.asarray(dense), jkt,
                               method=JDLRMT.forward_from_embeddings))
    pm = _port_dlrmt()
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert "inter_arch.blocks.1.attention.out.weight" in sd
    load_dense_state_dict(pm, sd)
    got = _np(pm.forward_from_embeddings(torch.from_numpy(dense), tkt))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_dlrm_transformer_dmp_step_matches_jax():
    """One one-device DMP train step of DLRM_Transformer from the same
    carried state on the same batch (rowwise Adagrad on the tables, dense
    Adagrad)."""
    lr = 0.05
    jds = JDataset(KEYS, B, [ROWS] * 3, [3] * 3, num_dense=DENSE_IN,
                   manual_seed=0)
    tables = _tables(JCfg)
    jdmp = JDMP(model=_jax_dlrmt(tables), tables=tables,
                env=ShardingEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
                plan={t.name: JPS(JST.TABLE_WISE, ranks=[0])
                      for t in tables}, batch_size_per_device=B,
                feature_caps=dict(zip(KEYS, jds.caps)),
                dense_in_features=DENSE_IN,
                fused_config=JFused(learning_rate=lr),
                dense_optimizer=optax.adagrad(lr))
    jstate = jdmp.init(jax.random.key(1))
    start = jax.tree.map(np.asarray, jstate)
    ptables = _tables(EmbeddingBagConfig)
    dmp = DistributedModelParallel(
        _port_dlrmt(), ptables, table_wise_plan(ptables), B,
        dict(zip(KEYS, jds.caps)),
        fused_config=FusedOptimConfig(learning_rate=lr),
        dense_optimizer=adagrad(lr), device="cpu")
    state = train_state_from_jax(start, device="cpu")
    fresh = dmp.init(torch.Generator().manual_seed(0))
    assert fresh["dense"].keys() == state["dense"].keys()
    # flax's LayerNorm scale starts at one
    assert (fresh["dense"]["inter_arch.blocks.0.norm_0.weight"] == 1).all()
    jstate, jm = jdmp.make_train_step(donate=False)(
        jstate, stack_batches([next(iter(jds))]))
    state, m = dmp.train_step(state, next(iter(RandomRecDataset(
        KEYS, B, [ROWS] * 3, [3] * 3, num_dense=DENSE_IN, manual_seed=0))))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
    got = train_state_to_jax(state, num_heads=NHEAD)
    want = jax.tree.map(np.asarray, jstate)
    assert jax.tree.structure(got["dense"]) == jax.tree.structure(
        want["dense"])
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for g, t in want["tables"].items():
        np.testing.assert_allclose(got["tables"][g], t, rtol=0, atol=1e-6)
        assert (got["tables"][g] != start["tables"][g]).any()


# -- DeepFM -----------------------------------------------------------------

def test_simple_deepfm_matches_flax():
    dense, _, jkt, tkt = _kt_inputs(1)
    jm = JDeepFM(embedding_bag_collection=JEBC(tables=_tables(JCfg)),
                 num_dense_features=DENSE_IN, hidden_layer_size=24,
                 deep_fm_dimension=8)
    params = jm.init(jax.random.key(2), jnp.asarray(dense), jkt,
                     method=JDeepFM.forward_from_embeddings)
    want = np.asarray(jm.apply(params, jnp.asarray(dense), jkt,
                               method=JDeepFM.forward_from_embeddings))
    pm = SimpleDeepFMNN(EmbeddingBagCollection(_tables(EmbeddingBagConfig),
                                               device="meta"),
                        DENSE_IN, 24, 8)
    load_dense_state_dict(pm, state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    got = _np(pm.forward_from_embeddings(torch.from_numpy(dense), tkt))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got, want, **TOL)
    # the whole model through its collection
    data = _kjt_data(3)
    jkjt, tkjt = _kjts(data)
    full = jm.init(jax.random.key(3), jnp.asarray(dense), jkjt)
    pm2 = SimpleDeepFMNN(EmbeddingBagCollection(
        _tables(EmbeddingBagConfig), device="cpu",
        generator=torch.Generator()), DENSE_IN, 24, 8)
    pm2.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, full)))
    np.testing.assert_allclose(
        _np(pm2(torch.from_numpy(dense), tkjt)),
        np.asarray(jm.apply(full, jnp.asarray(dense), jkjt)), **TOL)


# -- TwoTower and BruteForceKNN ---------------------------------------------

def test_two_tower_and_knn_match_jax():
    q_tables = _tables(JCfg, ["q0", "q1"], prefix="tq_")
    c_tables = _tables(JCfg, ["c0"], prefix="tc_")
    jm = JTwoTower(query_ebc=JEBC(tables=q_tables),
                   candidate_ebc=JEBC(tables=c_tables), layer_sizes=(24, 8))
    jq, tq = _kjts(_kjt_data(4, ["q0", "q1"]))
    jc, tc = _kjts(_kjt_data(5, ["c0"]))
    params = jm.init(jax.random.key(4), jq, jc)
    pm = TwoTower(
        EmbeddingBagCollection(_tables(EmbeddingBagConfig, ["q0", "q1"],
                                       prefix="tq_"), device="cpu",
                               generator=torch.Generator()),
        EmbeddingBagCollection(_tables(EmbeddingBagConfig, ["c0"],
                                       prefix="tc_"), device="cpu",
                               generator=torch.Generator()),
        layer_sizes=(24, 8))
    pm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray,
                                                         params)))
    want = np.asarray(jm.apply(params, jq, jc))
    scores = pm(tq, tc)
    np.testing.assert_allclose(_np(scores), want, **TOL)
    np.testing.assert_allclose(
        in_batch_negatives_loss(scores).item(),
        float(j_ibn_loss(jnp.asarray(want))), rtol=1e-5)
    # exact top-k over candidate embeddings
    rng = np.random.RandomState(6)
    cands = rng.randn(300, 8).astype(np.float32)
    cands /= np.linalg.norm(cands, axis=1, keepdims=True)
    queries = _np(pm.embed_query(tq))
    j_scores, j_idx = JKNN(jnp.asarray(cands)).query(jnp.asarray(queries),
                                                     10)
    t_scores, t_idx = BruteForceKNN(torch.from_numpy(cands)).query(
        torch.from_numpy(queries), 10)
    np.testing.assert_allclose(_np(t_scores), np.asarray(j_scores),
                               atol=1e-5)
    np.testing.assert_array_equal(_np(t_idx), np.asarray(j_idx))


class _Values(torch.nn.Module):
    def forward(self, kt):
        return kt.values()


def test_embedding_tower_collection_concatenates_towers():
    tables = _tables(EmbeddingBagConfig)
    ebcs = [EmbeddingBagCollection(tables[:2], device="cpu",
                                   generator=torch.Generator().manual_seed(0)),
            EmbeddingBagCollection(tables[2:], device="cpu",
                                   generator=torch.Generator().manual_seed(1))]
    towers = [EmbeddingTower(e, _Values()) for e in ebcs]
    coll = EmbeddingTowerCollection(towers, [["f0", "f1"], ["f2"]])
    _, tkjt = _kjts(_kjt_data(7))
    got = coll(tkjt)
    want = torch.cat([ebcs[0](tkjt.select_keys(["f0", "f1"])).values(),
                      ebcs[1](tkjt.select_keys(["f2"])).values()], dim=-1)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        EmbeddingTowerCollection(towers, [["f0"]])


# -- cross nets ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "vector", "mixture1", "mixture3"])
def test_cross_nets_match_flax(kind):
    width = 24
    x = np.random.RandomState(8).randn(B, width).astype(np.float32)
    jnet, net = {
        "full": (JCrossNet(num_layers=2), CrossNet(width, 2)),
        "vector": (JVector(num_layers=3), VectorCrossNet(width, 3)),
        "mixture1": (JMixture(num_layers=2, num_experts=1, low_rank=4),
                     LowRankMixtureCrossNet(width, 2, 1, 4)),
        "mixture3": (JMixture(num_layers=2, num_experts=3, low_rank=4,
                              activation="tanh"),
                     LowRankMixtureCrossNet(width, 2, 3, 4, "tanh")),
    }[kind]
    params = jnet.init(jax.random.key(9), jnp.asarray(x))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(net.state_dict())
    net.load_state_dict(sd)
    np.testing.assert_allclose(_np(net(torch.from_numpy(x))),
                               np.asarray(jnet.apply(params, jnp.asarray(x))),
                               **TOL)


# -- the position-weighted EBC, regroup, jagged conversions -----------------

def test_positions_in_bag_match_jax():
    lengths = np.asarray([2, 0, 3, 1], np.int32)
    want = np.asarray(j_positions(jnp.asarray(lengths), 10))
    got = positions_in_bag(torch.from_numpy(lengths), 10)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(want[:6], [0, 1, 0, 1, 2, 0])


@pytest.mark.parametrize("weighted", [False, True])
def test_position_weighted_ebc_matches_jax(weighted):
    lens = {"f0": 4, "f2": 3}
    data = _kjt_data(10, weighted=weighted)
    jkjt, tkjt = _kjts(data)
    jm = JFPEBC(embedding_bag_collection=JEBC(tables=_tables(JCfg),
                                              is_weighted=True),
                max_feature_lengths=lens)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(11), jkjt))
    rng = np.random.RandomState(12)
    pw = params["params"]["position_weights"]
    for k in pw:  # learned weights, not the initial ones
        pw[k] = rng.rand(*pw[k].shape).astype(np.float32)
    want = jm.apply(params, jkjt)
    pm = FeatureProcessedEmbeddingBagCollection(
        EmbeddingBagCollection(_tables(EmbeddingBagConfig), is_weighted=True,
                               device="cpu", generator=torch.Generator()),
        lens)
    assert (pm.position_weights.position_weight_f0 == 1).all()
    pm.load_state_dict(state_dict_from_flax(
        params, tables_prefix="embedding_bag_collection."))
    got = pm(tkjt)
    assert got.keys() == tuple(want.keys())
    np.testing.assert_allclose(_np(got.values()), np.asarray(want.values()),
                               **TOL)
    # one feature's module alone
    jt = tkjt["f0"]
    pwm = PositionWeightedModule(4)
    with torch.no_grad():
        pwm.position_weight.copy_(torch.from_numpy(pw["position_weight_f0"]))
    got_w = pwm(jt).weights_or_none()
    pos = _np(positions_in_bag(jt.lengths(), jt.capacity))
    base = np.ones(jt.capacity) if jt.weights_or_none() is None else _np(
        jt.weights_or_none())
    np.testing.assert_array_equal(
        _np(got_w), (pw["position_weight_f0"][np.minimum(pos, 3)]
                     * base).astype(np.float32))


def test_kt_regroup_as_dict_matches_jax():
    rng = np.random.RandomState(13)
    a = rng.randn(B, 8).astype(np.float32)
    b = rng.randn(B, 12).astype(np.float32)
    groups, names = [["a1", "b0"], ["a0", "b1", "a1"]], ["g0", "g1"]
    jkts = [JKT(["a0", "a1"], [3, 5], jnp.asarray(a)),
            JKT(["b0", "b1"], [4, 8], jnp.asarray(b))]
    tkts = [KeyedTensor(["a0", "a1"], [3, 5], torch.from_numpy(a)),
            KeyedTensor(["b0", "b1"], [4, 8], torch.from_numpy(b))]
    want = JRegroup(groups, names)(jkts)
    got = KTRegroupAsDict(groups, names)(tkts)
    assert list(got) == names
    for k in names:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def test_jagged_dense_constructors_match_jax():
    rng = np.random.RandomState(14)
    rows = [rng.randn(n, 3).astype(np.float32) for n in (2, 0, 4, 1)]
    jjt = JJT.from_dense(rows)
    tjt = JaggedTensor.from_dense([torch.from_numpy(r) for r in rows])
    np.testing.assert_array_equal(_np(tjt.values()), np.asarray(jjt.values()))
    np.testing.assert_array_equal(_np(tjt.lengths()),
                                  np.asarray(jjt.lengths()))
    for a, b in zip(tjt.to_dense(), rows):
        np.testing.assert_array_equal(_np(a), b)
    dense = rng.randn(4, 5, 3).astype(np.float32)
    lengths = np.asarray([5, 0, 2, 7], np.int32)  # 7 is cut to 5
    jd = JJT.from_dense_lengths(jnp.asarray(dense), jnp.asarray(lengths))
    td = JaggedTensor.from_dense_lengths(torch.from_numpy(dense),
                                         torch.from_numpy(lengths))
    np.testing.assert_array_equal(_np(td.values()), np.asarray(jd.values()))
    np.testing.assert_array_equal(_np(td.lengths()), np.asarray(jd.lengths()))
    np.testing.assert_array_equal(_np(td.to_padded_dense(5)),
                                  np.asarray(jd.to_padded_dense(5)))
    w = rng.rand(7).astype(np.float32)
    jw = JJT(jnp.arange(7), jnp.asarray([3, 4], jnp.int32), jnp.asarray(w))
    tw = JaggedTensor(torch.arange(7), torch.tensor([3, 4], dtype=torch.int32),
                      torch.from_numpy(w))
    for a, b in zip(tw.to_dense_weights(), jw.to_dense_weights()):
        np.testing.assert_array_equal(_np(a), b)
    assert JaggedTensor(torch.arange(3),
                        torch.tensor([3])).to_dense_weights() is None
