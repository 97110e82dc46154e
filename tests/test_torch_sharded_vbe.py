"""Variable-batch (VBE) KJTs through the port's sharded
EmbeddingBagCollection (``parallel/embeddingbag.py``), against the JAX
package's ``ShardedEmbeddingBagCollection`` on a one-device mesh and
against a numpy reference.

* C3: two tables of 16 x 8 at world 1, B = 4, ``f0`` at stride 4 and
  ``f1`` at stride 1 with inverse indices ``[[0, 1, 2, 3], [0, 0, 0, 0]]``.
  The sharded collection ran such a batch through the uniform path with
  no error and returned example 0 of ``f1`` right and examples 1-3 wrong
  (TW, RW) or raised on a length count (DP).  Every example of ``f1`` is
  the one reduced row.  A VBE KJT without inverse indices raises.
* Random VBE batches, every plan kind (TW, CW, RW, dedup'd RW, TWRW,
  GRID, DP, mixed): the forward equals the JAX package's and the numpy
  expansion; one SGD step from the same full-batch gradients leaves the
  tables the JAX step leaves; the same batch expanded to the full stride
  gives the same pooled rows bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection as JSharded,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimConfig,
)
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

B, LR = 4, 0.5
TW, CW, RW = "table_wise", "column_wise", "row_wise"
TWRW, GRID, DP = "table_row_wise", "grid_shard", "data_parallel"
TABLES = [
    {"name": "t0", "rows": 40, "dim": 8, "features": ["f0", "f1"],
     "pooling": "SUM"},
    {"name": "t1", "rows": 24, "dim": 8, "features": ["f2"],
     "pooling": "MEAN"},
    {"name": "t2", "rows": 50, "dim": 16, "features": ["f3"],
     "pooling": "SUM"},
]
FEATURES = ["f0", "f1", "f2", "f3"]
# 16 = B x 4, the most ids an expanded key can hold
CAPS = {"f0": 16, "f1": 16, "f2": 16, "f3": 16}
DIMS = {"f0": 8, "f1": 8, "f2": 8, "f3": 16}
# (sharding type, ranks, column shards, dedup) per table
PLANS = {
    "tw": {"t0": (TW, [0], 1), "t1": (TW, [0], 1), "t2": (TW, [0], 1)},
    "cw": {"t0": (CW, [0], 1), "t1": (TW, [0], 1), "t2": (CW, [0], 1)},
    "rw": {t["name"]: (RW, [0], 1) for t in TABLES},
    "rw_dedup": {t["name"]: (RW, [0], 1, True) for t in TABLES},
    "twrw": {"t0": (TWRW, [0], 1), "t1": (TWRW, [0], 1),
             "t2": (TW, [0], 1)},
    "grid": {"t0": (TWRW, [0], 1), "t1": (DP, None, 1),
             "t2": (GRID, [0], 1)},
    "dp": {"t0": (DP, None, 1), "t1": (DP, None, 1), "t2": (DP, None, 1)},
    "mixed": {"t0": (RW, [0], 1), "t1": (DP, None, 1), "t2": (TW, [0], 1)},
}
_RNG = np.random.RandomState(0)
WEIGHTS = {t["name"]: _RNG.randn(t["rows"], t["dim"]).astype(np.float32)
           for t in TABLES}


def _port_tables(spec):
    return [EmbeddingBagConfig(num_embeddings=t["rows"],
                               embedding_dim=t["dim"], name=t["name"],
                               feature_names=list(t["features"]),
                               pooling=PoolingType(t["pooling"]))
            for t in spec]


def _port_plan(spec):
    return {n: ParameterSharding(ShardingType(v[0]), ranks=v[1],
                                 num_col_shards=v[2],
                                 dedup=len(v) > 3 and v[3])
            for n, v in spec.items()}


def _vbe(rng, weighted):
    """Reduced strides 1..B per key, lengths 0..4, inverse indices."""
    spk = [int(rng.randint(1, B + 1)) for _ in FEATURES]
    lengths = np.concatenate([rng.randint(0, 5, size=(s,)) for s in spk]
                             ).astype(np.int32)
    lo = np.cumsum([0] + spk)
    rows = {t: t_["rows"] for t_ in TABLES for t in t_["features"]}
    values = np.concatenate([
        rng.randint(0, rows[f], size=(int(lengths[lo[i]:lo[i + 1]].sum()),))
        for i, f in enumerate(FEATURES)]).astype(np.int64)
    inv = np.stack([rng.randint(0, s, size=(B,)) for s in spk]).astype(
        np.int32)
    w = rng.rand(values.shape[0]).astype(np.float32) if weighted else None
    return dict(keys=FEATURES, values=values, lengths=lengths, weights=w,
                caps=[CAPS[f] for f in FEATURES], stride_per_key=spk,
                inverse_indices=inv)


def _expanded(d):
    """The same batch at the full stride: each example's own ids."""
    spk, inv = d["stride_per_key"], d["inverse_indices"]
    lo = np.cumsum([0] + list(spk))
    offs = np.concatenate([[0], np.cumsum(d["lengths"])])
    lens, vals, ws = [], [], []
    for i in range(len(FEATURES)):
        for b in range(B):
            r = lo[i] + inv[i, b]
            lens.append(d["lengths"][r])
            vals.append(d["values"][offs[r]:offs[r + 1]])
            if d["weights"] is not None:
                ws.append(d["weights"][offs[r]:offs[r + 1]])
    return KeyedJaggedTensor.from_lengths_packed(
        FEATURES, np.concatenate(vals), np.asarray(lens, np.int32),
        np.concatenate(ws) if ws else None, caps=d["caps"])


def _numpy_ref(d):
    """Pooled reduced rows per key, expanded by the inverse indices."""
    spk, inv = d["stride_per_key"], d["inverse_indices"]
    lo = np.cumsum([0] + list(spk))
    offs = np.concatenate([[0], np.cumsum(d["lengths"])])
    out = {}
    for t in TABLES:
        for f in t["features"]:
            i = FEATURES.index(f)
            red = np.zeros((spk[i], t["dim"]), np.float64)
            for b in range(spk[i]):
                r = lo[i] + b
                for p in range(offs[r], offs[r + 1]):
                    x = WEIGHTS[t["name"]][d["values"][p]].astype(np.float64)
                    red[b] += x * (1.0 if d["weights"] is None
                                   else d["weights"][p])
                if t["pooling"] == "MEAN" and d["lengths"][r]:
                    red[b] /= d["lengths"][r]
            out[f] = red[inv[i]]
    return out


def _port_run(kind, d, grads):
    ebc = ShardedEmbeddingBagCollection.build(
        _port_tables(TABLES), _port_plan(PLANS[kind]), 1, B, CAPS)
    params = ebc.params_from_tables(WEIGHTS, rank=0)
    cfg = FusedOptimConfig(optim=EmbOptimType.SGD, learning_rate=LR)
    kjt = KeyedJaggedTensor.from_lengths_packed(**d)
    outs, ctxs = ebc.forward_local(params, kjt)
    ebc.backward_and_update_local(
        params, ebc.init_fused_state(cfg), ctxs,
        {f: torch.from_numpy(g) for f, g in grads.items()}, cfg)
    exp_outs, _ = ebc.forward_local(
        ebc.params_from_tables(WEIGHTS, rank=0), _expanded(d))
    return ({f: o.numpy() for f, o in outs.items()},
            {t: w.numpy() for t, w in ebc.tables_to_weights(params).items()},
            {f: o.numpy() for f, o in exp_outs.items()})


def _jax_run(kind, d, grads, mesh):
    tables = [JCfg(num_embeddings=t["rows"], embedding_dim=t["dim"],
                   name=t["name"], feature_names=t["features"],
                   pooling=JPooling(t["pooling"])) for t in TABLES]
    plan = {n: JPS(JST(v[0]), ranks=v[1], num_col_shards=v[2],
                   dedup=len(v) > 3 and v[3])
            for n, v in PLANS[kind].items()}
    ebc = JSharded.build(tables, plan, 1, B, CAPS)
    params = ebc.params_from_tables(WEIGHTS)
    cfg = JFused(optim=JOptim.SGD, learning_rate=LR)
    fused = ebc.init_fused_state(cfg)
    specs = ebc.param_specs("model")
    kjt = JKJT.from_lengths_packed(**d).pad_strides()
    stacked = jax.tree.map(lambda x: x[None], kjt)
    g = {f: jnp.asarray(v)[None] for f, v in grads.items()}

    def step(params, fused, kjt, g):
        local = jax.tree.map(lambda x: x[0], kjt)
        outs, ctxs = ebc.forward_local(params, local, "model")
        p2, _ = ebc.backward_and_update_local(
            params, fused, ctxs, {f: v[0] for f, v in g.items()}, cfg,
            "model")
        return {f: o[None] for f, o in outs.items()}, p2

    f = jax.jit(jax.shard_map(step, mesh=mesh,
                              in_specs=(specs, specs, P("model"),
                                        P("model")),
                              out_specs=(P("model"), specs),
                              check_vma=False))
    outs, new = f(params, fused, stacked, g)
    return ({k: np.asarray(v)[0] for k, v in outs.items()},
            {k: np.asarray(v) for k, v in ebc.tables_to_weights(new).items()})


@pytest.mark.parametrize("kind", ["tw", "rw", "dp"])
def test_c3_vbe_rows_expand_through_inverse_indices(kind):
    """C3's repro: every example of the stride-1 key is its one reduced
    row (the parent returned rows 1-3 wrong under TW/RW, raised under
    DP)."""
    spec = [{"name": "t0", "rows": 16, "dim": 8, "features": ["f0"],
             "pooling": "SUM"},
            {"name": "t1", "rows": 16, "dim": 8, "features": ["f1"],
             "pooling": "SUM"}]
    st = {"tw": TW, "rw": RW, "dp": DP}[kind]
    plan = {t["name"]: (st, None if kind == "dp" else [0], 1) for t in spec}
    ebc = ShardedEmbeddingBagCollection.build(
        _port_tables(spec), _port_plan(plan), 1, B, {"f0": 8, "f1": 8})
    rng = np.random.RandomState(3)
    w = {t["name"]: rng.randn(16, 8).astype(np.float32) for t in spec}
    lengths = np.array([1, 2, 1, 1, 3], np.int32)  # f0: 4 rows, f1: 1 row
    values = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int64)
    inv = np.array([[0, 1, 2, 3], [0, 0, 0, 0]], np.int32)
    kjt = KeyedJaggedTensor.from_lengths_packed(
        ["f0", "f1"], values, lengths, caps=[8, 8], stride_per_key=[4, 1],
        inverse_indices=inv)
    outs, ctxs = ebc.forward_local(ebc.params_from_tables(w, rank=0), kjt)
    f1_row = w["t1"][[6, 7, 8]].sum(0)  # f1's one row: ids 6, 7, 8
    for b in range(B):
        np.testing.assert_allclose(outs["f1"][b].numpy(), f1_row, rtol=1e-6,
                                   atol=1e-6, err_msg=f"{kind} f1 b={b}")
    f0 = [w["t0"][[1]].sum(0), w["t0"][[2, 3]].sum(0), w["t0"][[4]].sum(0),
          w["t0"][[5]].sum(0)]
    np.testing.assert_allclose(outs["f0"].numpy(), np.stack(f0), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(ctxs["__vbe_inv__"]["f1"], torch.zeros(B).long())
    bare = KeyedJaggedTensor.from_lengths_packed(
        ["f0", "f1"], values, lengths, caps=[8, 8], stride_per_key=[4, 1])
    with pytest.raises(ValueError, match="inverse_indices"):
        ebc.forward_local(ebc.params_from_tables(w, rank=0), bare)


@pytest.fixture(scope="module")
def runs():
    mesh = create_mesh((1,), ("model",))
    rng = np.random.RandomState(42)
    out = {}
    for i, kind in enumerate(PLANS):
        d = _vbe(rng, weighted=i % 2 == 0)
        grads = {f: (rng.randn(B, DIMS[f]) * 0.1).astype(np.float32)
                 for f in FEATURES}
        out[kind] = (d, _port_run(kind, d, grads),
                     _jax_run(kind, d, grads, mesh))
    return out


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_vbe_forward_and_sgd_step_match_jax(kind, runs):
    d, (outs, tables, exp_outs), (j_outs, j_tables) = runs[kind]
    ref = _numpy_ref(d)
    for f in FEATURES:
        np.testing.assert_allclose(outs[f], j_outs[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind} {f} vs JAX")
        np.testing.assert_allclose(outs[f], ref[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind} {f} vs numpy")
        # the expanded batch pools each example's own ids in the same
        # order: the same bits (MEAN weights w / length either way)
        np.testing.assert_array_equal(outs[f], exp_outs[f],
                                      err_msg=f"{kind} {f} vs expanded")
    for t, w in j_tables.items():
        np.testing.assert_allclose(tables[t], w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind} {t} after SGD")
    assert any((tables[t] != w).any() for t, w in WEIGHTS.items())
