"""The port's sharding layouts, plumbing, dispatch and codecs against the
JAX package's, in one process (no spawn): ``classify_plan`` and every
layout it builds field by field at world sizes 2, 4 and 8 over the plans
of ``tests/test_sharded_ebc.py``; the group stacks from full tables (every
rank's and each rank's share) and back; ``stack_rows_for_table``;
``moe_dispatch_batched`` bit for bit, overflow included; the qcomm codecs
within the tolerances of ``tests/test_sharded_ebc.py``; the wire bytes per
float32.  The layouts are plain numpy and Python, so they are compared
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.parallel import qcomm as jqcomm
from torchrec_tpu.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection as JSharded,
)
from torchrec_tpu.parallel.grouped import classify_plan as jclassify
from torchrec_tpu.parallel.sharding.common import (
    moe_dispatch_batched as jdispatch,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.parallel import qcomm
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.grouped import classify_plan
from torchrec_tpu_torch.parallel.sharding.common import moe_dispatch_batched
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType

B = 4
CAPS = {"f0": 24, "f1": 16, "f2": 16, "f3": 24}
TABLES = [("t0", 100, 8, ["f0", "f1"], "SUM"), ("t1", 64, 8, ["f2"], "MEAN"),
          ("t2", 200, 16, ["f3"], "SUM")]
# tests/test_sharded_ebc.py's plans at a world of 8: (type, ranks, shards)
PLANS8 = {
    "tw": {"t0": ("table_wise", [1]), "t1": ("table_wise", [3]),
           "t2": ("table_wise", [6])},
    "cw": {"t0": ("column_wise", [0, 5]), "t1": ("table_wise", [2]),
           "t2": ("column_wise", [4, 4])},
    "rw": {t[0]: ("row_wise", list(range(8))) for t in TABLES},
    "mixed": {"t0": ("row_wise", list(range(8))), "t1": ("table_wise", [7]),
              "t2": ("column_wise", [1, 2])},
    "dp": {"t0": ("data_parallel", None), "t1": ("data_parallel", None),
           "t2": ("table_wise", [0])},
    "twrw": {"t0": ("table_row_wise", [2, 3]),
             "t1": ("table_row_wise", [4, 5, 6, 7]),
             "t2": ("table_wise", [1])},
    "grid": {"t0": ("table_row_wise", [0, 1]), "t1": ("data_parallel", None),
             "t2": ("grid_shard", [2, 3, 6, 7], 2)},
}
WORLDS = (2, 4, 8)


def _node(ranks, n):
    """A contiguous node of ``ranks`` moved into a world of ``n``."""
    size = min(len(ranks), n)
    start = min(ranks[0] % n, n - size)
    return list(range(start, start + size))


def plan_at(kind, n):
    """The plan ``kind`` in a world of ``n``: ranks taken mod ``n``, each
    TWRW/GRID node kept contiguous.  (type, ranks, col shards)."""
    out = {}
    for t, spec in PLANS8[kind].items():
        st, ranks, ncs = (spec + (1,))[:3]
        if ranks is not None:
            if st in ("table_row_wise", "grid_shard"):
                per = len(ranks) // ncs
                ranks = [r for i in range(ncs)
                         for r in _node(ranks[i * per:(i + 1) * per], n)]
            else:
                ranks = [r % n for r in ranks]
        out[t] = (st, ranks, ncs)
    return out


def _both(kind, n):
    """(JAX tables, JAX plan, port tables, port plan)."""
    spec = plan_at(kind, n)
    jt = [JCfg(num_embeddings=r, embedding_dim=d, name=nm, feature_names=f,
               pooling=JPooling(p)) for nm, r, d, f, p in TABLES]
    pt = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=d, name=nm,
                             feature_names=f, pooling=PoolingType(p))
          for nm, r, d, f, p in TABLES]
    jp = {t: JPS(JST(st), ranks=r, num_col_shards=c)
          for t, (st, r, c) in spec.items()}
    pp = {t: ParameterSharding(ShardingType(st), ranks=r, num_col_shards=c)
          for t, (st, r, c) in spec.items()}
    return jt, jp, pt, pp


def _spec(f):
    return (f.name, f.table_name, f.table_rows, f.dim, f.pooling.value, f.cap)


def _slot(s):
    return (_spec(s.feature), s.owner, s.slot_index, s.out_offset,
            s.out_feature)


def _block(s):
    return (_spec(s.feature), s.col_shard, s.out_offset, s.node_devices,
            s.block_size)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", sorted(PLANS8))
def test_classify_plan_matches_jax(kind, n):
    jt, jp, pt, pp = _both(kind, n)
    want = jclassify(jt, jp, n, B, CAPS)
    got = classify_plan(pt, pp, n, B, CAPS)
    assert got.feature_order == want.feature_order
    assert got.feature_dims == want.feature_dims
    assert list(got.tw_layouts) == list(want.tw_layouts)
    for name, g in got.tw_layouts.items():
        w = want.tw_layouts[name]
        assert (g.name, g.world_size, g.batch_size, g.dim, g.cap, g.f_max,
                g.r_stack) == (w.name, w.world_size, w.batch_size, w.dim,
                               w.cap, w.f_max, w.r_stack)
        assert [_slot(s) for s in g.slots] == [_slot(s) for s in w.slots]
        np.testing.assert_array_equal(g.row_offset, w.row_offset)
        assert g.stack_assignment == w.stack_assignment
        assert {f: [_slot(s) for s in v] for f, v in g.feature_slots.items()
                } == {f: [_slot(s) for s in v]
                      for f, v in w.feature_slots.items()}
        assert g.feature_order == w.feature_order
    assert list(got.rw_layouts) == list(want.rw_layouts)
    for name, g in got.rw_layouts.items():
        w = want.rw_layouts[name]
        assert (g.name, g.world_size, g.batch_size, g.dim, g.cap, g.l_stack,
                g.block_size, g.local_offset) == (
            w.name, w.world_size, w.batch_size, w.dim, w.cap, w.l_stack,
            w.block_size, w.local_offset)
        assert [_spec(f) for f in g.features] == [_spec(f) for f in w.features]
    assert list(got.twrw_layouts) == list(want.twrw_layouts)
    for name, g in got.twrw_layouts.items():
        w = want.twrw_layouts[name]
        assert (g.name, g.world_size, g.batch_size, g.dim, g.cap, g.l_stack,
                g.feature_order) == (
            w.name, w.world_size, w.batch_size, w.dim, w.cap, w.l_stack,
            w.feature_order)
        assert [_block(s) for s in g.slots] == [_block(s) for s in w.slots]
        np.testing.assert_array_equal(g.dest_offset, w.dest_offset)
    assert list(got.dp_groups) == list(want.dp_groups)
    for name, g in got.dp_groups.items():
        w = want.dp_groups[name]
        assert (g.name, g.table_rows, g.local_offset, g.stack_rows, g.dim,
                [_spec(f) for f in g.features]) == (
            w.name, w.table_rows, w.local_offset, w.stack_rows, w.dim,
            [_spec(f) for f in w.features])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", sorted(PLANS8))
def test_group_stacks_match_jax_and_round_trip(kind, n):
    """Every rank's stacks (``rank=None``) equal the JAX package's global
    stacks, each rank's share is its rows of them, the stacks give the
    tables back, and ``stack_rows_for_table`` finds each rank's rows of a
    table where the JAX one finds them globally."""
    jt, jp, pt, pp = _both(kind, n)
    rng = np.random.RandomState(0)
    weights = {nm: rng.randn(r, d).astype(np.float32)
               for nm, r, d, _, _ in TABLES}
    jebc = JSharded.build(jt, jp, n, B, CAPS)
    ebc = ShardedEmbeddingBagCollection.build(pt, pp, n, B, CAPS)
    want = {k: np.asarray(v) for k, v in jebc.params_from_tables(
        weights).items()}
    full = ebc.params_from_tables(weights, rank=None)
    assert list(full) == list(want)
    for name, t in full.items():
        np.testing.assert_array_equal(t.numpy(), want[name])
        rows = ebc.local_rows(name)
        for r in range(n):
            mine = ebc.params_from_tables(weights, rank=r)[name].numpy()
            if name in ebc.dp_groups:
                np.testing.assert_array_equal(mine, want[name])
            else:
                np.testing.assert_array_equal(
                    mine, want[name][r * rows:(r + 1) * rows])
    back = ebc.tables_to_weights(full)
    for t, w in weights.items():
        np.testing.assert_array_equal(back[t].numpy(), w)
    ids = np.arange(0, 64, 3)
    for t in weights:
        name, want_rows = jebc.stack_rows_for_table(t, ids)
        if name in ebc.dp_groups:
            g_name, local, which = ebc.stack_rows_for_table(t, ids)
            assert g_name == name
            np.testing.assert_array_equal(local, want_rows)
            continue
        rows, got = ebc.local_rows(name), []
        for r in range(n):
            g_name, local, which = ebc.stack_rows_for_table(t, ids, rank=r)
            assert g_name == name and local.shape == which.shape
            got.append(local + r * rows)  # the JAX package's global rows
        assert sorted(np.concatenate(got).tolist()) == sorted(
            np.asarray(want_rows).tolist())


def _dispatch_inputs(rng, groups, n, overflow):
    ids, seg, w, dest, valid = [], [], [], [], []
    for _ in range(groups):
        size = int(rng.randint(5, 40))
        ids.append(rng.randint(0, 1000, size).astype(np.int32))
        seg.append(rng.randint(0, B + 1, size).astype(np.int32))
        w.append(rng.rand(size).astype(np.float32))
        hot = rng.randint(0, 2 if overflow else n, size)
        dest.append(hot.astype(np.int32))
        valid.append(rng.rand(size) > 0.2)
    return ids, seg, w, dest, valid


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("n", WORLDS)
def test_moe_dispatch_batched_bitwise(n, overflow):
    """One sort buckets every group by destination: the same ``[N, G,
    cap]`` buffers as the JAX function, bit for bit; with every entry
    bound for ranks 0 and 1 and a small cap, buckets overflow and drop
    the same entries."""
    rng = np.random.RandomState(n + 10 * overflow)
    ids, seg, w, dest, valid = _dispatch_inputs(rng, 5, n, overflow)
    cap = 6 if overflow else 40
    fills = (0, B, 0.0)
    want = jdispatch([jnp.asarray(a) for a in ids],
                     ([jnp.asarray(a) for a in seg],
                      [jnp.asarray(a) for a in w]),
                     [jnp.asarray(a) for a in dest],
                     [jnp.asarray(a) for a in valid], n, cap, fills)
    got = moe_dispatch_batched([torch.from_numpy(a) for a in ids],
                               ([torch.from_numpy(a) for a in seg],
                                [torch.from_numpy(a) for a in w]),
                               [torch.from_numpy(a) for a in dest],
                               [torch.from_numpy(a) for a in valid], n, cap,
                               fills)
    for g, x in zip(got, want):
        assert g.shape == (n, 5, cap)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    kept = int(sum(v.sum() for v in valid))
    assert (got[1] < B).sum() < kept if overflow else (got[1] < B).sum() \
        <= kept


CODECS = [("fp16", 0.02, 0.05), ("bf16", 0.02, 0.05), ("int8", 0.03, 0.08),
          ("fp8", 0.08, 0.15)]


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("prec,rtol,atol", CODECS)
def test_qcomm_codecs_match_jax(prec, rtol, atol, which):
    """The codec of each wire precision (a one-rank exchange, so the
    codec alone) against the JAX codec, and both close to the float32
    payload; int8 and the casts give the JAX bits."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 32) * rng.rand(4, 6, 1) * 3).astype(np.float32)
    x[0, 0] = 0.0  # a zero row keeps scale 1
    ls = 128.0 if which == "bwd" else None
    qc = qcomm.QCommsConfig(qcomm.CommType(prec), qcomm.CommType(prec), ls)
    got = qcomm.qcomm_all_to_all(torch.from_numpy(x),
                                 ShardingEnv(1, 0, torch.device("cpu")), qc,
                                 which).numpy()
    jprec = jqcomm.CommType(prec)
    y = jnp.asarray(x) * ls if ls else jnp.asarray(x)
    if prec in ("fp16", "bf16"):
        want = y.astype(jqcomm._CAST_DTYPES[jprec]).astype(jnp.float32)
    else:
        want = jqcomm._rowwise_dequantize(*jqcomm._rowwise_quantize(y, jprec))
    want = np.asarray(want / ls if ls else want)
    np.testing.assert_allclose(got, x, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if prec != "fp8":
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)  # the code really ran


def test_wire_bytes_per_f32_and_ledger_match_jax():
    for fwd in qcomm.CommType:
        for bwd in qcomm.CommType:
            qc = qcomm.QCommsConfig(fwd, bwd)
            jqc = jqcomm.QCommsConfig(jqcomm.CommType(fwd.value),
                                      jqcomm.CommType(bwd.value))
            for which in ("fwd", "bwd"):
                for dim in (16, 64, 128):
                    assert qcomm.wire_bytes_per_f32(qc, which, dim) == \
                        jqcomm.wire_bytes_per_f32(jqc, which, dim)
    assert qcomm.wire_bytes_per_f32(None, "fwd", 64) == 4.0
    env = ShardingEnv(1, 0, torch.device("cpu"))
    qc = qcomm.QCommsConfig(qcomm.CommType.FP16, qcomm.CommType.INT8)
    x = torch.zeros((1, 3, 64))
    with qcomm.wire_accounting() as ledger:
        qcomm.qcomm_all_to_all(x, env, qc, "fwd", tag="a")
        qcomm.qcomm_psum_scatter(x, env, qc, "bwd", tag="b")
        qcomm.qcomm_all_gather(x[0], env, None, "bwd", tag="c", fanout=4)
        with qcomm.wire_accounting() as inner:
            qcomm.qcomm_all_to_all(x, env, None, "fwd")
    total = 3 * 64 * 2.0 + 3 * 64 * (1 + 2 / 64) + 3 * 64 * 4.0 * 4
    # a one-slice world: every byte is intra-slice, as in the JAX ledger
    assert ledger == {"a": 3 * 64 * 2.0, "b": 3 * 64 * (1 + 2 / 64),
                      "c": 3 * 64 * 4.0 * 4, qcomm.LINK_ICI: total,
                      qcomm.LINK_DCN: 0.0}
    assert inner == {"all_to_all:fwd": 3 * 64 * 4.0,
                     qcomm.LINK_ICI: 3 * 64 * 4.0, qcomm.LINK_DCN: 0.0}
