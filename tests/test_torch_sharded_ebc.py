"""The port's sharded EmbeddingBagCollection across 4 ranks (4 gloo
processes on the CPU, ``parallel/multiprocess.launch``) against the JAX
``ShardedEmbeddingBagCollection`` on a 4-device mesh of the conftest's
virtual CPU devices, every plan kind of ``tests/test_sharded_ebc.py``
(tw, cw, rw, twrw, grid, dp, mixed) at a world of 4: each rank's pooled
outputs, the tables after one fused SGD step from each rank's gradients,
and the wire-byte ledger; and against the port's unsharded
EmbeddingBagCollection on each rank's batch.  One spawn covers every
plan.  A negative control reads rank 1's row-wise stack off by one row
and must fail the comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection as JSharded,
)
from torchrec_tpu.parallel.qcomm import LINK_TAGS
from torchrec_tpu.parallel.qcomm import wire_accounting as jwire_accounting
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_sharding_workers as workers

WORLD, B, LR = 4, 4, 0.5
TABLES = [
    {"name": "t0", "rows": 100, "dim": 8, "features": ["f0", "f1"],
     "pooling": "SUM"},
    {"name": "t1", "rows": 64, "dim": 8, "features": ["f2"],
     "pooling": "MEAN"},
    {"name": "t2", "rows": 200, "dim": 16, "features": ["f3"],
     "pooling": "SUM"},
]
FEATURES = ["f0", "f1", "f2", "f3"]
CAPS = {"f0": 24, "f1": 16, "f2": 16, "f3": 24}
HASH = {"f0": 100, "f1": 100, "f2": 64, "f3": 200}
DIMS = {"f0": 8, "f1": 8, "f2": 8, "f3": 16}
ALL = list(range(WORLD))
TW, CW, RW = "table_wise", "column_wise", "row_wise"
TWRW, GRID, DP = "table_row_wise", "grid_shard", "data_parallel"
# the plans of tests/test_sharded_ebc.py at a world of 4
PLANS = {
    "tw": {"t0": (TW, [1], 1), "t1": (TW, [3], 1), "t2": (TW, [2], 1)},
    "cw": {"t0": (CW, [0, 3], 1), "t1": (TW, [2], 1),
           "t2": (CW, [1, 1], 1)},
    "rw": {t["name"]: (RW, ALL, 1) for t in TABLES},
    "mixed": {"t0": (RW, ALL, 1), "t1": (TW, [3], 1),
              "t2": (CW, [1, 2], 1)},
    "dp": {"t0": (DP, None, 1), "t1": (DP, None, 1), "t2": (TW, [0], 1)},
    "twrw": {"t0": (TWRW, [2, 3], 1), "t1": (TWRW, ALL, 1),
             "t2": (TW, [1], 1)},
    "grid": {"t0": (TWRW, [0, 1], 1), "t1": (DP, None, 1),
             "t2": (GRID, ALL, 2)},
}
SHIFTED = "rw_shifted"  # the negative control: rw, rank 1 off by one row
# pooled on one rank in the KJT's slot order: bitwise equal to the
# unsharded collection (but for MEAN with weights: the sharded source
# weight is w / length, the collection's (1 / length) * w)
BITWISE = ("tw", "cw", "dp")


def _kjt_data(rng):
    lengths = np.stack([rng.randint(0, 5, size=(B,)).astype(np.int32)
                        for _ in FEATURES]).reshape(-1)
    values = np.concatenate([
        rng.randint(0, HASH[f], size=(int(lengths[i * B:(i + 1) * B].sum()),))
        for i, f in enumerate(FEATURES)]).astype(np.int64)
    w = rng.rand(values.shape[0]).astype(np.float32)
    return (FEATURES, values, lengths, w, [CAPS[f] for f in FEATURES])


def _jax_run(kind, weights, kjts, grads, mesh):
    """The JAX side of one plan: (pooled outputs by feature [WORLD, B, D],
    tables after one fused SGD step, the ledger of the step's trace)."""
    tables = [JCfg(num_embeddings=t["rows"], embedding_dim=t["dim"],
                   name=t["name"], feature_names=t["features"],
                   pooling=JPooling(t["pooling"])) for t in TABLES]
    plan = {n: JPS(JST(st), ranks=r, num_col_shards=c)
            for n, (st, r, c) in PLANS[kind].items()}
    ebc = JSharded.build(tables, plan, WORLD, B, CAPS)
    params = ebc.params_from_tables(weights)
    cfg = JFused(optim=JOptim.SGD, learning_rate=LR)
    fused = ebc.init_fused_state(cfg)
    specs = ebc.param_specs("model")
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[JKJT.from_lengths_packed(*k) for k in kjts])
    g = {f: jnp.stack([jnp.asarray(grads[r][f]) for r in range(WORLD)])
         for f in FEATURES}

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
    with jwire_accounting() as ledger:
        outs, new_params = f(params, fused, stacked, g)
    new = ebc.tables_to_weights(new_params)
    return ({k: np.asarray(v) for k, v in outs.items()},
            {k: np.asarray(v) for k, v in new.items()},
            dict(ledger))


_RNG = np.random.RandomState(0)
WEIGHTS = {t["name"]: _RNG.randn(t["rows"], t["dim"]).astype(np.float32)
           for t in TABLES}


@pytest.fixture(scope="module")
def world():
    """Every plan through the port's 4 ranks (one spawn) and through
    JAX."""
    rng = np.random.RandomState(1)
    weights = WEIGHTS
    krng = np.random.RandomState(42)
    kjts = [_kjt_data(krng) for _ in range(WORLD)]
    grads = [{f: (rng.randn(B, DIMS[f]) * 0.1).astype(np.float32)
              for f in FEATURES} for _ in range(WORLD)]
    plans = {**PLANS, SHIFTED: PLANS["rw"]}
    port = launch(workers.ebc_rank, WORLD,
                  args=(TABLES, plans, CAPS, B, weights, kjts, grads, LR,
                        SHIFTED), timeout=120)
    mesh = create_mesh((WORLD,), ("model",))
    want = {kind: _jax_run(kind, weights, kjts, grads, mesh)
            for kind in PLANS}
    return port, want


def test_sharded_ebc_matches_jax_and_unsharded(world):
    port, want = world
    for kind in PLANS:
        j_outs, j_tables, j_ledger = want[kind]
        for r, (got, ref) in enumerate(port):
            outs, _, ledger, dedup = got[kind]
            if kind in ("tw", "dp"):  # the dedup kernels at 4 ranks
                assert dedup[0] and dedup[1] <= 1e-6, (kind, r, dedup)
            for f in FEATURES:
                np.testing.assert_allclose(
                    outs[f], j_outs[f][r], rtol=1e-5, atol=1e-5,
                    err_msg=f"{kind} rank {r} {f} vs JAX")
                if kind in BITWISE and f != "f2":
                    np.testing.assert_array_equal(
                        outs[f], ref[f], err_msg=f"{kind} rank {r} {f}")
                else:
                    np.testing.assert_allclose(
                        outs[f], ref[f], rtol=1e-5, atol=1e-5,
                        err_msg=f"{kind} rank {r} {f} vs unsharded")
            # the JAX package's DP all-reduce is not in its ledger; the
            # port's DP all-gathers are, under their group's tag and in the
            # ICI class (a flat world: every byte intra-slice, in both)
            dp = sum(v for k, v in ledger.items() if k.startswith("dp_"))
            got = {k: v for k, v in ledger.items() if not k.startswith("dp_")}
            got[LINK_TAGS[0]] -= dp
            assert got == pytest.approx(j_ledger), (kind, r)
            assert ledger[LINK_TAGS[1]] == j_ledger[LINK_TAGS[1]] == 0
        tables = port[0][0][kind][1]
        for t, w in j_tables.items():
            np.testing.assert_allclose(tables[t], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{kind} {t} after SGD")
        assert any((tables[t] != w).any() for t, w in WEIGHTS.items())


def test_negative_control_offset_row_fails(world):
    """Rank 1's row-wise stack read one row off: its pooled outputs no
    longer match JAX's, so the comparison above would fail."""
    port, want = world
    j_outs = want["rw"][0]
    with pytest.raises(AssertionError):
        for r, (got, _) in enumerate(port):
            for f in FEATURES:
                np.testing.assert_allclose(got[SHIFTED][0][f], j_outs[f][r],
                                           rtol=1e-5, atol=1e-5)


def test_launch_stops_the_world_on_a_failed_rank():
    """A rank that raises stops the launch: the others, waiting on it in
    a collective, are stopped, and the error carries its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(workers.failing_rank, 2, timeout=60)


def test_concurrent_launches_keep_their_own_stores():
    """Two launches at once, each with the store its launcher bound: each
    group holds its own ranks only."""
    import threading

    out = {}

    def run(tag):
        out[tag] = launch(workers.tag_rank, 2, args=(tag,), timeout=60)

    threads = [threading.Thread(target=run, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == {t: [(r, [t, t]) for r in range(2)] for t in (1, 2)}


# the data-parallel groups' every-row update: optimizers whose zero-gradient
# step is not the identity (Adam's momentum, SGD's weight decay); two ranks
# over three steps, each step touching other rows
DP_TABLES = [{"name": "d0", "rows": 8, "dim": 4, "features": ["g0"],
              "pooling": "SUM"},
             {"name": "d1", "rows": 24, "dim": 4, "features": ["g1"],
              "pooling": "SUM"},
             {"name": "s0", "rows": 16, "dim": 8, "features": ["g2"],
              "pooling": "SUM"}]
DP_PLAN = {"d0": (DP, None, 1), "d1": (DP, None, 1), "s0": (TW, [1], 1)}
DP_CAPS = {"g0": 4, "g1": 4, "g2": 4}
DP_CONFIGS = [("adam", 0.1, 0.0), ("sgd", 0.1, 0.1),
              ("rowwise_adagrad", 0.1, 0.0)]
DP_WORLD, DP_B, DP_STEPS = 2, 2, 3


def _dp_kjts(step):
    """Step ``step``'s KJT on each of the two ranks: one id an example,
    the rows {2s + 1, 2s + 2} of each table (step 0: rows 1 and 2, step
    1: rows 3 and 4, ...), so no row is touched twice and row 0 never."""
    out = []
    for r in range(DP_WORLD):
        ids = [2 * step + 1 + r] * DP_B
        values = np.asarray(ids * 3, np.int64)
        lengths = np.ones(3 * DP_B, np.int32)
        out.append((["g0", "g1", "g2"], values, lengths, None,
                    [DP_CAPS[f] for f in ("g0", "g1", "g2")]))
    return out


def _dp_jax(optim, lr, wd, weights, kjts, grads):
    tables = [JCfg(num_embeddings=t["rows"], embedding_dim=t["dim"],
                   name=t["name"], feature_names=t["features"],
                   pooling=JPooling(t["pooling"])) for t in DP_TABLES]
    plan = {n: JPS(JST(st), ranks=r, num_col_shards=c)
            for n, (st, r, c) in DP_PLAN.items()}
    ebc = JSharded.build(tables, plan, DP_WORLD, DP_B, DP_CAPS)
    mesh = create_mesh((DP_WORLD,), ("model",),
                       devices=jax.devices()[:DP_WORLD])
    cfg = JFused(optim=JOptim(optim), learning_rate=lr, weight_decay=wd)
    params, fused = ebc.params_from_tables(weights), ebc.init_fused_state(cfg)
    specs = ebc.param_specs("model")
    fspecs = {n: {k: (P() if v.ndim == 0 else specs[n])
                  for k, v in st.items()} for n, st in fused.items()}

    def step(params, fused, kjt, g):
        local = jax.tree.map(lambda x: x[0], kjt)
        _, ctxs = ebc.forward_local(params, local, "model")
        return ebc.backward_and_update_local(
            params, fused, ctxs, {f: v[0] for f, v in g.items()}, cfg,
            "model")

    f = jax.jit(jax.shard_map(step, mesh=mesh,
                              in_specs=(specs, fspecs, P("model"),
                                        P("model")),
                              out_specs=(specs, fspecs), check_vma=False))
    for s in range(DP_STEPS):
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *[JKJT.from_lengths_packed(*k)
                                 for k in kjts[s]])
        g = {f: jnp.stack([jnp.asarray(grads[s][r][f])
                           for r in range(DP_WORLD)])
             for f in grads[s][0]}
        params, fused = f(params, fused, stacked, g)
    return {k: np.asarray(v) for k, v in ebc.tables_to_weights(params).items()}


def test_dp_groups_step_every_row_as_jax():
    """Every row of a data-parallel group takes the optimizer step each
    step, as the JAX package's all-reduced dense update does: under Adam a
    row touched once keeps moving on its momentum, and under SGD with
    weight decay every row decays, row 0 (never touched) included.  The
    port against the JAX ``ShardedEmbeddingBagCollection`` over 2 ranks
    and 3 steps, within 1e-5, the sharded tests' tolerance (the port runs
    B2's op order and sums each row's gradients in slot order, JAX its XLA
    update after a segment sum and a psum; Adam's division by sqrt(v)
    carries that rounding to 1.5e-6)."""
    rng = np.random.RandomState(3)
    weights = {t["name"]: rng.randn(t["rows"], t["dim"]).astype(np.float32)
               for t in DP_TABLES}
    dims = {"g0": 4, "g1": 4, "g2": 8}
    kjts = [_dp_kjts(s) for s in range(DP_STEPS)]
    grads = [[{f: rng.randn(DP_B, d).astype(np.float32)
               for f, d in dims.items()} for _ in range(DP_WORLD)]
             for _ in range(DP_STEPS)]
    port = launch(workers.dp_every_row_rank, DP_WORLD, args=(
        DP_TABLES, DP_PLAN, DP_CAPS, DP_B, weights, kjts, grads,
        DP_CONFIGS), timeout=120)[0]
    for (optim, lr, wd), got in zip(DP_CONFIGS, port):
        want = _dp_jax(optim, lr, wd, weights, kjts, grads)
        for t, w in want.items():
            np.testing.assert_allclose(got[t], w, rtol=0, atol=1e-5,
                                       err_msg=f"{optim} wd={wd} {t}")
        if wd:  # row 0, never touched, decays
            assert (got["d0"][0] != weights["d0"][0]).all(), optim
