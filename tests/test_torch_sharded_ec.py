"""The port's sharded EmbeddingCollection across 4 ranks (4 gloo processes
on the CPU, one spawn) against the JAX ``ShardedEmbeddingCollection`` on a
4-device mesh of the conftest's virtual CPU devices, the cases of
``tests/test_sharded_ec.py`` at a world of 4: the per-id rows of the tw,
rw and mixed plans (``torch.equal`` to JAX's and to the port's unsharded
``EmbeddingCollection``: a row gather has no sum), one SGD update with
unit gradients (against JAX within 1e-5), the params round trip, a rank
with an empty batch, and ``index_dedup`` on duplicate-heavy batches
(rows equal to the plain path bit for bit, the update within 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torchrec_tpu.modules.embedding_configs import EmbeddingConfig as JCfg
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.embedding import (
    ShardedEmbeddingCollection as JShardedEC,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_sharding_workers as workers

WORLD, B, LR = 4, 4, 1.0
FEATURES = ["f0", "f1", "f2"]
HASH = {"f0": 120, "f1": 50, "f2": 300}
CAPS = {"f0": 16, "f1": 12, "f2": 16}
TABLES = [{"name": "t0", "rows": 120, "dim": 8, "features": ["f0"]},
          {"name": "t1", "rows": 50, "dim": 8, "features": ["f1"]},
          {"name": "t2", "rows": 300, "dim": 16, "features": ["f2"]}]
ALL = list(range(WORLD))
PLANS = {
    "tw": {"t0": ("table_wise", [2], 1), "t1": ("table_wise", [1], 1),
           "t2": ("table_wise", [0], 1)},
    "rw": {t: ("row_wise", ALL, 1) for t in ("t0", "t1", "t2")},
    "mixed": {"t0": ("row_wise", ALL, 1), "t1": ("data_parallel", None, 1),
              "t2": ("column_wise", [3, 1], 1)},
}
_RNG = np.random.RandomState(0)
WEIGHTS = {t["name"]: _RNG.randn(t["rows"], t["dim"]).astype(np.float32)
           for t in TABLES}


def _kjt_data(rng, id_space=None, min_len=0):
    lengths = np.stack([rng.randint(min_len, 4, size=(B,)).astype(np.int32)
                        for _ in FEATURES]).reshape(-1)
    values = np.concatenate([
        rng.randint(0, id_space or HASH[f],
                    size=(int(lengths[i * B:(i + 1) * B].sum()),))
        for i, f in enumerate(FEATURES)]).astype(np.int64)
    return (FEATURES, values, lengths, None, [CAPS[f] for f in FEATURES])


def _empty():
    return (FEATURES, np.zeros((0,), np.int64),
            np.zeros((len(FEATURES) * B,), np.int32), None,
            [CAPS[f] for f in FEATURES])


def _cases():
    """{case: (plan, index_dedup, per-rank KJT data, step)}."""
    rng = np.random.RandomState(11)
    fwd = [_kjt_data(rng) for _ in range(WORLD)]
    rng = np.random.RandomState(13)
    bwd = [_kjt_data(rng) for _ in range(WORLD)]
    rng = np.random.RandomState(17)
    empty = [_kjt_data(rng) for _ in range(WORLD)]
    empty[3] = _empty()
    rng = np.random.RandomState(21)
    dup = [_kjt_data(rng, id_space=5, min_len=1) for _ in range(WORLD)]
    out = {}
    for kind in PLANS:
        out[f"fwd_{kind}"] = (kind, False, fwd, False)
        for dd in (False, True):
            out[f"dup_{kind}_{dd}"] = (kind, dd, dup, True)
    out["step_mixed"] = ("mixed", False, bwd, True)
    out["empty_mixed"] = ("mixed", False, empty, False)
    return out


def _jax_ec(kind, dedup=False):
    tables = [JCfg(num_embeddings=t["rows"], embedding_dim=t["dim"],
                   name=t["name"], feature_names=t["features"])
              for t in TABLES]
    plan = {n: JPS(JST(st), ranks=r, num_col_shards=c)
            for n, (st, r, c) in PLANS[kind].items()}
    return JShardedEC.build(tables, plan, WORLD, B, CAPS, index_dedup=dedup)


def _jax_run(kind, dedup, kjts, step, mesh):
    """JAX's rows [WORLD, cap, D] by feature and, with ``step``, the
    tables after one SGD update with unit gradients."""
    ec = _jax_ec(kind, dedup)
    params = ec.params_from_tables(WEIGHTS)
    cfg = JFused(optim=JOptim.SGD, learning_rate=LR)
    fused = ec.init_fused_state(cfg)
    specs = ec.param_specs("model")
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[JKJT.from_lengths_packed(*k) for k in kjts])

    def run(params, fused, kjt):
        local = jax.tree.map(lambda x: x[0], kjt)
        outs, ctxs = ec.forward_local(params, local, "model")
        grads = {f: jnp.ones_like(jt.values()) for f, jt in outs.items()}
        p2, _ = ec.backward_and_update_local(params, fused, ctxs, grads, cfg,
                                             "model")
        return {f: jt.values()[None] for f, jt in outs.items()}, p2

    f = jax.jit(jax.shard_map(run, mesh=mesh,
                              in_specs=(specs, specs, P("model")),
                              out_specs=(P("model"), specs),
                              check_vma=False))
    outs, new = f(params, fused, stacked)
    tables = ec.tables_to_weights(new) if step else None
    return ({k: np.asarray(v) for k, v in outs.items()},
            None if tables is None else {k: np.asarray(v)
                                         for k, v in tables.items()})


@pytest.fixture(scope="module")
def world():
    cases = _cases()
    port = launch(workers.ec_rank, WORLD, args=(
        TABLES, PLANS, CAPS, B, WEIGHTS, cases, LR), timeout=120)
    mesh = create_mesh((WORLD,), ("model",), devices=jax.devices()[:WORLD])
    want = {c: _jax_run(kind, dd, kjts, step, mesh)
            for c, (kind, dd, kjts, step) in cases.items()}
    return cases, port, want


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_sequence_forward_matches_jax_and_unsharded(world, kind):
    cases, port, want = world
    case = f"fwd_{kind}"
    for r in range(WORLD):
        rows, _, ref = port[r][case]
        for f in FEATURES:
            np.testing.assert_array_equal(rows[f], want[case][0][f][r],
                                          err_msg=f"{kind} rank {r} {f}")
            np.testing.assert_array_equal(rows[f], ref[f])
            n = int(cases[case][2][r][2][FEATURES.index(f) * B:
                                         (FEATURES.index(f) + 1) * B].sum())
            assert not rows[f][n:].any()  # padding rows zero


def test_sequence_backward_update_matches_jax(world):
    _, port, want = world
    tables = port[0]["step_mixed"][1]
    for t, w in want["step_mixed"][1].items():
        np.testing.assert_allclose(tables[t], w, rtol=0, atol=1e-5,
                                   err_msg=t)
        assert (tables[t] != WEIGHTS[t]).any(), t


def test_sequence_params_round_trip():
    tables = [EmbeddingConfig(num_embeddings=t["rows"],
                              embedding_dim=t["dim"], name=t["name"],
                              feature_names=t["features"]) for t in TABLES]
    for kind in PLANS:
        ec = ShardedEmbeddingCollection.build(
            tables, workers.make_plan(PLANS[kind]), WORLD, B, CAPS)
        jec = _jax_ec(kind)
        stacks = ec.params_from_tables(WEIGHTS, rank=None)
        want = jec.params_from_tables(WEIGHTS)
        for name, s in stacks.items():
            np.testing.assert_array_equal(s.numpy(), np.asarray(want[name]))
        back = ec.tables_to_weights(stacks)
        for name, w in WEIGHTS.items():
            np.testing.assert_array_equal(back[name].numpy(), w,
                                          err_msg=f"{kind}/{name}")


def test_sequence_empty_feature_batch(world):
    """A rank whose batch holds no ids gives all-zero rows and does not
    disturb the others."""
    _, port, want = world
    for r in range(WORLD):
        rows, _, ref = port[r]["empty_mixed"]
        for f in FEATURES:
            np.testing.assert_array_equal(rows[f],
                                          want["empty_mixed"][0][f][r])
            np.testing.assert_array_equal(rows[f], ref[f])
            if r == 3:
                assert not rows[f].any()


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_index_dedup_matches_plain(world, kind):
    """index_dedup on duplicate-heavy batches: the same rows bit for bit,
    and after one update (unit gradients) the same tables within 1e-6, as
    JAX's own test holds them."""
    _, port, want = world
    for r in range(WORLD):
        plain = port[r][f"dup_{kind}_False"][0]
        dedup = port[r][f"dup_{kind}_True"][0]
        for f in FEATURES:
            np.testing.assert_array_equal(dedup[f], plain[f])
            np.testing.assert_array_equal(dedup[f],
                                          want[f"dup_{kind}_True"][0][f][r])
    t_plain = port[0][f"dup_{kind}_False"][1]
    t_dedup = port[0][f"dup_{kind}_True"][1]
    for t, w in want[f"dup_{kind}_True"][1].items():
        np.testing.assert_allclose(t_dedup[t], t_plain[t], rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_dedup[t], w, rtol=0, atol=1e-5)
