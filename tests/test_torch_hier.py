"""The port's two-level ICI/DCN dists (``parallel/sharding/hier.py``) on
4 gloo processes on the CPU as 2 slices x 2 ranks, against the flat dists
on the same ranks and against the JAX package's ``tests/test_hier_sharding.py``
setup on its 2 x 2 CPU mesh (``(dcn, model)``).  One launch
(``tests/torch_hier_workers.py``) runs every check:

* general data (weighted, one MEAN feature, duplicated ids): the
  two-level forward of the row-wise dedup'd features bitwise the flat
  dedup'd dist's, every feature within 1e-5, the tables after one
  rowwise-Adagrad step within rtol 1e-4 / atol 1e-6; each rank's outputs
  within 1e-5 of the JAX package's, and its wire ledger, link classes
  included, equal to the JAX ledger of the same step; the two-level run
  sends fewer DCN bytes and some ICI bytes, the flat run on the
  two-level world both;
* the exact regime (grid weights, SUM): outputs and updated tables
  bitwise flat, dedup on and off, at caps 24 and 16;
* ``hier_factor=1e6`` shows up in ``dedup_overflow``;
* the planner's ``hierarchical=True`` plan trains through the DMP on the
  two-level world with two-level layouts and runs flat on a flat world;
* ``SequenceModelParallel`` refuses a two-level world;

and, on the host with no launch, the bucketed pipeline's two-level guard
(its capacity rule and stage-2 demands) against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JCfg,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection as JSharded,
)
from torchrec_tpu.parallel.qcomm import LINK_DCN, LINK_ICI
from torchrec_tpu.parallel.qcomm import wire_accounting as jwire_accounting
from torchrec_tpu.parallel.sharding.hier import HierTopology as JTopo
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_hier_workers as workers

S, L = 2, 2
WORLD, B = S * L, 4
FEATS = workers.FEATS
ROWS = workers.ROWS
AXES = ("dcn", "model")


def _zipfish(rng, cap, weighted):
    """A few hot ids per feature: heavy duplication."""
    lengths = rng.randint(0, 4, size=(len(FEATS) * B,)).astype(np.int32)
    vals = []
    for i, f in enumerate(FEATS):
        n = int(lengths[i * B:(i + 1) * B].sum())
        hot = rng.randint(0, ROWS[f], size=(3,))
        vals.append(hot[rng.randint(0, len(hot), size=(n,))])
    values = np.concatenate(vals).astype(np.int64)
    w = rng.rand(len(values)).astype(np.float32) if weighted else None
    return (FEATS, values, lengths, w, [cap] * len(FEATS))


def _weights(grid):
    rng = np.random.RandomState(0)
    if grid:  # multiples of 1/64: every sum below is exact in float32
        return {f"t{i}": (rng.randint(-8, 9, size=(ROWS[f], 8)) / 64.0)
                .astype(np.float32) for i, f in enumerate(FEATS)}
    return {f"t{i}": rng.randn(ROWS[f], 8).astype(np.float32)
            for i, f in enumerate(FEATS)}


def _jax_run(hier, kjts, weights, mesh):
    """The JAX package's step of ``tests/test_hier_sharding.py`` (weighted
    general data, dedup on): (outputs [WORLD, B, D], the ledger)."""
    tables = [JCfg(num_embeddings=ROWS[f], embedding_dim=8, name=f"t{i}",
                   feature_names=[f],
                   pooling=JPooling.MEAN if f == "f1" else JPooling.SUM)
              for i, f in enumerate(FEATS)]
    rw = list(range(WORLD))
    plan = {
        "t0": JPS(JST.ROW_WISE, ranks=rw, dedup=True, hier=hier),
        "t1": JPS(JST.ROW_WISE, ranks=rw, dedup=True, hier=hier),
        "t2": JPS(JST.TABLE_ROW_WISE, ranks=[0, 1], dedup=True, hier=hier),
        "t3": JPS(JST.TABLE_WISE, ranks=[1]),
    }
    ebc = JSharded.build(tables, plan, WORLD, B, {f: 24 for f in FEATS},
                         hier_topo=JTopo("dcn", "model", S, L))
    params = ebc.params_from_tables(weights)
    cfg = JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=0.05)
    fused = ebc.init_fused_state(cfg)
    specs = ebc.param_specs(AXES)
    fspecs = {n: {k: (P() if v.ndim == 0 else specs[n])
                  for k, v in st.items()} for n, st in fused.items()}
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[JKJT.from_lengths_packed(*k) for k in kjts])

    def step(params, fused, kjt):
        local = jax.tree.map(lambda x: x[0], kjt)
        outs, ctxs = ebc.forward_local(params, local, AXES)
        ebc.backward_and_update_local(
            params, fused, ctxs, {f: 2.0 * o for f, o in outs.items()}, cfg,
            AXES)
        return {f: o[None] for f, o in outs.items()}

    f = jax.jit(jax.shard_map(step, mesh=mesh,
                              in_specs=(specs, fspecs, P(AXES)),
                              out_specs=P(AXES), check_vma=False))
    with jwire_accounting() as ledger:
        jax.eval_shape(f, params, fused, stacked)
    outs = f(params, fused, stacked)
    return {k: np.asarray(v) for k, v in outs.items()}, dict(ledger)


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(11)
    general = [_zipfish(rng, 24, True) for _ in range(WORLD)]
    exact = {}
    for dedup, cap in ((True, 24), (False, 16)):
        erng = np.random.RandomState(5 + cap)
        exact[(dedup, cap)] = [_zipfish(erng, cap, False)
                               for _ in range(WORLD)]
    lengths = np.full((len(FEATS) * B,), 3, np.int32)
    values = np.concatenate([np.arange(3 * B) % ROWS[f] for f in FEATS])
    overflow = (FEATS, values.astype(np.int64), lengths, None,
                [24] * len(FEATS))
    port = launch(workers.hier_rank, WORLD,
                  args=(_weights(False), _weights(True), general, exact,
                        [overflow] * WORLD), timeout=240)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(S, L), AXES)
    want = {mode: _jax_run(mode == "hier", general, _weights(False), mesh)
            for mode in ("flat", "hier")}
    return port, want


def test_hier_forward_bitwise_flat_dedup_and_ledger_as_jax(world):
    port, want = world
    for r, res in enumerate(port):
        flat, hier = res["general"]["flat"], res["general"]["hier"]
        assert flat[2] == 0 and hier[2] == 0
        assert "rw_hier_dedup_d8" in hier[4] and (
            "twrw_hier_dedup_d8" in hier[4])
        for f in ("f0", "f1"):  # the row-wise dedup'd features: bitwise
            np.testing.assert_array_equal(flat[0][f], hier[0][f])
        for f in FEATS:
            np.testing.assert_allclose(flat[0][f], hier[0][f], rtol=1e-5,
                                       atol=1e-6, err_msg=f)
            for mode, got in (("flat", flat), ("hier", hier)):
                np.testing.assert_allclose(
                    got[0][f], want[mode][0][f][r], rtol=1e-5, atol=1e-5,
                    err_msg=f"{mode} rank {r} {f} vs JAX")
        for t in flat[1]:
            np.testing.assert_allclose(flat[1][t], hier[1][t], rtol=1e-4,
                                       atol=1e-6, err_msg=t)
        for mode, got in (("flat", flat), ("hier", hier)):
            assert got[3] == pytest.approx(want[mode][1]), (mode, r)
        assert hier[3][LINK_DCN] < flat[3][LINK_DCN]
        assert hier[3][LINK_ICI] > 0
        assert flat[3][LINK_DCN] > 0 and flat[3][LINK_ICI] > 0


@pytest.mark.parametrize("key", [(True, 24), (False, 16)],
                         ids=["dedup_cap24", "plain_cap16"])
def test_hier_exact_regime_bitwise(world, key):
    port, _ = world
    for res in port:
        flat, hier = res["exact"][key]["flat"], res["exact"][key]["hier"]
        assert flat[2] == 0 and hier[2] == 0
        for f in FEATS:
            np.testing.assert_array_equal(flat[0][f], hier[0][f], err_msg=f)
        for t in flat[1]:
            np.testing.assert_array_equal(flat[1][t], hier[1][t], err_msg=t)


def test_hier_overflow_counted(world):
    port, _ = world
    assert all(res["overflow"] > 0 for res in port)


def test_plan_portability_and_sequence_refusal(world):
    port, _ = world
    for res in port:
        flags, runs = res["portability"]
        assert any(flags)
        losses_h, names_h, hier_h = runs["hier"]
        losses_f, names_f, hier_f = runs["flat"]
        assert any(hier_h) and not any(hier_f), (names_h, names_f)
        assert np.isfinite(losses_h).all() and np.isfinite(losses_f).all()
        assert losses_h[-1] < losses_h[0]
        np.testing.assert_allclose(losses_h, losses_f, rtol=1e-4)
        assert res["smp_refused"]


def test_pipeline_hier_guard_matches_jax():
    """The bucketed pipeline's two-level guard on the host: a two-level
    row-wise layout's DCN capacity at other caps (``_hier_cap_for_caps``)
    and the ``[slices, world]`` stage-2 demands (``_hier_union_sizes``)
    equal the JAX package's on the same batches; the port's ranks each
    measure their own batch and the sums over ranks, which the pipeline
    all-gathers, bound the union of a slice's batches from above, never
    below (a max over ranks would)."""
    from types import SimpleNamespace

    from torchrec_tpu.parallel import train_pipeline as jtp
    from torchrec_tpu.parallel.sharding.common import FeatureSpec as JSpec
    from torchrec_tpu.parallel.sharding.rw import build_rw_layout as jbuild
    from torchrec_tpu_torch.modules.embedding_configs import PoolingType
    from torchrec_tpu_torch.parallel import train_pipeline as tp
    from torchrec_tpu_torch.parallel.sharding.common import FeatureSpec
    from torchrec_tpu_torch.parallel.sharding.hier import HierTopology
    from torchrec_tpu_torch.parallel.sharding.rw import build_rw_layout
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT

    feats = [("f0", 64), ("f1", 40)]
    specs = [FeatureSpec(f, f"t{f}", r, 8, PoolingType.SUM, 24)
             for f, r in feats]
    jspecs = [JSpec(f, f"t{f}", r, 8, JPooling.SUM, 24) for f, r in feats]
    for dedup, factor in ((True, 1.0), (False, 4.0)):
        lay = build_rw_layout("rw_hier", specs, WORLD, B, dedup=dedup,
                              hier=HierTopology(S, L), hier_factor=factor)
        jlay = jbuild("rw_hier", jspecs, WORLD, B, dedup=dedup,
                      hier=JTopo("dcn", "model", S, L), hier_factor=factor)
        assert (lay.hier_cap, lay.id_wire_bytes()) == (
            jlay.hier_cap, jlay.id_wire_bytes())
        for caps in ({"f0": 8, "f1": 16}, {"f0": 24, "f1": 2}):
            assert tp._hier_cap_for_caps(lay, caps) == \
                jtp._hier_cap_for_caps(jlay, caps)
    rng = np.random.RandomState(3)
    data = []
    for _ in range(WORLD):
        lengths = rng.randint(0, 5, size=(2 * B,)).astype(np.int32)
        n0, n1 = int(lengths[:B].sum()), int(lengths[B:].sum())
        values = np.concatenate([rng.randint(0, 64, n0),
                                 rng.randint(0, 40, n1)]).astype(np.int64)
        data.append((["f0", "f1"], values, lengths, None, [24, 24]))
    port = [SimpleNamespace(sparse_features=TKJT.from_lengths_packed(*d))
            for d in data]
    jax_ = [SimpleNamespace(sparse_features=JKJT.from_lengths_packed(*d))
            for d in data]
    want = jtp._hier_union_sizes(jlay, jax_, 0)
    np.testing.assert_array_equal(tp._hier_union_sizes(lay, port, 0), want)
    summed = sum(tp._hier_union_sizes(lay, [b], r)
                 for r, b in enumerate(port))
    assert (summed >= want).all() and (summed > want).any()
    assert summed.max() > max(
        tp._hier_union_sizes(lay, [b], r).max() for r, b in enumerate(port))
