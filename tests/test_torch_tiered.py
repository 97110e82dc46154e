"""Tiered training in the port (``torchrec_tpu_torch/tiered/``,
``checkpoint.py``'s ``tiered=``, the loop's quiesce and NaN-step revert)
against the JAX package's ``TieredTrainPipeline`` and against the port's
own all-device runs.

A DLRM whose table ``big`` (512 rows) trains through a cache of 48 slots
(more than 10x smaller), Zipf(1.2) ids, one rank on the CPU (the plain
versions of the kernels).  Tolerances:

* the port against its own all-device run (``BucketedTrainPipeline`` on
  the same kernels), prefetch on and off: bitwise (``==`` on the losses,
  ``np.array_equal`` / ``torch.equal`` on every logical row, slot and
  dense parameter);
* the port against the JAX package from the same start state: losses
  within ``rtol=1e-5``, tables within ``atol=2e-6`` and slots within
  ``rtol=1e-5`` (``tests/test_torch_dlrm_train.py``'s), and the cache
  maps (the resident id -> slot dicts and every ``TieredIO`` plan)
  exactly equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.checkpoint import Checkpointer as JCheckpointer
from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.inference import serving as jserving
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.ops.embedding_ops import trace_kernels
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import MODEL_AXIS
from torchrec_tpu.parallel.comm import ShardingEnv as JEnv
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.model_parallel import (
    DistributedModelParallel as JDMP,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.reliability import FaultTolerantTrainLoop as JLoop
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.tiered import TieredCollection as JCollection
from torchrec_tpu.tiered import TieredTable as JTable
from torchrec_tpu.tiered import TieredTrainPipeline as JPipeline
from torchrec_tpu.tiered import storage as jstorage
from torchrec_tpu_torch.checkpoint import Checkpointer
from torchrec_tpu_torch.convert import (
    checkpoint_payload_from_jax,
    train_state_from_jax,
)
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.planner import (
    EmbeddingShardingPlanner,
    ParameterConstraints,
)
from torchrec_tpu_torch.parallel.train_pipeline import (
    BucketedTrainPipeline,
    BucketingConfig,
)
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    ParameterSharding,
    ShardingType,
    table_wise_plan,
)
from torchrec_tpu_torch.reliability import FaultTolerantTrainLoop
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor
from torchrec_tpu_torch.tiered import (
    TieredCollection,
    TieredTable,
    TieredTrainPipeline,
    opt_slot_widths,
    tiered_tables_from_plan,
)

B, D, LR = 16, 8, 0.05
LOGICAL, CACHE, SIDE = 512, 48, 64
CAPS = {"q": 2 * B, "r": 3 * B}
KERNELS = {"pooled": "dedup", "update": "dedup"}
LOSS_RTOL, TABLE_ATOL, SLOT_RTOL = 1e-5, 2e-6, 1e-5


def _fc(optim=EmbOptimType.ADAGRAD):
    return FusedOptimConfig(optim=optim, learning_rate=LR)


def _tables(big_rows):
    return (EmbeddingBagConfig(num_embeddings=big_rows, embedding_dim=D,
                               name="big", feature_names=["q"]),
            EmbeddingBagConfig(num_embeddings=SIDE, embedding_dim=D,
                               name="side", feature_names=["r"]))


def _dmp(big_rows, plan=None, fc=None):
    tables = _tables(big_rows)
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), 4, (8, D), (8, 1)), tables,
        plan or table_wise_plan(tables), B, CAPS, fused_config=fc or _fc(),
        dense_optimizer=adagrad(LR), device="cpu")


def _stream(seed, n):
    """``n`` batches as numpy (dense, q ids, r ids, labels): Zipf(1.2) ids
    of the tiered key, two ids a feature an example."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = (rng.zipf(1.2, size=2 * B) - 1) % LOGICAL
        r = rng.randint(0, SIDE, size=2 * B)
        out.append((rng.rand(B, 4).astype(np.float32), q.astype(np.int64),
                    r.astype(np.int64),
                    rng.randint(0, 2, size=(B,)).astype(np.float32)))
    return out


def _port_batches(raw):
    lens = np.full((2 * B,), 2, np.int32)
    return [Batch(torch.from_numpy(d), KeyedJaggedTensor.from_lengths_packed(
        ["q", "r"], torch.from_numpy(np.concatenate([q, r])),
        torch.from_numpy(lens), caps=[CAPS["q"], CAPS["r"]]),
        torch.from_numpy(y)) for d, q, r, y in raw]


def _jax_batches(raw):
    lens = np.full((2 * B,), 2, np.int32)
    return [JBatch(jnp.asarray(d), JKJT.from_lengths_packed(
        ["q", "r"], np.concatenate([q, r]), lens,
        caps=[CAPS["q"], CAPS["r"]]), jnp.asarray(y)) for d, q, r, y in raw]


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's LRU id transformer (``csrc/id_transformer.cpp``)
    built with g++ into a private directory and bound under its ``trec_``
    names, loaded by the JAX tables in place of ``csrc_build``."""
    import ctypes
    import subprocess

    from torchrec_tpu_torch.ops import _native

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path_factory.mktemp("jax_native") / "libjax.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    out, os.path.join(root, "csrc", "id_transformer.cpp"),
                    "-lpthread"], check=True, capture_output=True)
    lib = ctypes.CDLL(out, mode=ctypes.RTLD_GLOBAL)
    for name, (argtypes, restype) in _native._HOST_SIGNATURES.items():
        jname = name.replace("trt_", "trec_")
        if hasattr(lib, jname):
            fn = getattr(lib, jname)
            fn.argtypes, fn.restype = list(argtypes), restype
    mp = pytest.MonkeyPatch()
    mp.setattr(jserving, "load_native", lambda: lib)
    try:
        yield lib
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def world():
    """The all-device start: the full table's initial rows and the dense
    parameters every run of this file starts from."""
    full = _dmp(LOGICAL)
    st = full.init(torch.Generator().manual_seed(0))
    w0 = {k: np.array(v) for k, v in full.table_weights(st).items()}
    dense0 = {k: v.clone() for k, v in st["dense"].items()}
    return w0, dense0


def _all_device(world, raw, skip=None):
    """The all-device bucketed run on the dedup kernels over ``raw``
    (``skip``: a batch left out); returns (losses, dmp, state)."""
    w0, dense0 = world
    full = _dmp(LOGICAL)
    st = full.init(torch.Generator().manual_seed(0))
    st["dense"] = {k: v.clone() for k, v in dense0.items()}
    st["dense_opt"] = full.dense_tx.init(st["dense"])
    full.load_table_weights(st, w0)
    pipe = BucketedTrainPipeline(full, st, BucketingConfig(kernels=KERNELS))
    it = iter([b for i, b in enumerate(_port_batches(raw)) if i != skip])
    losses = []
    while True:
        try:
            losses.append(float(pipe.progress(it)["loss"]))
        except StopIteration:
            return losses, full, pipe.state


def _tiered_world(world, prefetch=True, fc=None, tables_fn=None):
    w0, dense0 = world
    fc = fc or _fc()
    dmp = _dmp(CACHE, fc=fc)
    st = dmp.init(torch.Generator().manual_seed(0))
    st["dense"] = {k: v.clone() for k, v in dense0.items()}
    st["dense_opt"] = dmp.dense_tx.init(st["dense"])
    dmp.load_table_weights(st, {"side": w0["side"],
                                "big": np.zeros((CACHE, D), np.float32)})
    tables = (tables_fn() if tables_fn else {"big": TieredTable(
        "big", LOGICAL, D, CACHE, opt_slots=opt_slot_widths(fc, D),
        init_fn=lambda s, e: w0["big"][s:e])})
    coll = TieredCollection(tables, {"q": "big"})
    pipe = TieredTrainPipeline(dmp, st, coll, BucketingConfig(kernels=KERNELS),
                               prefetch=prefetch)
    return dmp, coll, pipe


def _drain_losses(progress, it):
    out = []
    while True:
        try:
            out.append(float(progress(it)["loss"]))
        except StopIteration:
            return out


def _state_equal(dmp_a, st_a, coll_a, dmp_b, st_b, coll_b=None):
    """Every logical row and slot of ``big``, the side table and its
    slots, the dense parameters: bitwise."""
    rows_a = coll_a.logical_table_rows(dmp_a, st_a, "big")
    if coll_b is not None:
        rows_b = coll_b.logical_table_rows(dmp_b, st_b, "big")
    else:
        rows_b = dmp_b.gather_row_state(st_b, "big", np.arange(LOGICAL),
                                        coll_a.tables["big"].opt_slots)
    side = np.arange(SIDE)
    slots = coll_a.tables["big"].opt_slots
    return (np.array_equal(rows_a, rows_b)
            and np.array_equal(dmp_a.gather_row_state(st_a, "side", side,
                                                      slots),
                               dmp_b.gather_row_state(st_b, "side", side,
                                                      slots))
            and all(torch.equal(st_a["dense"][k], st_b["dense"][k])
                    for k in st_a["dense"]))


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch",
                                                         "no_prefetch"])
def test_tiered_bitexact_vs_all_device(world, prefetch):
    """A table more than 10x its cache trains through the tiered pipeline
    bit for bit like the all-device run: every loss, every logical row
    and Adagrad slot, the side table and the dense parameters; the run
    evicts, writes back, hits and misses."""
    raw = _stream(42, 10)
    losses_f, full, st_f = _all_device(world, raw)
    dmp, coll, pipe = _tiered_world(world, prefetch)
    losses_t = _drain_losses(pipe.progress, iter(_port_batches(raw)))
    m = pipe.scalar_metrics()
    pipe.close()
    assert losses_t == losses_f
    assert _state_equal(dmp, pipe.state, coll, full, st_f)
    assert m["tiered/big/eviction_count"] > 0
    assert m["tiered/big/writeback_rows"] > 0
    assert 0.0 < m["tiered/big/hit_rate"] < 1.0
    assert (m["tiered/big/staged_rows"] > 0) == prefetch
    assert coll.pending_io_groups == 0


def test_corrupt_ids_never_claim_slots():
    """Out-of-range and negative ids are nulled (slot 0, weight 0) before
    the remap: they claim no slot, evict nothing, count as violations."""
    tt = TieredTable("big", 100, 4, 8, eviction_policy="lru")
    coll = TieredCollection({"big": tt}, {"q": "big"})
    clean = KeyedJaggedTensor.from_lengths_packed(
        ["q"], torch.tensor([1, 2, 3, 4]), torch.tensor([2, 2]), caps=[4])
    coll.process(clean)
    before = dict(tt._resident)
    bad = KeyedJaggedTensor.from_lengths_packed(
        ["q"], torch.tensor([-5, 1000, 999999, -1]), torch.tensor([2, 2]),
        caps=[4])
    kjt, ios = coll.process(bad)
    assert tt._resident == before
    assert len(ios["big"].fetch_slots) == len(ios["big"].writeback_slots) == 0
    assert kjt.values().tolist() == [0, 0, 0, 0]
    assert kjt.weights_or_none().tolist() == [0.0, 0.0, 0.0, 0.0]
    assert coll.stats.per_table["big"]["id_violations"] == 4
    coll.sanitize = False
    with pytest.raises(ValueError, match="out-of-range"):
        coll.process(bad)


def test_drain_checkpoint_resume_equals_uninterrupted(world, tmp_path):
    """A checkpoint mid-lookahead raises; drain + checkpoint + a fresh
    world restored from it (host tier and device state) and run over the
    rest of the stream ends bitwise where the uninterrupted run ends; the
    loop's interval saves drain first."""
    raw = _stream(99, 10)
    batches = _port_batches(raw)
    dmp, coll, pipe = _tiered_world(world)
    ck = Checkpointer(str(tmp_path / "ck"), tiered=coll)
    it = iter(batches)
    for _ in range(4):
        pipe.progress(it)
    assert coll.pending_io_groups > 0
    with pytest.raises(RuntimeError, match="mid-lookahead"):
        ck.save(dmp, pipe.state)
    with pytest.raises(RuntimeError, match="drain"):
        pipe.invalidate_prefetch()
    drained = len(pipe.drain())
    assert coll.pending_io_groups == 0
    ck.save(dmp, pipe.state)
    step = int(pipe.state["step"])
    assert step == 4 + drained
    _drain_losses(pipe.progress, it)
    pipe.close()

    dmp2, coll2, pipe2 = _tiered_world(world)
    ck2 = Checkpointer(str(tmp_path / "ck"), tiered=coll2)
    pipe2.state = ck2.restore(dmp2, step)
    pipe2.invalidate_prefetch()
    assert coll2.tables["big"].occupancy == 0  # restored cold
    _drain_losses(pipe2.progress, iter(batches[step:]))
    pipe2.close()
    assert _state_equal(dmp, pipe.state, coll, dmp2, pipe2.state, coll2)

    # the loop quiesces before its interval and final saves
    dmp3, coll3, pipe3 = _tiered_world(world)
    loop = FaultTolerantTrainLoop(
        pipe3, Checkpointer(str(tmp_path / "ck3"), tiered=coll3), dmp3,
        checkpoint_interval=3)
    summary = loop.run(iter(batches))
    pipe3.close()
    assert summary["final_step"] == 10 and summary["skipped_steps"] == 0
    assert _state_equal(dmp, pipe.state, coll, dmp3, pipe3.state, coll3)
    # a Checkpointer without the collection refuses a tiered checkpoint
    with pytest.raises(ValueError, match="tiered"):
        Checkpointer(str(tmp_path / "ck3")).restore(dmp3, 10)


# -- against the JAX package --------------------------------------------------


def _jax_world(jstate_start, w0, optim=JOptim.ADAGRAD):
    tables = tuple(JCfg(num_embeddings=r, embedding_dim=D, name=n,
                        feature_names=[f], pooling=JPooling.SUM)
                   for r, n, f in ((CACHE, "big", "q"), (SIDE, "side", "r")))
    env = JEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,)))
    dmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=4,
            dense_arch_layer_sizes=(8, D), over_arch_layer_sizes=(8, 1)),
        tables=tables, env=env,
        plan={t.name: JPS(JST.TABLE_WISE, ranks=[0]) for t in tables},
        batch_size_per_device=B, feature_caps=CAPS, dense_in_features=4,
        fused_config=JFused(optim=optim, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))
    state = jstate_start if jstate_start is not None else dmp.init(
        jax.random.key(0))
    tt = JTable("big", LOGICAL, D, CACHE,
                opt_slots=jstorage.opt_slot_widths(
                    JFused(optim=optim, learning_rate=LR), D),
                init_fn=lambda s, e: w0[s:e], eviction_policy="lru")
    coll = JCollection({"big": tt}, {"q": "big"})
    return env, dmp, state, coll


def _port_from_jax(jstate, w0, fc=None):
    """The port's tiered world from a JAX cache-DMP state (numpy leaves)."""
    fc = fc or _fc()
    dmp = _dmp(CACHE, fc=fc)
    st = train_state_from_jax(jstate, device="cpu")
    tt = TieredTable("big", LOGICAL, D, CACHE,
                     opt_slots=opt_slot_widths(fc, D),
                     init_fn=lambda s, e: w0[s:e], eviction_policy="lru")
    coll = TieredCollection({"big": tt}, {"q": "big"})
    return dmp, st, coll


@pytest.fixture(scope="module")
def jax_start():
    """The JAX cache world's start state (numpy leaves) and the logical
    table's initial rows."""
    w0 = np.random.RandomState(5).uniform(
        -0.05, 0.05, size=(LOGICAL, D)).astype(np.float32)
    _, _, jstate, _ = _jax_world(None, w0)
    return jax.tree.map(np.asarray, jstate), w0


def _close(a, b):
    return np.allclose(a[:, :D], b[:, :D], rtol=0, atol=TABLE_ATOL) and (
        np.allclose(a[:, D:], b[:, D:], rtol=SLOT_RTOL, atol=1e-12))


def test_tiered_pipeline_matches_jax(jax_start):
    """The port's tiered pipeline and the JAX package's from one start
    state over one stream: the same cache plans and maps, losses and the
    logical table (rows and slots) within the tolerances."""
    jstart, w0 = jax_start
    raw = _stream(17, 6)
    env, jdmp, jstate, jcoll = _jax_world(jax.tree.map(jnp.asarray, jstart),
                                          w0)
    with trace_kernels(pooled="xla", update="xla"):
        jpipe = JPipeline(jdmp, jstate, env, jcoll)
        jl = _drain_losses(jpipe.progress, iter(_jax_batches(raw)))
    jrows = jcoll.logical_table_weights(jdmp, jpipe.state)
    jpipe.close()
    dmp, st, coll = _port_from_jax(jstart, w0)
    pipe = TieredTrainPipeline(dmp, st, coll)
    pl = _drain_losses(pipe.progress, iter(_port_batches(raw)))
    prows = coll.logical_table_weights(dmp, pipe.state)
    pipe.close()
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(prows["big"], jrows["big"], rtol=0,
                               atol=TABLE_ATOL)
    assert coll.tables["big"]._resident == jcoll.tables["big"]._resident
    assert coll.stats.per_table["big"] == jcoll.stats.per_table["big"]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _poisoned(raw, k):
    out = list(raw)
    d, q, r, y = out[k]
    out[k] = (d, q, r, np.full_like(y, np.nan))
    return out


def test_revert_last_step_matches_jax(jax_start):
    """A NaN step skipped by the loop: the port's undo log (recorded after
    the step's fills) leaves the cache table, the host tier and the id ->
    slot maps as the JAX package's ``revert_last_step`` (the old state,
    then the fills again) leaves them; and the port's
    ``revert_last_step`` from a saved state (the JAX form), called on the
    pipeline after the same NaN step, gives the undo log's result bit for
    bit."""
    jstart, w0 = jax_start
    raw = _poisoned(_stream(31, 6), 2)
    env, jdmp, jstate, jcoll = _jax_world(jax.tree.map(jnp.asarray, jstart),
                                          w0)
    with trace_kernels(pooled="xla", update="xla"):
        jpipe = JPipeline(jdmp, jstate, env, jcoll)
        jloop = JLoop(jpipe, JCheckpointer(os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"jrev{os.getpid()}")), jdmp,
            checkpoint_interval=None, checkpoint_on_start=False,
            max_consecutive_bad_steps=10, resume=False)
        jit_ = iter(_jax_batches(raw))
        for _ in range(3):
            jloop.progress(jit_)
    assert jloop.skipped_steps == 1
    jcache = np.asarray(jpipe.state["tables"]["tw_d8"])
    jhost = jcoll.tables["big"].store.snapshot()

    results = []
    for form in ("undo", "saved"):
        dmp, st, coll = _port_from_jax(jstart, w0)
        pipe = TieredTrainPipeline(dmp, st, coll)
        it = iter(_port_batches(raw))
        if form == "undo":
            loop = FaultTolerantTrainLoop(pipe, Checkpointer(os.path.join(
                os.environ.get("TMPDIR", "/tmp"), f"prev{os.getpid()}")),
                dmp, checkpoint_interval=None, checkpoint_on_start=False,
                max_consecutive_bad_steps=10, resume=False)
            for _ in range(3):
                loop.progress(it)
            assert loop.skipped_steps == 1
        else:
            # the JAX form: the pipeline alone, then a revert to a copy of
            # the state before the NaN step
            for _ in range(2):
                assert np.isfinite(float(pipe.progress(it)["loss"]))
            saved = _clone_tree(pipe.state)
            assert not np.isfinite(float(pipe.progress(it)["loss"]))
            pipe.revert_last_step(saved)
        results.append((pipe.state["tables"]["tw_d8"].clone(),
                        pipe.state["fused"]["tw_d8"]["momentum"].clone(),
                        coll.tables["big"].store.snapshot(),
                        dict(coll.tables["big"]._resident)))
        pipe.close()
    (cache, mom, host, res), (cache2, mom2, host2, res2) = results
    assert torch.equal(cache, cache2) and torch.equal(mom, mom2)
    assert np.array_equal(host, host2) and res == res2
    assert res == jcoll.tables["big"]._resident
    np.testing.assert_allclose(cache.numpy(), jcache, rtol=0,
                               atol=TABLE_ATOL)
    assert _close(host, jhost)


def test_jax_tiered_checkpoint_through_convert(jax_start, tmp_path):
    """A JAX tiered checkpoint (host tier rows, device cache) carried into
    the port by ``convert.checkpoint_payload_from_jax``: the restored host
    tier equals the JAX one bitwise, the cache is cold, and both packages
    train on from it to the same losses and logical table (tolerances)."""
    jstart, w0 = jax_start
    raw = _stream(55, 8)
    env, jdmp, jstate, jcoll = _jax_world(jax.tree.map(jnp.asarray, jstart),
                                          w0)
    jck = JCheckpointer(str(tmp_path / "jax"), tiered=jcoll)
    with trace_kernels(pooled="xla", update="xla"):
        jpipe = JPipeline(jdmp, jstate, env, jcoll)
        jit_ = iter(_jax_batches(raw))
        for _ in range(3):
            jpipe.progress(jit_)
        jpipe.drain()
        step = int(jpipe.state["step"])
        jck.save(jdmp, jpipe.state)
        jck.wait()
        jl = _drain_losses(jpipe.progress, jit_)
    jrows = jcoll.logical_table_weights(jdmp, jpipe.state)
    jpipe.close()

    payload = checkpoint_payload_from_jax(jck._read_payload(step))
    assert set(payload["tiered"]) == {"big"}
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save_payload(payload, step)
    dmp, _, coll = _port_from_jax(jstart, w0)
    st = Checkpointer(str(tmp_path / "port"), tiered=coll).restore(dmp, step)
    np.testing.assert_array_equal(
        coll.tables["big"].store.snapshot(),
        np.asarray(jck._read_payload(step)["tiered"]["big"]["host_rows"]))
    assert coll.tables["big"].occupancy == 0
    pipe = TieredTrainPipeline(dmp, st, coll)
    pl = _drain_losses(pipe.progress, iter(_port_batches(raw[step:])))
    prows = coll.logical_table_weights(dmp, pipe.state)
    pipe.close()
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(prows["big"], jrows["big"], rtol=0,
                               atol=TABLE_ATOL)


def test_planned_host_cached_table_builds_and_trains(world):
    """The planner's FUSED_HOST_CACHED option runs: ``grouped.py`` builds
    the table-wise cache group over the plan's cache rows,
    ``tiered_tables_from_plan`` sizes the host tier from the plan's
    factor, and the run is bitwise the all-device one; a host-cached
    table under a row-wise plan is refused."""
    w0, _ = world
    tables = _tables(LOGICAL)
    cons = {"big": ParameterConstraints(
                sharding_types=[ShardingType.TABLE_WISE],
                compute_kernels=[EmbeddingComputeKernel.FUSED_HOST_CACHED],
                cache_load_factor=0.1),
            "side": ParameterConstraints(
                sharding_types=[ShardingType.TABLE_WISE])}
    plan = EmbeddingShardingPlanner(world_size=1, constraints=cons,
                                    batch_size_per_device=B).plan(tables)
    assert plan["big"].compute_kernel == (
        EmbeddingComputeKernel.FUSED_HOST_CACHED)
    # the planner scales caches into the memory left over: pin the cache
    # to this test's size, a factor of CACHE / LOGICAL
    plan["big"] = dataclasses.replace(plan["big"],
                                      cache_load_factor=CACHE / LOGICAL)
    tiered = tiered_tables_from_plan(
        plan, tables, _fc(), eviction_policy="lfu_aged",
        init_fns={"big": lambda s, e: w0["big"][s:e]})
    assert tiered["big"].cache_rows == CACHE
    assert tiered["big"].opt_slots == {"momentum": D}
    raw = _stream(3, 6)
    losses_f, full, st_f = _all_device(world, raw)
    dmp, coll, pipe = _tiered_world(world, tables_fn=lambda: tiered)
    assert _drain_losses(pipe.progress, iter(_port_batches(raw))) == losses_f
    pipe.close()
    assert _state_equal(dmp, pipe.state, coll, full, st_f)
    dmp_planned = _dmp(CACHE, plan={**plan})
    assert dmp_planned.plan["big"].compute_kernel == (
        EmbeddingComputeKernel.FUSED_HOST_CACHED)
    rw = {**plan, "big": ParameterSharding(
        ShardingType.ROW_WISE, ranks=[0],
        compute_kernel=EmbeddingComputeKernel.FUSED_HOST_CACHED)}
    with pytest.raises(ValueError, match="TW or DP"):
        _dmp(CACHE, plan=rw)


def test_rowwise_adagrad_tiered_bitexact(world):
    """The rowwise-Adagrad slot (one column) travels packed too."""
    fc = _fc(EmbOptimType.ROWWISE_ADAGRAD)
    raw = _stream(8, 8)
    w0, dense0 = world
    full = _dmp(LOGICAL, fc=fc)
    st = full.init(torch.Generator().manual_seed(0))
    st["dense"] = {k: v.clone() for k, v in dense0.items()}
    st["dense_opt"] = full.dense_tx.init(st["dense"])
    full.load_table_weights(st, w0)
    pipe_f = BucketedTrainPipeline(full, st, BucketingConfig(kernels=KERNELS))
    lf = _drain_losses(pipe_f.progress, iter(_port_batches(raw)))
    dmp, coll, pipe = _tiered_world(world, fc=fc)
    assert _drain_losses(pipe.progress, iter(_port_batches(raw))) == lf
    pipe.close()
    assert coll.tables["big"].row_width == D + 1
    assert _state_equal(dmp, pipe.state, coll, full, pipe_f.state)

