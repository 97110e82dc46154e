"""The port's synchronous host-offloaded tables
(``torchrec_tpu_torch/modules/host_offload.py``) against the JAX
package's (``torchrec_tpu/modules/host_offload.py``).

* ``process`` gives the same slot ids and cache plans as the JAX
  collection on one stream (both on their native LRU transformers, the
  JAX one built from its ``csrc/`` into a private directory): exact.
* A DLRM over a 16-slot cache of a 10,000-row table, trained through
  ``process`` / ``apply_io`` / the DMP's own step in both packages from
  one start state: losses within ``rtol=1e-5``, the host tables and the
  cache within ``atol=2e-6`` (``tests/test_torch_dlrm_train.py``'s);
  evicted rows reach the host trained, and a fetched row is its host
  row bitwise.
* With no eviction the weights-only path equals the all-device step
  bitwise; ``cache_rows_from_plan`` sizes caches as the JAX function.
* The disk-backed table persists through ``DiskStore``; a working set
  larger than the cache across two features of one table raises.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.inference import serving as jserving
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules import host_offload as jho
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
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.convert import train_state_from_jax
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.modules.host_offload import (
    HostOffloadedCollection,
    HostOffloadedTable,
    cache_rows_from_plan,
)
from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    ParameterSharding,
    ShardingType,
    table_wise_plan,
)
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor

B, D, LR = 16, 8, 0.05
LOGICAL, CACHE = 10_000, 16
LOSS_RTOL, TABLE_ATOL = 1e-5, 2e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's LRU transformer built with g++ into a private
    directory, loaded by the JAX tables in place of ``csrc_build``."""
    out = str(tmp_path_factory.mktemp("jax_native") / "libjax.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    out, os.path.join(ROOT, "csrc", "id_transformer.cpp"),
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


def _ids(seed, n, high=LOGICAL):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, high, size=(B,)).astype(np.int64)
            for _ in range(n)]


def _raw(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, 4).astype(np.float32),
             rng.randint(0, 2, size=(B,)).astype(np.float32))
            for _ in range(n)]


def _kjts(ids):
    lens = np.ones((B,), np.int32)
    return (KeyedJaggedTensor.from_lengths_packed(
        ["q"], torch.from_numpy(ids), torch.from_numpy(lens), caps=[2 * B]),
        JKJT.from_lengths_packed(["q"], ids, lens, caps=[2 * B]))


def _port_dmp(rows):
    tables = (EmbeddingBagConfig(num_embeddings=rows, embedding_dim=D,
                                 name="big", feature_names=["q"]),)
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), 4, (8, D), (8, 1)), tables,
        table_wise_plan(tables), B, {"q": 2 * B},
        fused_config=FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                                      learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu")


def _jax_dmp():
    tables = (JCfg(num_embeddings=CACHE, embedding_dim=D, name="big",
                   feature_names=["q"], pooling=JPooling.SUM),)
    return JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=4,
            dense_arch_layer_sizes=(8, D), over_arch_layer_sizes=(8, 1)),
        tables=tables, env=JEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan={"big": JPS(JST.TABLE_WISE, ranks=[0])},
        batch_size_per_device=B, feature_caps={"q": 2 * B},
        dense_in_features=4,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))


def test_process_plans_match_jax():
    t = HostOffloadedCollection(
        {"big": HostOffloadedTable("big", LOGICAL, D, CACHE, seed=7)},
        {"q": "big"})
    j = jho.HostOffloadedCollection(
        {"big": jho.HostOffloadedTable("big", LOGICAL, D, CACHE, seed=7)},
        {"q": "big"})
    np.testing.assert_array_equal(t.tables["big"].host_weights,
                                  j.tables["big"].host_weights)
    for ids in _ids(3, 8, high=60):
        kt, kj = _kjts(ids)
        (pk, pio), (jk, jio) = t.process(kt), j.process(kj)
        np.testing.assert_array_equal(pk.values().numpy(),
                                      np.asarray(jk.values()))
        for f in ("fetch_slots", "fetch_logical", "writeback_slots",
                  "writeback_logical"):
            np.testing.assert_array_equal(getattr(pio["big"], f),
                                          getattr(jio["big"], f))


def test_training_with_evictions_matches_jax():
    """Both packages train through the synchronous path from one start
    state; every step evicts (a 16-slot cache over fresh ids)."""
    jdmp = _jax_dmp()
    jstate = jdmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, jstate)
    jcoll = jho.HostOffloadedCollection(
        {"big": jho.HostOffloadedTable("big", LOGICAL, D, CACHE, seed=7)},
        {"q": "big"})
    dmp = _port_dmp(CACHE)
    state = train_state_from_jax(start, device="cpu")
    coll = HostOffloadedCollection(
        {"big": HostOffloadedTable("big", LOGICAL, D, CACHE, seed=7)},
        {"q": "big"})
    ids, raw = _ids(11, 6, high=200), _raw(12, 6)
    jl, pl, evicted = [], [], 0
    with trace_kernels(pooled="xla", update="xla"):
        jstep = jdmp.make_train_step(donate=False)
        for q, (d, y) in zip(ids, raw):
            kt, kj = _kjts(q)
            kj2, jios = jcoll.process(kj)
            jstate = jcoll.apply_io(jdmp, jstate, jios)
            jstate, m = jstep(jstate, stack_batches(
                [JBatch(jnp.asarray(d), kj2, jnp.asarray(y))]))
            jl.append(float(m["loss"]))
            kt2, ios = coll.process(kt)
            evicted += len(ios["big"].writeback_slots)
            # a fetched row lands as its host row, bitwise
            state = coll.apply_io(dmp, state, ios)
            got = dmp.gather_row_state(state, "big", ios["big"].fetch_slots)
            np.testing.assert_array_equal(
                got, coll.tables["big"].host_weights[
                    ios["big"].fetch_logical])
            state, m = dmp.train_step(state, Batch(torch.from_numpy(d), kt2,
                                                   torch.from_numpy(y)))
            pl.append(float(m["loss"]))
    assert evicted > 0
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(coll.tables["big"].host_weights,
                               jcoll.tables["big"].host_weights, rtol=0,
                               atol=TABLE_ATOL)
    np.testing.assert_allclose(dmp.table_weights(state)["big"],
                               np.asarray(jdmp.table_weights(jstate)["big"]),
                               rtol=0, atol=TABLE_ATOL)


def test_no_eviction_equals_the_all_device_step():
    """With every id resident (no eviction), moving the weights alone is
    exact: the synchronous path over a cache equals the all-device step,
    losses and rows bitwise."""
    full = _port_dmp(200)
    st_f = full.init(torch.Generator().manual_seed(0))
    w0 = full.table_weights(st_f)["big"].copy()
    dense0 = {k: v.clone() for k, v in st_f["dense"].items()}
    cache = _port_dmp(64)
    st_c = cache.init(torch.Generator().manual_seed(0))
    st_c["dense"] = {k: v.clone() for k, v in dense0.items()}
    st_c["dense_opt"] = cache.dense_tx.init(st_c["dense"])
    coll = HostOffloadedCollection(
        {"big": HostOffloadedTable("big", 200, D, 64,
                                   init_fn=lambda s, e: w0[s:e])},
        {"q": "big"})
    pairs = {}
    for q, (d, y) in zip(_ids(4, 3, high=200), _raw(5, 3)):
        kt, _ = _kjts(q)
        kt2, ios = coll.process(kt)
        assert not len(ios["big"].writeback_slots)
        pairs.update(zip(ios["big"].fetch_logical.tolist(),
                         ios["big"].fetch_slots.tolist()))
        st_c = coll.apply_io(cache, st_c, ios)
        st_c, mc = cache.train_step(st_c, Batch(torch.from_numpy(d), kt2,
                                                torch.from_numpy(y)))
        st_f, mf = full.train_step(st_f, Batch(torch.from_numpy(d), kt,
                                               torch.from_numpy(y)))
        assert float(mc["loss"]) == float(mf["loss"])
    ids = np.fromiter(pairs, np.int64)
    slots = np.array([pairs[i] for i in ids.tolist()], np.int64)
    np.testing.assert_array_equal(
        cache.gather_row_state(st_c, "big", slots, {"momentum": 1}),
        full.gather_row_state(st_f, "big", ids, {"momentum": 1}))


@pytest.mark.parametrize("clf", [None, 0.0, 0.05, 2.0])
def test_cache_rows_from_plan_matches_jax(clf):
    from torchrec_tpu.parallel.types import (
        EmbeddingComputeKernel as JKernel,
    )

    plan = {"a": ParameterSharding(
        ShardingType.TABLE_WISE, ranks=[0],
        compute_kernel=EmbeddingComputeKernel.FUSED_HOST_CACHED,
        cache_load_factor=clf),
        "b": ParameterSharding(ShardingType.TABLE_WISE, ranks=[0])}
    jplan = {"a": JPS(JST.TABLE_WISE, ranks=[0],
                      compute_kernel=JKernel.FUSED_HOST_CACHED,
                      cache_load_factor=clf),
             "b": JPS(JST.TABLE_WISE, ranks=[0])}
    rows = {"a": 1000, "b": 50}
    assert cache_rows_from_plan(plan, rows) == jho.cache_rows_from_plan(
        jplan, rows)


def test_disk_backed_table_persists(tmp_path):
    path = str(tmp_path / "big.bin")
    t1 = HostOffloadedTable("big", 1000, D, CACHE, storage_path=path, seed=3)
    t1.host_weights[7] = 42.0
    assert t1.flush() == 2
    del t1
    t2 = HostOffloadedTable("big", 1000, D, CACHE, storage_path=path, seed=3)
    np.testing.assert_array_equal(t2.host_weights[7], np.full(D, 42.0))
    t3 = HostOffloadedTable("x", 1000, D, CACHE, seed=3)
    np.testing.assert_array_equal(t2.host_weights[8], t3.host_weights[8])
    with pytest.raises(ValueError, match="does not match"):
        HostOffloadedTable("big", 1000, 2 * D, CACHE, storage_path=path)


def test_two_features_one_table_one_transform():
    tbl = HostOffloadedTable("shared", 1000, D, cache_rows=4, seed=1)
    coll = HostOffloadedCollection({"shared": tbl},
                                   {"q1": "shared", "q2": "shared"})

    def kjt_for(ids1, ids2):
        lens = [len(ids1)] + [0] * (B - 1) + [len(ids2)] + [0] * (B - 1)
        return KeyedJaggedTensor.from_lengths_packed(
            ["q1", "q2"], torch.tensor(ids1 + ids2), torch.tensor(lens),
            caps=[2 * B, 2 * B])

    kjt, ios = coll.process(kjt_for([7, 8], [8, 9]))
    out = kjt.values().numpy()
    assert out[1] == out[2 * B]
    assert set(ios["shared"].fetch_logical.tolist()) == {7, 8, 9}
    with pytest.raises(ValueError, match="recycled twice"):
        coll.process(kjt_for([1, 2], [3, 4, 5]))
