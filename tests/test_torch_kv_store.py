"""Port parity for the parameter server's storage (``dynamic/kv_store.py``,
``csrc/host/kv_store.cpp``) and ``SyncedCollisionCollection``: the
append-log KV written by either package and read by the other (put, get,
overwrite, torn tail, compaction), the IO registry's schemes, the per-id
init of ``KVBackedRows`` against the JAX one, the ZCH parameter-server
round trip on the port's DMP, and the synced collision state on two gloo
processes.  Every comparison is exact: the stores move float32 bytes and
the host maps are the same C++ code."""

import os

import numpy as np
import pytest
import torch

import torch_dynamic_helpers as helpers
from torchrec_tpu.dynamic import kv_store as jkv
from torchrec_tpu_torch.dynamic import kv_store as tkv

D = 6


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return helpers.build_jax_native(str(tmp_path_factory.mktemp("jaxlib")))


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    helpers.patch_jax_native(monkeypatch, jax_lib)


def _stores(writer):
    """(the writing package's store class, the reading one's)."""
    pair = (tkv.EmbeddingKVStore, jkv.EmbeddingKVStore)
    return pair if writer == "port" else pair[::-1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kv_put_get_overwrite_read_across_packages(tmp_path, jax_native,
                                                   writer):
    write_cls, read_cls = _stores(writer)
    rng = np.random.RandomState(0)
    path = str(tmp_path / "t.kv")
    keys = np.asarray([5, -3, 1 << 62, 7], np.int64)
    rows = rng.randn(4, D).astype(np.float32)
    s = write_cls(path, D)
    s.put(keys, rows)
    s.put(keys[:1], rows[1:2])  # last write wins
    got, found = s.get(np.asarray([5, 99], np.int64))
    assert found.tolist() == [True, False]
    np.testing.assert_array_equal(got[0], rows[1])
    np.testing.assert_array_equal(got[1], 0.0)
    s.close()
    r = read_cls(path, D)
    assert len(r) == 4
    assert sorted(r.keys().tolist()) == sorted(keys.tolist())
    got, found = r.get(keys)
    assert found.all()
    np.testing.assert_array_equal(got, np.concatenate([rows[1:2], rows[1:]]))
    r.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kv_torn_tail_truncated_on_open(tmp_path, jax_native, writer):
    """A record cut mid-row is dropped on open by either package, and the
    next append starts at a record boundary."""
    write_cls, read_cls = _stores(writer)
    path = str(tmp_path / "t.kv")
    s = write_cls(path, D)
    s.put(np.asarray([1, 2], np.int64), np.ones((2, D), np.float32))
    s.close()
    with open(path, "ab") as f:
        f.write(b"\x4d\x45\x56\x4b" + b"\x03" * 8 + b"\x00" * 5)
    size_before = os.path.getsize(path)
    r = read_cls(path, D)
    assert len(r) == 2 and os.path.getsize(path) < size_before
    r.put(np.asarray([3], np.int64), np.full((1, D), 2.0, np.float32))
    r.close()
    s2 = write_cls(path, D)
    got, found = s2.get(np.asarray([1, 2, 3], np.int64))
    assert found.all()
    np.testing.assert_array_equal(got[2], 2.0)
    s2.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kv_compaction_on_reopen_keeps_live_rows(tmp_path, jax_native,
                                                 writer):
    """A log more than half dead is rewritten on open; the other package
    reads the compacted file to the same rows."""
    write_cls, read_cls = _stores(writer)
    path = str(tmp_path / "t.kv")
    s = write_cls(path, D)
    for i in range(5):
        s.put(np.arange(4, dtype=np.int64),
              np.full((4, D), float(i), np.float32))
    s.close()
    big = os.path.getsize(path)
    r = read_cls(path, D)
    assert os.path.getsize(path) < big
    got, found = r.get(np.arange(4, dtype=np.int64))
    assert found.all()
    np.testing.assert_array_equal(got, 4.0)
    r.close()
    w = write_cls(path, D)
    np.testing.assert_array_equal(w.get(np.arange(4, dtype=np.int64))[0],
                                  4.0)
    w.close()


def test_io_registry_schemes(tmp_path):
    """``file://`` (and a bare path) is the native store, ``mem://`` the
    shared dict, ``tcp://`` registers itself on first use; an unknown
    scheme raises."""
    from torchrec_tpu_torch.dynamic.tcp_kv import TcpKVServer

    reg = tkv.io_registry
    assert isinstance(reg.resolve(f"file://{tmp_path}/a.kv", D),
                      tkv.EmbeddingKVStore)
    assert isinstance(reg.resolve(str(tmp_path / "b.kv"), D),
                      tkv.EmbeddingKVStore)
    m1 = reg.resolve("mem://shared-x", D)
    m1.put(np.asarray([4], np.int64), np.ones((1, D), np.float32))
    assert reg.resolve("mem://shared-x", D).get(
        np.asarray([4], np.int64))[1].all()
    srv = TcpKVServer()
    try:
        c = reg.resolve(f"tcp://127.0.0.1:{srv.port}/ns", D)
        c.put(np.asarray([9], np.int64), np.full((1, D), 3.0, np.float32))
        rows, found = c.get(np.asarray([9, 8], np.int64))
        assert found.tolist() == [True, False] and rows[0, 0] == 3.0
        c.close()
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="no KV backend"):
        reg.resolve("redis://x", D)


def test_kv_backed_rows_init_matches_jax(tmp_path, jax_native):
    """Missing ids take the deterministic per-id init, bitwise the JAX
    package's; writes go through to the store."""
    ids = np.asarray([3, 1 << 40, 77], np.int64)
    t = tkv.KVBackedRows(f"mem://{tmp_path}/p", 100, D, seed=11)
    j = jkv.KVBackedRows(f"mem://{tmp_path}/j", 100, D, seed=11)
    np.testing.assert_array_equal(t[ids], j[ids])
    t[ids[:1]] = np.full((1, D), 5.0, np.float32)
    np.testing.assert_array_equal(t[ids[:1]], 5.0)


def test_parameter_server_zch_round_trip(tmp_path):
    """The ZCH flow on the port's one-device DMP: eviction ->
    ``flush_evictions`` persists the trained row (read after the step's
    update) -> the id reappears on a fresh slot -> ``restore_assigned``
    writes it back, bitwise."""
    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.modules.mc_modules import (
        ManagedCollisionCollection,
        MCHManagedCollisionModule,
    )
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    B, ZCH = 16, 32
    tables = (EmbeddingBagConfig(num_embeddings=ZCH, embedding_dim=D,
                                 name="tq", feature_names=["q"]),)
    mcc = ManagedCollisionCollection({"q": MCHManagedCollisionModule(ZCH,
                                                                     "tq")})
    dmp = DistributedModelParallel(
        DLRM(EmbeddingBagCollection(tables, device="meta"), 4, (8, D),
             (8, 1)), tables, table_wise_plan(tables), B, {"q": 2 * B},
        fused_config=FusedOptimConfig(optim=EmbOptimType.SGD,
                                      learning_rate=0.5),
        dense_optimizer=adagrad(0.1), device="cpu")
    ps = tkv.ParameterServer.from_urls({"tq": f"file://{tmp_path}/zch.kv"},
                                       {"tq": D})
    state = dmp.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)

    def remap(raw):
        nonlocal state
        slots, evs = mcc.remap_packed(["q"], raw,
                                      np.ones((len(raw),), np.int32))
        for e in evs:
            ps.flush_evictions(dmp, state, e.table, e)
            state = dmp.reset_table_rows(state, e.table, e.slots)
        return slots, evs

    def train(raw):
        nonlocal state
        slots, _ = remap(raw)
        kjt = KeyedJaggedTensor.from_lengths_packed(
            ["q"], slots, np.ones((B,), np.int32), caps=2 * B)
        batch = Batch(torch.from_numpy(rng.rand(B, 4).astype(np.float32)),
                      kjt, torch.from_numpy(
                          rng.randint(0, 2, size=(B,)).astype(np.float32)))
        state, _ = dmp.train_step(state, batch)
        return slots

    hot = np.arange(1 << 50, (1 << 50) + B, dtype=np.int64)
    for _ in range(3):
        hot_slots = train(hot)
    trained = dmp.table_weights(state)["tq"][hot_slots[:1]].copy()
    evicted = set()
    i = 0
    while not set(hot.tolist()) <= evicted:
        _, evs = remap(np.arange(i * 1000, i * 1000 + B, dtype=np.int64))
        for e in evs:
            evicted.update(e.global_ids.tolist())
            np.testing.assert_array_equal(
                dmp.table_weights(state)["tq"][e.slots], 0.0)
        i += 1
        assert i < 100, "the hot ids never left"
    stored, found = ps.stores["tq"].get(hot[:1])
    assert found.all()
    np.testing.assert_array_equal(stored, trained)
    new_slots, _ = remap(hot[:1])
    state = ps.restore_assigned(dmp, state, "tq", hot[:1], new_slots)
    np.testing.assert_array_equal(
        dmp.table_weights(state)["tq"][new_slots], trained)


def test_synced_collision_collection_two_gloo_ranks():
    """Two gloo ranks: each rank's remap of its batch equals the
    single-process remap of the concatenated global batch (rank order),
    every rank sees every eviction of the global stream, and the touched
    rows a ``TouchedRowTracker`` drains (read from their owner ranks of a
    row-wise plan) are the same on both ranks and equal the rows of the
    union of the touched ids."""
    from torchrec_tpu_torch.parallel.multiprocess import launch

    seed, steps, world = 5, 3, 2
    res = launch(helpers.dynamic_rank, world, (seed, steps), timeout=240)
    ref = helpers.zch_collection()
    for s, locals_ in enumerate(helpers.zch_batches(seed, world, steps)):
        evs_all = []
        for r, (values, lengths) in enumerate(locals_):
            slots, evs = ref.remap_packed(helpers.KEYS, values, lengths)
            evs_all += [(e.table, e.global_ids.tolist(), e.slots.tolist())
                        for e in evs]
            got = res[r]["values"][s]
            # the KJT's per-key regions hold the packed values in order
            n0 = int(lengths[:helpers.B].sum())
            cap = 2 * helpers.B
            np.testing.assert_array_equal(got[:n0], slots[:n0])
            np.testing.assert_array_equal(
                got[cap:cap + len(slots) - n0], slots[n0:])
        for r in range(world):
            assert res[r]["evictions"][s] == evs_all
    assert any(res[0]["evictions"]), "the stream must evict"
    d0, d1 = res[0]["drained"], res[1]["drained"]
    assert sorted(d0) == sorted(d1) == ["t_q", "t_r"]
    for t in d0:
        np.testing.assert_array_equal(d0[t][0], d1[t][0])
        np.testing.assert_array_equal(d0[t][1], d1[t][1])
        np.testing.assert_array_equal(
            d0[t][1], res[0]["weights"][t][d0[t][0]])
