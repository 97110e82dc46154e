"""Port parity for the train -> serve freshness loop
(``inference/freshness.py``, ``HotRowServingCache`` and
``BucketedInferenceServer(hot_rows=)`` of ``inference/bucketed_serving.py``,
``reliability/fault_injection.py::CrashMidPublishPublisher``,
``parallel/production.py::TouchedRowTracker``).

* Every drill of the JAX suite (``tests/test_freshness.py``) on the port:
  the adoption into the host tier and the resident cache rows, the three
  torn-publish windows each leaving the old generation serving bitwise,
  a torn CURRENT, out-of-range ids, a mid-apply storage failure undone,
  and the retention window.
* Formats: a generation published by either package is adopted by the
  other's subscriber, rows and vocabulary events alike.
* Serving: the hot-row cache's slots and cache rows equal the JAX
  cache's, exactly; ``BucketedInferenceServer(hot_rows=)`` scores within
  ``rtol=1e-4, atol=1e-5`` of the JAX server's (the two packages pool and
  sum in other orders); two executors over one churning cache serve
  every score exactly (the copy-on-write contract).
* The tracker's drained rows equal the JAX tracker's over the same
  tables, and the loop publishes at its checkpoints what a replica then
  serves: its host tier equal to the trainer's tables, bitwise.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import torch_dynamic_helpers as helpers
from torchrec_tpu.inference import bucketed_serving as jbs
from torchrec_tpu.inference import freshness as jfr
from torchrec_tpu_torch.inference import freshness as tfr
from torchrec_tpu_torch.inference.bucketed_serving import (
    BucketedInferenceServer,
    HotRowServingCache,
    ServingBucketConfig,
)
from torchrec_tpu_torch.reliability.fault_injection import (
    CrashMidPublishPublisher,
    SimulatedCrash,
)
from torchrec_tpu_torch.tiered.storage import TieredTable

R, D = 64, 4


def w0():
    return np.arange(R * D, dtype=np.float32).reshape(R, D)


def make_stack(tmp_path, with_hot=True, opt_slots=None):
    """(delta dir, table, hot cache or None, subscriber)."""
    tbl = TieredTable("big", R, D, cache_rows=16, opt_slots=opt_slots or {},
                      init_fn=lambda s, e: w0()[s:e])
    hot = None
    if with_hot:
        hot = HotRowServingCache({"big": tbl}, {"fbig": "big"},
                                 device="cpu")
        hot.process(np.asarray([1, 2, 3], np.int64),
                    np.asarray([[3]], np.int64), ["fbig"])
    d = str(tmp_path / "deltas")
    return d, tbl, hot, tfr.DeltaSubscriber(d, {"big": tbl}, hot_rows=hot)


def counters(sub):
    return {k: v for k, v in sub.metrics.flat().items()
            if "rollback" in k or "torn" in k}


def test_publish_adopt_applies_host_and_resident_rows(tmp_path):
    d, tbl, hot, sub = make_stack(tmp_path)
    pub = tfr.DeltaPublisher(d)
    assert sub.poll() is False
    ids = np.asarray([1, 5], np.int64)  # 1 is resident, 5 is not
    rows = np.full((2, D), 7.5, np.float32)
    before = hot.device_caches()["big"]
    assert pub.publish(step=10, deltas={"big": (ids, rows)}) == 1
    assert sub.poll() is True and sub.generation == 1
    assert sub.applied_step == 10
    np.testing.assert_array_equal(tbl.read_weight_rows(ids), rows)
    slot = dict(zip(*(a.tolist() for a in tbl.resident_items())))[1]
    after = hot.device_caches()["big"]
    assert torch.equal(after[slot], torch.from_numpy(rows[0]))
    # copy-on-write: the snapshot a batch took before is untouched
    assert not torch.equal(before[slot], after[slot])
    m = sub.metrics.flat()
    assert m["freshness/big/staleness_steps"] == 0.0
    assert m["freshness/big/applied_rows"] == 2.0
    assert m["freshness/big/refreshed_slots"] == 1.0
    assert hot.scalar_metrics()["serving_cache/big/refreshed_rows"] == 1.0
    assert sub.poll() is False


def test_second_generation_supersedes_and_slots_survive(tmp_path):
    d, tbl, _, sub = make_stack(tmp_path, with_hot=False,
                                opt_slots={"momentum": D})
    pub = tfr.DeltaPublisher(d)
    ids = np.asarray([3], np.int64)
    packed = tbl.read_rows(ids)
    packed[:, D:] = 9.25
    tbl.write_rows(ids, packed)
    pub.publish(step=1, deltas={"big": (ids, np.ones((1, D), np.float32))})
    pub.publish(step=2, deltas={"big": (ids, np.full((1, D), 2.0,
                                                     np.float32))})
    assert sub.poll() is True and sub.generation == 2
    after = tbl.read_rows(ids)
    np.testing.assert_array_equal(after[:, :D], 2.0)
    np.testing.assert_array_equal(after[:, D:], 9.25)
    with pytest.raises(ValueError):
        tbl.write_weight_rows(ids, np.zeros((1, D + 1), np.float32))


def adopt_baseline(tmp_path, **kw):
    d, tbl, hot, sub = make_stack(tmp_path, **kw)
    tfr.DeltaPublisher(d).publish(step=10, deltas={"big": (
        np.asarray([1, 2], np.int64), np.full((2, D), 3.25, np.float32))})
    assert sub.poll() is True
    return d, tbl, hot, sub


def torn_deltas():
    return {"big": (np.asarray([1, 2], np.int64),
                    np.zeros((2, D), np.float32))}


def test_kill_before_manifest_is_invisible(tmp_path):
    d, tbl, hot, sub = adopt_baseline(tmp_path)
    before = tbl.host_weights_view().copy()
    cache = hot.device_caches()["big"].clone()
    torn = CrashMidPublishPublisher(tfr.DeltaPublisher(d), "before_manifest")
    with pytest.raises(SimulatedCrash):
        torn.publish(step=20, deltas=torn_deltas())
    assert not os.path.exists(os.path.join(d, "manifest.g2.json"))
    assert any(n.startswith("delta.g2.") for n in os.listdir(d))
    assert sub.poll() is False and sub.generation == 1
    np.testing.assert_array_equal(tbl.host_weights_view(), before)
    assert torch.equal(hot.device_caches()["big"], cache)
    assert counters(sub) == {}


def test_kill_before_current_then_republish(tmp_path):
    d, tbl, _, sub = adopt_baseline(tmp_path)
    before = tbl.host_weights_view().copy()
    torn = CrashMidPublishPublisher(tfr.DeltaPublisher(d), "before_current")
    with pytest.raises(SimulatedCrash):
        torn.publish(step=20, deltas=torn_deltas())
    assert os.path.exists(os.path.join(d, "manifest.g2.json"))
    with open(os.path.join(d, tfr.CURRENT_NAME)) as f:
        assert json.load(f)["generation"] == 1
    assert sub.poll() is False and sub.generation == 1
    np.testing.assert_array_equal(tbl.host_weights_view(), before)
    assert counters(sub) == {}
    pub2 = tfr.DeltaPublisher(d)
    assert pub2.generation == 2
    pub2.publish(step=30, deltas=torn_deltas())
    assert sub.poll() is True and sub.generation == 3
    np.testing.assert_array_equal(tbl.read_weight_rows(np.asarray([1, 2])),
                                  0.0)


def test_corrupt_chunk_rolls_back_with_counters_and_staleness(tmp_path):
    d, tbl, hot, sub = adopt_baseline(tmp_path)
    before = tbl.host_weights_view().copy()
    cache = hot.device_caches()["big"].clone()
    CrashMidPublishPublisher(tfr.DeltaPublisher(d), "corrupt_chunk").publish(
        step=25, deltas=torn_deltas())
    assert sub.poll() is False and sub.generation == 1
    np.testing.assert_array_equal(tbl.host_weights_view(), before)
    assert torch.equal(hot.device_caches()["big"], cache)
    c = counters(sub)
    assert c["freshness/rollback_count"] == 1.0
    assert c["freshness/big/rollback_count"] == 1.0
    assert "freshness/torn_publish_count" not in c
    assert sub.metrics.flat()["freshness/big/staleness_steps"] == 15.0
    tfr.DeltaPublisher(d).publish(step=30, deltas=torn_deltas())
    assert sub.poll() is True
    assert sub.metrics.flat()["freshness/big/staleness_steps"] == 0.0


def test_torn_current_and_out_of_range_ids(tmp_path):
    d, tbl, _, sub = adopt_baseline(tmp_path)
    before = tbl.host_weights_view().copy()
    tfr.DeltaPublisher(d).publish(step=40, deltas={"big": (
        np.asarray([R + 7], np.int64), np.zeros((1, D), np.float32))})
    assert sub.poll() is False
    np.testing.assert_array_equal(tbl.host_weights_view(), before)
    assert counters(sub)["freshness/big/rollback_count"] == 1.0
    with open(os.path.join(d, tfr.CURRENT_NAME), "w") as f:
        json.dump({"generation": 99, "step": 99}, f)
    assert sub.poll() is False and sub.generation == 1
    assert counters(sub)["freshness/torn_publish_count"] == 1.0


def test_mid_apply_storage_failure_undoes_partial_apply(tmp_path):
    ta = TieredTable("ta", R, D, 8, opt_slots={},
                     init_fn=lambda s, e: w0()[s:e])
    tb = TieredTable("tb", R, D, 8, opt_slots={},
                     init_fn=lambda s, e: w0()[s:e])

    class FailingWrites:
        def __getattr__(self, name):
            return getattr(tb, name)

        def write_weight_rows(self, ids, rows):
            raise OSError("injected host-tier write failure")

    d = str(tmp_path / "deltas")
    sub = tfr.DeltaSubscriber(d, {"ta": ta, "tb": FailingWrites()})
    ids = np.asarray([1, 2], np.int64)
    before = ta.host_weights_view().copy()
    tfr.DeltaPublisher(d).publish(step=10, deltas={
        "ta": (ids, np.zeros((2, D), np.float32)),
        "tb": (ids, np.zeros((2, D), np.float32))})
    assert sub.poll() is False and sub.generation == 0
    np.testing.assert_array_equal(ta.host_weights_view(), before)
    m = sub.metrics.flat()
    assert m["freshness/apply_error_count"] == 1.0
    assert m["freshness/rollback_count"] == 1.0


def test_pruning_keeps_the_retention_window(tmp_path):
    d, _, _, sub = make_stack(tmp_path, with_hot=False)
    pub = tfr.DeltaPublisher(d, keep_generations=2)
    for step in range(1, 5):
        pub.publish(step=step, deltas={"big": (
            np.asarray([0], np.int64), np.zeros((1, D), np.float32))})
    names = os.listdir(d)
    assert not any(".g1." in n or ".g2." in n for n in names), names
    assert sub.poll() is True and sub.generation == 4


class _Tbl:
    """A host tier facade (numpy rows) for the cross-package drills."""

    embedding_dim, num_embeddings = D, R

    def __init__(self):
        self.w = w0()

    def read_weight_rows(self, ids):
        return self.w[ids]

    def write_weight_rows(self, ids, rows):
        self.w[ids] = rows


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_generations_cross_packages(tmp_path, publisher):
    """A generation (rows and vocabulary events) published by either
    package is adopted by the other's subscriber; a corrupt one is
    refused by it."""
    from torchrec_tpu.dynamic.vocab import VocabView as JView
    from torchrec_tpu_torch.dynamic.vocab import VocabView as TView

    pmod, smod, view_cls = ((jfr, tfr, TView) if publisher == "jax"
                            else (tfr, jfr, JView))
    d = str(tmp_path / "deltas")
    tbl, view = _Tbl(), view_cls(8)
    sub = smod.DeltaSubscriber(d, {"big": tbl}, vocabs={"big": view})
    rows = np.random.RandomState(0).randn(3, D).astype(np.float32)
    ids = np.asarray([4, 9, 60], np.int64)
    pmod.DeltaPublisher(d).publish(7, {"big": (ids, rows)}, vocab_events={
        "big": [{"op": "admit", "id": 1 << 41, "slot": 3, "step": 7}]})
    assert sub.poll() is True and sub.applied_step == 7
    np.testing.assert_array_equal(tbl.w[ids], rows)
    slots, adm = view.lookup(np.asarray([1 << 41, 5], np.int64))
    assert slots.tolist() == [3, 0] and adm.tolist() == [True, False]
    bad = str(tmp_path / "bad")
    sub2 = smod.DeltaSubscriber(bad, {"big": _Tbl()})
    pmod.DeltaPublisher(bad).publish(1, {"big": (ids, rows)})
    chunk = [n for n in os.listdir(bad) if n.endswith(".chunk")][0]
    with open(os.path.join(bad, chunk), "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad")
    assert sub2.poll() is False
    assert sub2.metrics.flat()["freshness/rollback_count"] == 1.0


# ---------------------------------------------------------------------------
# the hot-row cache and the server against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return helpers.build_jax_native(str(tmp_path_factory.mktemp("jaxlib")))


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    helpers.patch_jax_native(monkeypatch, jax_lib)


def test_hot_row_cache_slots_and_rows_match_jax(jax_native):
    rng = np.random.RandomState(3)
    wbig = rng.randn(200, D).astype(np.float32)
    t = HotRowServingCache.from_host_weights({"big": wbig}, {"big": 16},
                                             {"f": "big"}, device="cpu")
    j = jbs.HotRowServingCache.from_host_weights({"big": wbig}, {"big": 16},
                                                 {"f": "big"})
    for _ in range(10):
        ids = rng.randint(0, 200, size=(12,)).astype(np.int64)
        lengths = np.asarray([[5, 7]], np.int64)
        feats = ["f", "other"]
        ts, tc = t.process(ids, lengths, feats)
        js, jc = j.process(ids, lengths, feats)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tc["big"].numpy(),
                                      np.asarray(jc["big"]))
        np.testing.assert_array_equal(tc["big"].numpy()[ts[:5]], wbig[ids[:5]])
    assert t.scalar_metrics() == j.scalar_metrics()
    assert t.stats.per_table["big"]["eviction_count"] > 0
    with pytest.raises(ValueError, match="out of range"):
        t.remap(np.asarray([3, 500], np.int64), np.asarray([[2]]), ["f"])


class _HotFn(torch.nn.Module):
    """score = sum of the hot table's pooled rows + sum of the dense
    features; the lookup on the kernel ``with_lookup_kernel`` gave it, or
    the registry's."""

    device = torch.device("cpu")

    def __init__(self, kernel=None):
        super().__init__()
        self.kernel = kernel

    def with_lookup_kernel(self, kernel):
        """This function with its lookup on ``kernel``."""
        return _HotFn(kernel)

    def forward(self, dense, kjt, caches):
        from torchrec_tpu_torch.ops.embedding_ops import (
            pooled_embedding_lookup,
            resolve_lookup_kernel,
        )

        S = kjt.total_stride
        pooled = pooled_embedding_lookup(
            caches["big"], kjt.values(), kjt.segment_ids(), S,
            kernel=resolve_lookup_kernel(self.kernel))
        return pooled.sum(-1) + dense.sum(-1)


def _jax_fn(dense, kjt, caches):
    import jax.numpy as jnp

    from torchrec_tpu.ops.embedding_ops import pooled_embedding_lookup
    from torchrec_tpu.parallel.sharding.common import per_slot_segments

    jt = kjt["f"]
    seg = per_slot_segments(jt.lengths(), jt.capacity)
    pooled = pooled_embedding_lookup(caches["big"],
                                     jt.values().astype(jnp.int32), seg,
                                     jt.lengths().shape[0])
    return jnp.sum(pooled, -1) + jnp.sum(dense, -1)


def test_hot_row_server_scores_match_jax(jax_native):
    rng = np.random.RandomState(5)
    wbig = rng.randn(300, D).astype(np.float32)
    tsrv = BucketedInferenceServer(
        _HotFn(), ["f"], [4], num_dense=2, max_batch_size=8,
        max_latency_us=300, queue="python",
        bucket_config=ServingBucketConfig(max_programs=6),
        dedup="pallas_dedup",
        hot_rows=HotRowServingCache.from_host_weights(
            {"big": wbig}, {"big": 32}, {"f": "big"}, device="cpu"))
    jsrv = jbs.BucketedInferenceServer(
        _jax_fn, ["f"], [4], num_dense=2, max_batch_size=8,
        max_latency_us=300, queue="python",
        bucket_config=jbs.ServingBucketConfig(max_programs=6),
        dedup=True, hot_rows=jbs.HotRowServingCache.from_host_weights(
            {"big": wbig}, {"big": 32}, {"f": "big"}))
    for srv in (tsrv, jsrv):
        srv.warmup()
        srv.start(num_executors=1)
    try:
        for i in range(12):
            dense = rng.randn(2).astype(np.float32)
            ids = rng.randint(0, 300, size=rng.randint(1, 5)).astype(
                np.int64)
            got = tsrv.predict(dense, [ids], timeout_us=30_000_000)
            want = jsrv.predict(dense, [ids], timeout_us=30_000_000)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(
                got, wbig[ids].sum() + dense.sum(), rtol=1e-4, atol=1e-5)
    finally:
        tsrv.stop()
        jsrv.stop()
    m = tsrv.metrics.flat()
    assert m["serving_cache/big/lookup_count"] > 0
    assert m.get("serving/executor_error_count", 0.0) == 0.0


def test_multi_executor_hot_rows_consistent():
    """Two executors over one small, churning cache: a concurrent fill
    recycling a slot never changes another batch's snapshot, so every
    score is exact."""
    rng = np.random.RandomState(9)
    wbig = rng.randn(300, 4).astype(np.float32)
    hot = HotRowServingCache.from_host_weights({"big": wbig}, {"big": 48},
                                               {"f": "big"}, device="cpu")
    srv = BucketedInferenceServer(
        _HotFn(), ["f"], [4], num_dense=1, max_batch_size=8,
        max_latency_us=300, queue="python",
        bucket_config=ServingBucketConfig(max_programs=6), dedup=True,
        hot_rows=hot)
    srv.warmup()
    srv.start(num_executors=2)
    results = {}
    try:
        def client(i):
            r = np.random.RandomState(1000 + i)
            for j in range(6):
                ids = r.randint(0, 300, size=3).astype(np.int64)
                got = srv.predict(np.zeros(1, np.float32), [ids],
                                  timeout_us=30_000_000)
                results[(i, j)] = (got, float(wbig[ids].sum()))

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        srv.stop()
    assert len(results) == 48
    for k, (got, want) in results.items():
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(k))
    assert hot.stats.per_table["big"]["eviction_count"] > 0


# ---------------------------------------------------------------------------
# the tracker and the loop
# ---------------------------------------------------------------------------


KEYS = ["q", "r"]
ROWS, DIM, B = 64, 8, 16


def _dmp():
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = tuple(EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                                      name=f"t_{k}", feature_names=[k])
                   for k in KEYS)
    return DistributedModelParallel(
        DLRM(EmbeddingBagCollection(tables, device="meta"), 3, (8, DIM),
             (8, 1)), tables, table_wise_plan(tables), B,
        {k: B for k in KEYS}, fused_config=FusedOptimConfig(
            learning_rate=0.05), dense_optimizer=adagrad(0.05),
        device="cpu")


def _raw_stream(seed, steps):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        yield ({k: np.int64(1 << 41) + (rng.zipf(1.2, size=B) - 1) % 50
                for k in KEYS}, rng.rand(B, 3).astype(np.float32),
               rng.randint(0, 2, size=(B,)).astype(np.float32))


class VocabPipeline:
    """A synchronous pipeline over raw ids: each step's remap runs after
    the previous step (the evicted rows it reads are trained ones), the
    admitted rows are written and the evicted ones reset before the step,
    and every touched slot is credited to the tracker."""

    def __init__(self, dmp, state, vocabs, tracker):
        self.dmp, self.state, self.vocabs = dmp, state, vocabs
        self.tracker = tracker

    def progress(self, it):
        from torchrec_tpu_torch.datasets.utils import Batch
        from torchrec_tpu_torch.sparse import KeyedJaggedTensor

        ids, dense, labels = next(it)
        slots, weights = [], []
        for k in KEYS:
            t = f"t_{k}"
            sl, adm, io = self.vocabs.tables[t].lookup(
                ids[k], row_reader=lambda s, t=t: self.dmp.gather_row_state(
                    self.state, t, s))
            if io.evicted_slots.size:
                self.dmp.reset_table_rows(self.state, t, io.evicted_slots)
            if io.admitted_slots.size:
                self.dmp.set_table_rows(self.state, t, io.admitted_slots,
                                        io.fetch_rows)
            self.tracker.record(t, np.concatenate(
                [sl, io.admitted_slots, io.evicted_slots]))
            slots.append(sl)
            weights.append(adm.astype(np.float32))
        kjt = KeyedJaggedTensor.from_lengths_packed(
            KEYS, np.concatenate(slots), np.ones((len(KEYS) * B,), np.int32),
            weights=np.concatenate(weights), caps=B)
        self.state, m = self.dmp.train_step(
            self.state, Batch(torch.from_numpy(dense), kjt,
                              torch.from_numpy(labels)))
        return m


def test_tracker_drain_matches_jax_tracker():
    """The port reads the drained rows on the device (``gather_row_state``)
    where the JAX tracker reads whole host tables: the same ``(ids, rows)``
    on the same tables."""
    from torchrec_tpu.parallel.production import (
        TouchedRowTracker as JTracker,
    )
    from torchrec_tpu_torch.parallel.production import TouchedRowTracker

    dmp = _dmp()
    state = dmp.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for g in state["tables"].values():
            g.add_(torch.randn(g.shape, generator=torch.Generator(
            ).manual_seed(1)))
    weights = dmp.table_weights(state)

    class _View:
        def table_weights(self, st):
            return weights

    t, j = TouchedRowTracker(), JTracker()
    rng = np.random.RandomState(0)
    for _ in range(3):
        for k in KEYS:
            ids = rng.randint(0, ROWS, size=10)
            t.record(f"t_{k}", ids)
            j.record(f"t_{k}", ids)
    assert t.pending_rows() == j.pending_rows()
    got, want = t.drain(dmp, state), j.drain(_View(), {"tables": {}})
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
    assert t.drain(dmp, state) == {} and t.total_recorded == j.total_recorded


def test_loop_publishes_what_the_replica_serves(tmp_path):
    """The freshness loop at a small size: a ``FaultTolerantTrainLoop``
    over raw ids through a ``DynamicVocabCollection`` checkpoints every 4
    steps with ``Checkpointer(vocab=)`` and publishes the touched rows and
    the vocabulary events; a replica's subscriber adopts each generation
    into its host tier (equal to the trainer's tables, bitwise) and its
    ``VocabView`` (equal to the trainer's remap)."""
    from torchrec_tpu_torch.checkpoint import Checkpointer
    from torchrec_tpu_torch.dynamic.vocab import (
        DynamicVocab,
        DynamicVocabCollection,
        VocabView,
    )
    from torchrec_tpu_torch.parallel.production import TouchedRowTracker
    from torchrec_tpu_torch.reliability.train_loop import (
        FaultTolerantTrainLoop,
    )

    dmp = _dmp()
    state = dmp.init(torch.Generator().manual_seed(0))
    w0s = dmp.table_weights(state)
    col = DynamicVocabCollection({
        f"t_{k}": DynamicVocab(f"t_{k}", capacity=24, dim=DIM,
                               journal_path=str(tmp_path / "v" / k),
                               admit_threshold=2, window_steps=2,
                               kv_url=f"mem://{tmp_path}/kv{k}")
        for k in KEYS})
    tracker = TouchedRowTracker()
    pipe = VocabPipeline(dmp, state, col, tracker)
    loop = FaultTolerantTrainLoop(
        pipe, Checkpointer(str(tmp_path / "ck"), vocab=col), dmp,
        checkpoint_interval=4)
    loop.attach_delta_publisher(tfr.DeltaPublisher(str(tmp_path / "d")),
                                tracker, col)
    hot = HotRowServingCache.from_host_weights(
        w0s, {t: 16 for t in w0s}, {k: f"t_{k}" for k in KEYS},
        device="cpu")
    views = {t: VocabView(24) for t in w0s}
    sub = tfr.DeltaSubscriber(str(tmp_path / "d"), hot.tables, hot_rows=hot,
                              vocabs=views)
    it = _raw_stream(2, 12)
    evicted = 0
    for target in (4, 8, 12):
        loop.run(it, max_steps=target)
        assert sub.poll() is True
        assert sub.applied_step == target
        w = dmp.table_weights(loop.pipeline.state)
        for t, tbl in hot.tables.items():
            np.testing.assert_array_equal(tbl.host_weights_view(), w[t])
            ids, slots = col.tables[t].assigned_items()
            got, adm = views[t].lookup(ids)
            assert adm.all() and np.array_equal(got, slots)
        evicted = sum(v.scalar_metrics()[f"vocab/{t}/eviction_count"]
                      for t, v in col.tables.items())
    assert loop.delta_publish_count == 3 and evicted > 0
    assert sub.metrics.flat()["freshness/t_q/staleness_steps"] == 0.0
    col.close()
