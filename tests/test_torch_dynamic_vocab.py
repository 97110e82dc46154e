"""Port parity for the dynamic vocabulary (``dynamic/vocab.py``), its gate
mode in the tiered collection and its checkpoint wiring.

* Unit parity, exact: the sketch's and the Bloom filter's buckets, and,
  step by step on the same seeded streams, the slots, admitted masks,
  ``VocabIO`` fields, drained events and counters of the port's
  ``DynamicVocab`` against the JAX package's (the host arithmetic is the
  same numpy), with LFU reclaim, the TTL sweep and KV readmission in the
  streams.
* Formats: a journal written by either package reopens in the other to
  the same remap, and the stream continues alike.
* Crash safety: the kill matrix of the JAX suite (a child process killed
  mid-admission, mid-journal-flush, mid-eviction-writeback) reopens to a
  consistent remap; a corrupt record raises.
* The path: the oracle proof through the port's DMP on the CPU (a table
  that held the surviving ids from step 0, pre-admission occurrences
  weighted 0, gives bitwise the dynamic run's losses and tables), and the
  dynamic run against the JAX DMP with the JAX vocabulary: losses and
  tables within ``1e-6`` absolute, the fused update's stated bound (the
  two packages sum the dense layers and the update's row mean in other
  orders).
"""

import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dynamic_helpers as helpers
from torchrec_tpu.dynamic import vocab as jvocab
from torchrec_tpu_torch.dynamic import vocab as tvocab

D = 4


def _vocab(mod, tmp_path, name="t", capacity=8, sub="p", **kw):
    kw.setdefault("admit_threshold", 2)
    kw.setdefault("window_steps", 1)
    return mod.DynamicVocab(name, capacity=capacity, dim=D,
                            journal_path=str(tmp_path / sub / f"{name}.vocab"),
                            **kw)


def hashed_init(dim, scale=0.05, seed=3):
    """A deterministic per-global-id init, vectorized: each (id, column)
    hashed (splitmix64) to a uniform in ``[-scale, scale)``."""
    cols = np.arange(dim, dtype=np.uint64)

    def init(ids):
        with np.errstate(over="ignore"):
            z = (np.asarray(ids, np.int64).astype(np.uint64)[:, None]
                 * np.uint64(0x9E3779B97F4A7C15)
                 + cols[None, :] * np.uint64(0xBF58476D1CE4E5B9)
                 + np.uint64(seed))
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            z ^= z >> np.uint64(31)
        u = (z >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return ((2.0 * u - 1.0) * scale).astype(np.float32)

    return init


def test_sketch_and_bloom_buckets_match_jax():
    rng = np.random.RandomState(0)
    ids = np.concatenate([rng.randint(-(1 << 62), 1 << 62, size=500),
                          [0, -1, (1 << 63) - 1, -(1 << 63)]]).astype(
                              np.int64)
    ts, js = tvocab.CountMinSketch(1 << 10, 4, 3), jvocab.CountMinSketch(
        1 << 10, 4, 3)
    np.testing.assert_array_equal(ts._buckets(ids), js._buckets(ids))
    ts.add(ids[:300])
    js.add(ids[:300])
    np.testing.assert_array_equal(ts.estimate(ids), js.estimate(ids))
    tb, jb = tvocab.BloomWindow(1 << 12, 4, 3), jvocab.BloomWindow(
        1 << 12, 4, 3)
    for part in (ids[:200], ids[100:400], ids):
        np.testing.assert_array_equal(tb.test_and_set(part),
                                      jb.test_and_set(part))


def _drift_stream(seed, steps, hot=30, drift=3, n=24):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(hot)
    return [np.int64(1 << 40) + np.int64(s * drift)
            + perm[(rng.zipf(1.3, size=n) - 1) % hot] for s in range(steps)]


CONFIGS = {
    # capacity pressure: LFU reclaim and deferrals, KV write-back
    "lfu": dict(capacity=12, ttl_steps=0, kv="mem"),
    # the TTL sweep at window rollover
    "ttl": dict(capacity=40, ttl_steps=3, kv="mem"),
    # the native KV store: readmitted ids get their trained rows back
    "kv_file": dict(capacity=10, ttl_steps=0, kv="file"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_per_step_parity_with_jax(tmp_path, jax_native, config):
    cfg = CONFIGS[config]
    kv = ((lambda w: f"mem://{tmp_path}/{w}") if cfg["kv"] == "mem"
          else (lambda w: f"file://{tmp_path}/{w}.kv"))
    kw = dict(capacity=cfg["capacity"], admit_threshold=2, window_steps=2,
              ttl_steps=cfg["ttl_steps"])
    t = _vocab(tvocab, tmp_path, sub="p", kv_url=kv("p"), **kw)
    j = _vocab(jvocab, tmp_path, sub="j", kv_url=kv("j"), **kw)
    tables = {w: np.zeros((cfg["capacity"], D), np.float32)
              for w in ("p", "j")}
    evicted = readmitted = 0
    seen_evicted = set()
    for s, ids in enumerate(_drift_stream(1, 30)):
        outs = {}
        for w, v in (("p", t), ("j", j)):
            tbl = tables[w]
            slots, adm, io = v.lookup(ids, step=s,
                                      row_reader=lambda sl, tbl=tbl: tbl[sl])
            if io.admitted_slots.size:
                tbl[io.admitted_slots] = io.fetch_rows
            live = np.unique(slots[adm])
            tbl[live] += 0.25  # a mock train touch
            outs[w] = (slots, adm, io, v.drain_events())
        (ps, pa, pio, pev), (js, ja, jio, jev) = outs["p"], outs["j"]
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_array_equal(pa, ja)
        for f in ("admitted_ids", "admitted_slots", "evicted_ids",
                  "evicted_slots"):
            np.testing.assert_array_equal(getattr(pio, f), getattr(jio, f))
        if pio.fetch_rows is None:
            assert jio.fetch_rows is None
        else:
            np.testing.assert_array_equal(pio.fetch_rows, jio.fetch_rows)
        assert pev == jev
        evicted += pio.evicted_ids.size
        readmitted += len(seen_evicted & set(pio.admitted_ids.tolist()))
        seen_evicted |= set(pio.evicted_ids.tolist())
        assert t.occupancy < cfg["capacity"]
    assert t.scalar_metrics() == j.scalar_metrics()
    for a, b in zip(t.assigned_items(), j.assigned_items()):
        np.testing.assert_array_equal(a, b)
    t.verify_consistency()
    assert evicted > 0
    if config != "ttl":
        assert readmitted > 0
    else:
        assert t.scalar_metrics()["vocab/t/evicted_ttl_total"] > 0
    t.close()
    j.close()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return helpers.build_jax_native(str(tmp_path_factory.mktemp("jaxlib")))


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    helpers.patch_jax_native(monkeypatch, jax_lib)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_reopens_across_packages(tmp_path, jax_native, writer):
    """A journal (a snapshot mid-stream, evictions, then more records) of
    one package reopens in the other to the same remap, and both continue
    the stream alike."""
    wmod, rmod = (jvocab, tvocab) if writer == "jax" else (tvocab, jvocab)
    kw = dict(capacity=10, admit_threshold=1, window_steps=2,
              kv_url=f"mem://{tmp_path}/x")
    stream = _drift_stream(2, 16)
    w = _vocab(wmod, tmp_path, sub="w", **kw)
    for s, ids in enumerate(stream[:10]):
        w.lookup(ids, step=s, row_reader=lambda sl: np.ones((len(sl), D)))
        if s == 4:
            w.checkpoint_state()
    want = w.assigned_items()
    w.close()
    r = _vocab(rmod, tmp_path, sub="w", **kw)
    got = r.assigned_items()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    r.verify_consistency()
    w2 = _vocab(wmod, tmp_path, sub="w2", **kw)
    for s, ids in enumerate(stream[:10]):
        w2.lookup(ids, step=s, row_reader=lambda sl: np.ones((len(sl), D)))
    for s, ids in enumerate(stream[10:], start=10):
        a = r.lookup(ids, step=s,
                     row_reader=lambda sl: np.ones((len(sl), D)))
        b = w2.lookup(ids, step=s,
                      row_reader=lambda sl: np.ones((len(sl), D)))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    r.close()
    w2.close()


_CHAOS_SABOTAGE = {
    "mid_admission": """
def sabotage(records):
    os.kill(os.getpid(), signal.SIGKILL)
v._append_records = sabotage
""",
    "mid_journal_flush": """
from torchrec_tpu_torch.dynamic.vocab import _encode_record
def sabotage(records):
    blob = b"".join(_encode_record(r) for r in records)
    v._jf.write(blob[: len(blob) // 2])
    v._jf.flush()
    os.fsync(v._jf.fileno())
    os.kill(os.getpid(), signal.SIGKILL)
v._append_records = sabotage
""",
    "mid_eviction_writeback": """
def sabotage(ids, rows):
    v.kv.put(ids[:1], rows[:1])
    os.kill(os.getpid(), signal.SIGKILL)
v._kv_writeback = sabotage
""",
}


@pytest.mark.parametrize("kill_point", sorted(_CHAOS_SABOTAGE))
def test_chaos_kill_matrix_resumes_consistent(tmp_path, kill_point):
    """A SIGKILL at each protocol stage leaves no orphaned or doubly
    assigned slot and loses no committed admission; the killed step is at
    most delayed (the JAX suite's matrix, on the port's vocabulary and
    its native KV store)."""
    path = str(tmp_path / "c.vocab")
    kv = str(tmp_path / "c.kv")
    child = textwrap.dedent(f"""
        import numpy as np, os, signal
        from torchrec_tpu_torch.dynamic.vocab import DynamicVocab
        v = DynamicVocab("t", capacity=4, dim={D}, journal_path={path!r},
                         admit_threshold=1, window_steps=1, kv_url={kv!r})
        v.lookup(np.array([1, 2, 3]), step=0)
        v.lookup(np.array([1, 2, 3]), step=1)
        assert sorted(v.assigned_items()[0].tolist()) == [1, 2, 3]
    """) + textwrap.dedent(_CHAOS_SABOTAGE[kill_point]) + textwrap.dedent(f"""
        v.lookup(np.array([6, 7]), step=2,
                 row_reader=lambda sl: np.ones((len(sl), {D}), np.float32))
        raise SystemExit("kill point never fired")
    """)
    r = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=120, cwd=helpers.ROOT)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    v2 = tvocab.DynamicVocab("t", capacity=4, dim=D, journal_path=path,
                             admit_threshold=1, window_steps=1, kv_url=kv)
    v2.verify_consistency()
    resident = set(v2.assigned_items()[0].tolist())
    if kill_point == "mid_journal_flush":
        assert resident <= {1, 2, 3, 6, 7}
        gone = np.array(sorted({1, 2, 3} - resident), np.int64)
        if gone.size:
            rows, found = v2.kv.get(gone)
            assert found.all()
            np.testing.assert_array_equal(rows, 1.0)
    else:
        assert resident == {1, 2, 3}
    _, adm, _ = v2.lookup(np.array([6, 7]), step=2,
                          row_reader=lambda sl: np.ones((len(sl), D),
                                                        np.float32))
    assert adm.all()
    v2.verify_consistency()
    v2.close()


def test_corrupt_record_and_backwards_step_raise(tmp_path):
    v = _vocab(tvocab, tmp_path, admit_threshold=1)
    v.lookup(np.array([1]), step=0)
    with pytest.raises(ValueError, match="moved backwards"):
        v.lookup(np.array([1]), step=-1)
    v.close()
    jrn = str(tmp_path / "p" / "t.vocab") + ".j1"
    with open(jrn, "ab") as f:
        f.write(tvocab._encode_record(
            {"op": "evict", "id": 1, "slot": 7, "step": 1}))
    with pytest.raises(tvocab.VocabJournalError):
        _vocab(tvocab, tmp_path, admit_threshold=1)


def test_vocab_view_all_or_nothing_and_collection_surfaces(tmp_path):
    view = tvocab.VocabView(8)
    tok = view.apply_events([{"op": "admit", "id": 10, "slot": 1, "step": 0},
                             {"op": "admit", "id": 11, "slot": 2, "step": 0}])
    with pytest.raises(ValueError, match="occupied slot"):
        view.apply_events([
            {"op": "admit", "id": 12, "slot": 3, "step": 1},
            {"op": "admit", "id": 13, "slot": 2, "step": 1}])
    assert view.occupancy == 2 and not view.lookup(np.array([12]))[1].any()
    view.restore(tok)
    assert view.occupancy == 0
    v = _vocab(tvocab, tmp_path, admit_threshold=1, keep_generations=1)
    col = tvocab.DynamicVocabCollection({"t": v}, {"q": "t"})
    v.lookup(np.array([1]), step=0)
    pinned = int(v.checkpoint_state()["generation"])
    for i in range(3):
        v.lookup(np.array([2 + i]), step=1 + i)
        v.checkpoint_state()
    with pytest.raises(FileNotFoundError, match="keep_generations"):
        v.load_generation(pinned)
    assert col.scalar_metrics()["vocab/t/occupancy"] == 4.0
    with pytest.raises(ValueError, match="saved without the vocab"):
        col.checkpoint_restore(None)
    with pytest.raises(ValueError, match="missing vocab tables"):
        col.checkpoint_restore({"other": {}})
    col.verify_consistency()
    col.close()


# ---------------------------------------------------------------------------
# the path: the oracle proof through the port's DMP, and the JAX DMP
# ---------------------------------------------------------------------------

KEYS = ["q", "r"]
ROWS, DIM, B, STEPS, DENSE_IN = 64, 8, 16, 8, 3
LR = 0.05


def _oracle_stream():
    rng = np.random.RandomState(4)
    out = []
    for s in range(STEPS):
        ids = {k: np.int64(1 << 40) + (rng.zipf(1.2, size=B) - 1) % 40
               for k in KEYS}
        out.append((ids, rng.rand(B, DENSE_IN).astype(np.float32),
                    rng.randint(0, 2, size=(B,)).astype(np.float32)))
    return out


def _port_dmp():
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
        DLRM(EmbeddingBagCollection(tables, device="meta"), DENSE_IN,
             (8, DIM), (8, 1)), tables, table_wise_plan(tables), B,
        {k: B for k in KEYS}, fused_config=FusedOptimConfig(learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu")


def _jax_dmp():
    from torchrec_tpu.models.dlrm import DLRM as JDLRM
    from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig
    from torchrec_tpu.modules.embedding_configs import PoolingType
    from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
    from torchrec_tpu.ops.fused_update import EmbOptimType, FusedOptimConfig
    from torchrec_tpu.parallel.comm import MODEL_AXIS, ShardingEnv, create_mesh
    from torchrec_tpu.parallel.model_parallel import DistributedModelParallel
    from torchrec_tpu.parallel.types import ParameterSharding, ShardingType

    tables = tuple(EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                                      name=f"t_{k}", feature_names=[k],
                                      pooling=PoolingType.SUM) for k in KEYS)
    return DistributedModelParallel(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=DENSE_IN,
            dense_arch_layer_sizes=(8, DIM), over_arch_layer_sizes=(8, 1)),
        tables=tables, env=ShardingEnv.from_mesh(
            create_mesh((1,), (MODEL_AXIS,))),
        plan={t.name: ParameterSharding(ShardingType.TABLE_WISE, ranks=[0])
              for t in tables},
        batch_size_per_device=B, feature_caps={k: B for k in KEYS},
        dense_in_features=DENSE_IN,
        fused_config=FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                                      learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))


def _port_batch(slots, weights, dense, labels):
    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    kjt = KeyedJaggedTensor.from_lengths_packed(
        KEYS, np.concatenate([slots[k] for k in KEYS]),
        np.ones((len(KEYS) * B,), np.int32),
        weights=np.concatenate([weights[k] for k in KEYS]), caps=B)
    return Batch(torch.from_numpy(dense), kjt, torch.from_numpy(labels))


def test_oracle_proof_through_port_dmp_and_jax_parity(tmp_path):
    from torchrec_tpu.datasets.utils import Batch as JBatch
    from torchrec_tpu.parallel.model_parallel import stack_batches
    from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
    from torchrec_tpu_torch.convert import (
        train_state_from_jax,
        train_state_to_jax,
    )

    init = hashed_init(DIM)
    kw = dict(capacity=ROWS, admit_threshold=2, window_steps=2, init_fn=init)
    jdmp = _jax_dmp()
    jstate = jdmp.init(jax.random.key(0))
    state0 = jax.tree.map(np.asarray, jstate)
    stream = _oracle_stream()

    # the dynamic run, both packages, from the same state
    dmp = _port_dmp()
    state = train_state_from_jax(state0, device="cpu")
    tv = {k: _vocab(tvocab, tmp_path, name=f"t_{k}", sub="p", **kw)
          for k in KEYS}
    jv = {k: _vocab(jvocab, tmp_path, name=f"t_{k}", sub="j", **kw)
          for k in KEYS}
    jstep = jdmp.make_train_step(donate=False)
    admit_step = {k: {} for k in KEYS}
    losses, jlosses = [], []
    for s, (ids, dense, labels) in enumerate(stream):
        slots, w, jslots, jw = {}, {}, {}, {}
        for k in KEYS:
            t = f"t_{k}"
            sl, adm, io = tv[k].lookup(ids[k], step=s)
            if io.admitted_slots.size:
                dmp.set_table_rows(state, t, io.admitted_slots, io.fetch_rows)
            for rec in tv[k].drain_events():
                admit_step[k][rec["id"]] = rec["step"]
            slots[k], w[k] = sl, adm.astype(np.float32)
            jsl, jadm, jio = jv[k].lookup(ids[k], step=s)
            if jio.admitted_slots.size:
                jstate = jdmp.set_table_rows(jstate, t, jio.admitted_slots,
                                             jio.fetch_rows)
            jslots[k], jw[k] = jsl, jadm.astype(np.float32)
            np.testing.assert_array_equal(sl, jsl)
        state, m = dmp.train_step(state, _port_batch(slots, w, dense, labels))
        losses.append(m["loss"].clone())
        jkjt = JKJT.from_lengths_packed(
            KEYS, np.concatenate([jslots[k] for k in KEYS]),
            np.ones((len(KEYS) * B,), np.int32),
            weights=np.concatenate([jw[k] for k in KEYS]), caps=B)
        jstate, jm = jstep(jstate, stack_batches(
            [JBatch(jnp.asarray(dense), jkjt, jnp.asarray(labels))]))
        jlosses.append(float(jm["loss"]))
    assert all(len(a) for a in admit_step.values())
    for k in KEYS:
        tv[k].verify_consistency()
    np.testing.assert_allclose([float(x) for x in losses], jlosses, rtol=0,
                               atol=1e-6)
    got, want = train_state_to_jax(state), jax.tree.map(np.asarray, jstate)
    for g in want["tables"]:
        np.testing.assert_allclose(got["tables"][g], want["tables"][g],
                                   rtol=0, atol=1e-6)

    # the oracle: the final map from step 0, pre-admission weights 0
    odmp = _port_dmp()
    ostate = train_state_from_jax(state0, device="cpu")
    final = {k: dict(zip(*(a.tolist() for a in tv[k].assigned_items())))
             for k in KEYS}
    for k in KEYS:
        gids = np.asarray(sorted(final[k]), np.int64)
        odmp.set_table_rows(ostate, f"t_{k}",
                            np.asarray([final[k][g] for g in gids.tolist()]),
                            init(gids))
    for s, (ids, dense, labels) in enumerate(stream):
        slots = {k: np.asarray([final[k].get(int(g), 0) for g in ids[k]],
                               np.int64) for k in KEYS}
        w = {k: np.asarray([1.0 if int(g) in final[k]
                            and admit_step[k][int(g)] <= s else 0.0
                            for g in ids[k]], np.float32) for k in KEYS}
        ostate, om = odmp.train_step(ostate,
                                     _port_batch(slots, w, dense, labels))
        assert torch.equal(om["loss"], losses[s])
    for g in state["tables"]:
        assert torch.equal(state["tables"][g], ostate["tables"][g])
    for v in list(tv.values()) + list(jv.values()):
        v.close()


# ---------------------------------------------------------------------------
# gate mode and the checkpoint
# ---------------------------------------------------------------------------


def test_gate_mode_unadmitted_is_bitwise_sanitize_and_matches_jax(
        tmp_path, jax_native):
    from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
    from torchrec_tpu.tiered import TieredCollection as JColl
    from torchrec_tpu.tiered import TieredTable as JTable
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor
    from torchrec_tpu_torch.tiered import TieredCollection, TieredTable

    def kjt(cls, ids):
        ids = np.asarray(ids, np.int64)
        return cls.from_lengths_packed(["q"], ids,
                                       np.asarray([len(ids)], np.int32),
                                       caps=4)

    tv = _vocab(tvocab, tmp_path, sub="p")
    jv = _vocab(jvocab, tmp_path, sub="j")
    gated = TieredCollection({"big": TieredTable("big", 100, D, 4)},
                             {"q": "big"}, vocab={"big": tv})
    plain = TieredCollection({"big": TieredTable("big", 100, D, 4)},
                             {"q": "big"})
    jgated = JColl({"big": JTable("big", 100, D, cache_rows=4)},
                   {"q": "big"}, vocab={"big": jv})
    kg, iog = gated.process(kjt(KeyedJaggedTensor, [5, 6]))
    jgated.process(kjt(JKJT, [5, 6]))
    kp, _ = plain.process(kjt(KeyedJaggedTensor, [-1, 200]))
    assert torch.equal(kg.values(), kp.values())
    assert torch.equal(kg.weights_or_none(), kp.weights_or_none())
    assert len(iog["big"].fetch_slots) == 0
    m = gated.scalar_metrics()
    assert m["tiered/big/id_violations"] == 0.0
    assert m["vocab/t/null_routed_total"] == 2.0
    for ids in ([5, 6], [5, 6, 7], [7, 8, 5]):
        kg, _ = gated.process(kjt(KeyedJaggedTensor, ids))
        jk, _ = jgated.process(kjt(JKJT, ids))
        np.testing.assert_array_equal(kg.values().numpy(),
                                      np.asarray(jk.values()))
        np.testing.assert_array_equal(kg.weights_or_none().numpy(),
                                      np.asarray(jk.weights_or_none()))
    tv.close()
    jv.close()


def test_checkpointer_pins_the_vocab_generation(tmp_path):
    """``Checkpointer(vocab=)`` pins each vocabulary's generation with the
    rows; a restore rolls the remap back to it; a checkpoint with a vocab
    refuses a Checkpointer without one, and the reverse."""
    from torchrec_tpu_torch.checkpoint import (
        Checkpointer,
        CheckpointPlanMismatch,
    )

    dmp = _port_dmp()
    state = dmp.init(torch.Generator().manual_seed(0))
    v = _vocab(tvocab, tmp_path, admit_threshold=1, keep_generations=4)
    col = tvocab.DynamicVocabCollection({"t": v})
    v.lookup(np.array([1, 2]), step=0)
    ck = Checkpointer(str(tmp_path / "ck"), vocab=col)
    ck.save(dmp, state)
    v.lookup(np.array([3, 4]), step=1)
    assert v.occupancy == 4
    ck.restore(dmp, 0)
    assert sorted(v.assigned_items()[0].tolist()) == [1, 2]
    v.verify_consistency()
    v.lookup(np.array([5]), step=1)
    assert sorted(v.assigned_items()[0].tolist()) == [1, 2, 5]
    with pytest.raises(CheckpointPlanMismatch, match="vocab=collection"):
        Checkpointer(str(tmp_path / "ck")).restore(dmp, 0)
    plain = Checkpointer(str(tmp_path / "ck_plain"))
    plain.save(dmp, state)
    with pytest.raises(ValueError, match="saved without the vocab"):
        Checkpointer(str(tmp_path / "ck_plain"), vocab=col).restore(dmp, 0)
    col.close()
