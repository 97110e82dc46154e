"""The port's checkpoint (``torchrec_tpu_torch/checkpoint.py``) against the
JAX package's, the crash-safety cases of ``tests/test_fault_tolerance.py``
in the port, and the row-state surface of the port's DMP.

* Port against JAX: the same initial state (``convert.
  train_state_from_jax``), 3 steps in each package, a save in each; the
  JAX payload (``Checkpointer._read_payload``) and the port's hold the
  same tables and per-table slots within the tolerances of
  ``tests/test_torch_dlrm_train.py`` (tables ``atol = 2e-6``, momentum
  ``rtol = 1e-5``, dense ``atol = 1e-6``), the same step, and sidecars
  with the same tables, shapes and dtypes.
* A JAX checkpoint carried across (``convert.
  checkpoint_payload_from_jax``) restores in the port to a state equal
  (bitwise) to ``train_state_from_jax`` of the JAX state, and goes back
  (``checkpoint_payload_to_jax``) to the JAX payload bit for bit.
* Crash safety: torn and corrupt directories skipped, a same-step
  re-save, the checksum sidecar, a crash mid-save, write retries, async
  save with ``keep_last_n``, the plan mismatch, and an async save taken
  before an in-place step holding the state at the save.  (The JAX
  package's pre-marker "legacy" layout has no port counterpart: the port
  never wrote one.)
"""

import json
import os
import subprocess
import threading

import jax
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.checkpoint import Checkpointer as JCheckpointer
from torchrec_tpu.datasets.random import RandomRecDataset as JDataset
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
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu_torch.checkpoint import (
    COMMIT_MARKER,
    Checkpointer,
    CheckpointCorruption,
    CheckpointPlanMismatch,
)
from torchrec_tpu_torch.convert import (
    checkpoint_payload_from_jax,
    checkpoint_payload_to_jax,
    train_state_from_jax,
)
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import (
    ParameterSharding,
    ShardingType,
    table_wise_plan,
)
from torchrec_tpu_torch.reliability.fault_injection import (
    CrashMidSaveCheckpointer,
    FlakyWriteCheckpointer,
    GatedWriteCheckpointer,
    SimulatedCrash,
)

KEYS, ROWS, D, B, IDS, LR = ["a", "b"], [200, 100], 8, 4, [2, 1], 0.05
TABLE_ATOL, SLOT_RTOL, DENSE_ATOL = 2e-6, 1e-5, 1e-6


def _port_dmp(rows=ROWS, plan=None, **kw):
    tables = tuple(EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                      name=f"t{k}", feature_names=[k])
                   for k, r in zip(KEYS, rows))
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), 4, (8, D), (8, 1)), tables,
        plan or table_wise_plan(tables), B, dict(zip(KEYS, [B * 2, B])),
        fused_config=FusedOptimConfig(learning_rate=LR),
        dense_optimizer=adagrad(LR), device="cpu", **kw)


def _port_batches(n, seed=3):
    it = iter(RandomRecDataset(KEYS, B, ROWS, IDS, num_dense=4,
                               manual_seed=seed))
    return [next(it) for _ in range(n)]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX DMP's start state (numpy), its state after 3 steps and the
    payload of its save."""
    tables = tuple(JCfg(num_embeddings=r, embedding_dim=D, name=f"t{k}",
                        feature_names=[k], pooling=JPooling.SUM)
                   for k, r in zip(KEYS, ROWS))
    ds = JDataset(KEYS, B, ROWS, IDS, num_dense=4, manual_seed=3)
    dmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=4, dense_arch_layer_sizes=(8, D),
            over_arch_layer_sizes=(8, 1)),
        tables=tables, env=JEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,))),
        plan={t.name: JPS(JST.TABLE_WISE, ranks=[0]) for t in tables},
        batch_size_per_device=B, feature_caps=dict(zip(KEYS, ds.caps)),
        dense_in_features=4,
        fused_config=JFused(optim=JOptim.ROWWISE_ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))
    state = dmp.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, state)
    it = iter(ds)
    with trace_kernels(pooled="xla", update="xla"):
        step = dmp.make_train_step(donate=False)
        for _ in range(3):
            state, _ = step(state, stack_batches([next(it)]))
    d = str(tmp_path_factory.mktemp("jax_ck"))
    ck = JCheckpointer(d)
    ck.save(dmp, state)
    with open(os.path.join(d, "step_3", "checksums.json")) as f:
        sidecar = json.load(f)
    return start, jax.tree.map(np.asarray, state), ck._read_payload(3), sidecar


def test_port_checkpoint_matches_jax(jax_side, tmp_path):
    start, _, jpayload, jsidecar = jax_side
    dmp = _port_dmp()
    state = train_state_from_jax(start, device="cpu")
    for b in _port_batches(3):
        state, _ = dmp.train_step(state, b)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(dmp, state)
    payload = ck._read_payload(3)
    assert payload["step"] == int(jpayload["step"]) == 3
    assert sorted(payload) == sorted(jpayload)
    for t, w in jpayload["tables"].items():
        np.testing.assert_allclose(payload["tables"][t].numpy(), w, rtol=0,
                                   atol=TABLE_ATOL, err_msg=t)
        np.testing.assert_allclose(
            payload["fused_tables"][t]["momentum"].numpy(),
            jpayload["fused_tables"][t]["momentum"], rtol=SLOT_RTOL, atol=0)
    for g, st in jpayload["fused"].items():
        np.testing.assert_allclose(payload["fused"][g]["momentum"].numpy(),
                                   st["momentum"], rtol=SLOT_RTOL, atol=0)
    back = checkpoint_payload_to_jax(payload)
    for a, b in zip(jax.tree.leaves(back["dense"]),
                    jax.tree.leaves(jpayload["dense"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=DENSE_ATOL)
    with open(tmp_path / "ck" / "step_3" / "checksums.json") as f:
        sidecar = json.load(f)
    assert sidecar["version"] == jsidecar["version"] == 1
    assert sorted(sidecar["tables"]) == sorted(jsidecar["tables"])
    for t, ent in jsidecar["tables"].items():
        assert sidecar["tables"][t]["shape"] == ent["shape"]
        assert sidecar["tables"][t]["dtype"] == ent["dtype"]
        assert sorted(sidecar["tables"][t]) == sorted(ent)


def test_jax_checkpoint_carried_across_restores_in_port(jax_side, tmp_path):
    _, jstate, jpayload, _ = jax_side
    payload = checkpoint_payload_from_jax(jpayload)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_payload(payload, 3)
    dmp = _port_dmp()
    restored = ck.restore(dmp, 3)
    want = train_state_from_jax(jstate, device="cpu")
    assert restored["step"] == want["step"] == 3
    assert _equal(restored["tables"], want["tables"])
    assert _equal(restored["fused"], want["fused"])
    for k in want["dense"]:
        assert torch.equal(restored["dense"][k], want["dense"][k]), k
        assert torch.equal(restored["dense_opt"][k], want["dense_opt"][k]), k
    assert _equal(ck.restore_elastic(dmp, 3)["tables"], want["tables"])
    # and back: the JAX payload bit for bit
    back = checkpoint_payload_to_jax(ck._read_payload(3))
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jpayload)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(pa))


def test_latest_step_skips_torn_and_corrupt_dirs(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    (d / "step_5").mkdir()
    (d / "step_5" / COMMIT_MARKER).write_text('{"step": 5}')
    (d / "step_99").mkdir()  # torn: payload but no marker
    (d / "step_99" / "payload").mkdir()
    (d / "step_3").mkdir()  # no marker, nothing in it
    (d / "step_xyz").mkdir()  # not a step directory
    child = subprocess.Popen(["true"])
    dead_pid = child.pid
    child.wait()
    (d / f".tmp_step_7.{dead_pid}.0").mkdir()
    (d / f".tmp_step_8.{os.getppid()}.0").mkdir()  # a live foreign owner
    ck = Checkpointer(str(d))
    assert ck.latest_step() == 5 and ck.steps() == [5]
    assert not (d / f".tmp_step_7.{dead_pid}.0").exists()
    assert (d / f".tmp_step_8.{os.getppid()}.0").exists()
    with pytest.raises(FileNotFoundError, match="never.*committed|torn"):
        ck.restore(object(), 99)


def test_same_step_resave_never_destroys_committed_data(tmp_path):
    dmp = _port_dmp()
    state = dmp.init(torch.Generator().manual_seed(11))
    d = tmp_path / "ck"
    ck = Checkpointer(str(d))
    ck.save(dmp, state)
    ck.save(dmp, state)
    assert ck.steps() == [0]
    assert not any(".replaced" in n for n in os.listdir(d))
    os.replace(d / "step_0", d / "step_0.replaced")  # crash mid-swap
    assert Checkpointer(str(d)).latest_step() == 0
    assert _equal(Checkpointer(str(d)).restore(dmp, 0), state)


def test_checkpoint_checksum_sidecar_verifies_and_names_table(tmp_path):
    dmp = _port_dmp()
    state = dmp.init(torch.Generator().manual_seed(13))
    d = tmp_path / "ck"
    Checkpointer(str(d)).save(dmp, state)
    sidecar = d / "step_0" / Checkpointer.CHECKSUM_SIDECAR
    assert _equal(Checkpointer(str(d)).restore(dmp, 0), state)
    rec = json.loads(sidecar.read_text())
    victim = sorted(rec["tables"])[0]
    rec["tables"][victim]["crc32"] ^= 0xFFFF
    sidecar.write_text(json.dumps(rec))
    with pytest.raises(CheckpointCorruption, match=victim):
        Checkpointer(str(d)).restore(dmp, 0)
    with pytest.raises(CheckpointCorruption, match="integrity"):
        Checkpointer(str(d)).restore_elastic(dmp, 0)
    sidecar.unlink()  # no sidecar: no verification
    assert _equal(Checkpointer(str(d)).restore(dmp, 0), state)
    # a flipped byte in a table's file on disk names that table
    Checkpointer(str(tmp_path / "ck2")).save(dmp, state)
    man = json.loads((tmp_path / "ck2" / "step_0" / "payload" /
                      "manifest.json").read_text())
    entry = next(e for e in man["leaves"] if e["path"] == ["tables", "tb"])
    path = tmp_path / "ck2" / "step_0" / "payload" / entry["file"]
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruption, match=r"\['tb'\]"):
        Checkpointer(str(tmp_path / "ck2")).restore(dmp, 0)


def test_crash_mid_save_resumes_from_last_committed(tmp_path):
    from torchrec_tpu_torch.parallel.train_pipeline import TrainPipelineBase
    from torchrec_tpu_torch.reliability import FaultTolerantTrainLoop

    dmp = _port_dmp()
    batches = _port_batches(5)
    state = dmp.init(torch.Generator().manual_seed(0))
    ck = CrashMidSaveCheckpointer(str(tmp_path / "ck"), crash_on_save=1,
                                  save_retries=0)
    for b in batches[:2]:
        state, _ = dmp.train_step(state, b)
    ck.save(dmp, state)
    committed = Checkpointer(str(tmp_path / "ck")).restore(dmp, 2)
    for b in batches[2:4]:
        state, _ = dmp.train_step(state, b)
    with pytest.raises(SimulatedCrash):
        ck.save(dmp, state)
    assert any(n.startswith(".tmp_step_4")
               for n in os.listdir(tmp_path / "ck"))
    assert ck.latest_step() == 2
    ck2 = Checkpointer(str(tmp_path / "ck"))  # the restarted job
    assert not any(n.startswith(".tmp_step_")
                   for n in os.listdir(tmp_path / "ck"))
    pipe = TrainPipelineBase(dmp.train_step,
                             dmp.init(torch.Generator().manual_seed(9)),
                             "cpu")
    loop = FaultTolerantTrainLoop(pipe, ck2, dmp, checkpoint_interval=None,
                                  checkpoint_on_start=False)
    assert loop.resumed_from == 2
    assert _equal(pipe.state, committed)
    m = loop.progress(iter(batches[4:]))
    assert np.isfinite(float(m["loss"]))


def test_save_retries_transient_write_failures(tmp_path):
    dmp = _port_dmp()
    state = dmp.init(torch.Generator().manual_seed(1))
    ck = FlakyWriteCheckpointer(str(tmp_path / "ck"), fail_first_n=2,
                                save_retries=2, retry_backoff_s=0.01)
    ck.save(dmp, state)
    assert ck.failed_attempts == 2 and ck.latest_step() == 0
    ck2 = FlakyWriteCheckpointer(str(tmp_path / "ck2"), fail_first_n=5,
                                 save_retries=1, retry_backoff_s=0.01)
    with pytest.raises(IOError, match="injected transient"):
        ck2.save(dmp, state)
    assert ck2.latest_step() is None
    ck3 = FlakyWriteCheckpointer(str(tmp_path / "ck3"), fail_first_n=5,
                                 save_retries=1, retry_backoff_s=0.01,
                                 async_save=True)
    ck3.save(dmp, state)
    with pytest.raises(IOError, match="injected transient"):
        ck3.wait()
    ck4 = CrashMidSaveCheckpointer(str(tmp_path / "ck4"), crash_on_save=0,
                                   async_save=True)
    ck4.save(dmp, state)
    with pytest.raises(SimulatedCrash):
        ck4.wait()
    assert ck4.latest_step() is None


def test_async_save_overlaps_in_place_steps_and_gc_keeps_last_n(tmp_path):
    """The write waits on a gate while the next steps update the state in
    place; the committed payload is the state at the save (``save`` copied
    it to the host before returning), and keep_last_n leaves 2 steps."""
    dmp = _port_dmp()
    batches = _port_batches(6)
    state = dmp.init(torch.Generator().manual_seed(2))
    gate = threading.Event()
    ck = GatedWriteCheckpointer(str(tmp_path / "ck"), gate=gate,
                                async_save=True, keep_last_n=2)
    state, _ = dmp.train_step(state, batches[0])
    at_save = {"tables": {g: t.clone() for g, t in state["tables"].items()},
               "fused": {g: {k: v.clone() for k, v in st.items()}
                         for g, st in state["fused"].items()},
               "dense": {k: v.clone() for k, v in state["dense"].items()}}
    ck.save(dmp, state)
    assert ck.latest_step() is None
    for b in batches[1:3]:
        state, _ = dmp.train_step(state, b)  # in place, write in flight
    assert state["step"] == 3 and ck.latest_step() is None
    gate.set()
    ck.wait()
    assert ck.latest_step() == 1
    restored = ck.restore(dmp, 1)
    assert restored["step"] == 1
    assert _equal(restored["tables"], at_save["tables"])
    assert _equal(restored["fused"], at_save["fused"])
    assert _equal(restored["dense"], at_save["dense"])
    assert not _equal(restored["tables"], state["tables"])
    for b in batches[3:6]:
        state, _ = dmp.train_step(state, b)
        ck.save(dmp, state)
    ck.close()
    assert ck.steps() == [5, 6]
    assert sorted(n for n in os.listdir(tmp_path / "ck")
                  if n.startswith("step_")) == ["step_5", "step_6"]
    with pytest.raises(FileNotFoundError):
        ck.restore(dmp, 1)
    assert _equal(ck.restore(dmp, 6), state)


def test_restore_plan_mismatch_fails_loud(tmp_path):
    dmp = _port_dmp()
    ck = Checkpointer(str(tmp_path / "ck"))
    state = dmp.init(torch.Generator().manual_seed(30))
    ck.save(dmp, state, step=1)
    grown = _port_dmp(rows=[ROWS[0] * 2, ROWS[1]])
    with pytest.raises(CheckpointPlanMismatch, match="ta") as e:
        ck.restore(grown, 1)
    assert "reshard" in str(e.value) and "load_table_weights" in str(e.value)
    dp = {f"t{k}": ParameterSharding(ShardingType.DATA_PARALLEL)
          for k in KEYS}
    with pytest.raises(CheckpointPlanMismatch, match="sharding plan"):
        ck.restore(_port_dmp(plan=dp), 1)
    # the plan-independent restore takes the other plan
    other = ck.restore_elastic(_port_dmp(plan=dp), 1)
    assert np.array_equal(_port_dmp(plan=dp).table_weights(other)["ta"],
                          dmp.table_weights(state)["ta"])
    assert _equal(ck.restore(dmp, 1), state)


def test_restore_elastic_without_per_table_slots_falls_back(jax_side,
                                                            tmp_path):
    """A payload without ``fused_tables``: the same plan restores through
    the exact path, another plan fails with the descriptive mismatch."""
    _, _, jpayload, _ = jax_side
    payload = checkpoint_payload_from_jax(
        {k: v for k, v in jpayload.items() if k != "fused_tables"})
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_payload(payload, 3)
    assert ck.restore_elastic(_port_dmp(), 3)["step"] == 3
    dp = {f"t{k}": ParameterSharding(ShardingType.DATA_PARALLEL)
          for k in KEYS}
    with pytest.raises(CheckpointPlanMismatch, match="sharding plan"):
        ck.restore_elastic(_port_dmp(plan=dp), 3)


def test_unported_collections_and_modes_raise(tmp_path):
    # the tiered collection is ported (tests/test_torch_tiered.py); the
    # dynamic vocabulary is not yet
    tiered = object()
    assert Checkpointer(str(tmp_path), tiered=tiered).tiered is tiered
    with pytest.raises(NotImplementedError, match="A10"):
        Checkpointer(str(tmp_path), vocab=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        Checkpointer(str(tmp_path), async_save=True, commit_barrier=object())
    with pytest.raises(ValueError, match="keep_last_n"):
        Checkpointer(str(tmp_path), keep_last_n=0)


def test_row_state_surface_round_trips_in_place():
    """reset/set/gather/scatter of rows and their rowwise slots, in place,
    on a table-wise and a row-wise table."""
    tables = tuple(EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                      name=f"t{k}", feature_names=[k])
                   for k, r in zip(KEYS, ROWS))
    for plan in (table_wise_plan(tables),
                 {f"t{k}": ParameterSharding(ShardingType.ROW_WISE,
                                             ranks=[0]) for k in KEYS}):
        dmp = _port_dmp(plan=plan)
        state = dmp.init(torch.Generator().manual_seed(4))
        for b in _port_batches(2):
            state, _ = dmp.train_step(state, b)
        rows = np.array([3, 0, 99])
        slots = {"momentum": 1}
        packed = dmp.gather_row_state(state, "tb", rows, slots)
        w = dmp.table_weights(state)["tb"]
        np.testing.assert_array_equal(packed[:, :D], w[rows])
        before = {g: t.clone() for g, t in state["tables"].items()}
        dmp.reset_table_rows(state, "tb", rows)
        assert not dmp.table_weights(state)["tb"][rows].any()
        dmp.scatter_row_state(state, "tb", rows, packed, slots)
        assert _equal(state["tables"], before)
        np.testing.assert_array_equal(
            dmp.gather_row_state(state, "tb", rows, slots), packed)
        vals = np.arange(3 * D, dtype=np.float32).reshape(3, D)
        dmp.set_table_rows(state, "tb", rows, vals)
        np.testing.assert_array_equal(dmp.table_weights(state)["tb"][rows],
                                      vals)
        with pytest.raises(ValueError, match="width"):
            dmp.gather_row_state(state, "tb", rows, {"momentum": 2})
