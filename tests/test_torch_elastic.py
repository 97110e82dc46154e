"""The port's elastic runtime (``reliability/elastic.py``,
``dynamic/tcp_kv.py``, ``obs/flight_recorder.py``): the non-slow cases of
``tests/test_elastic.py`` with the supervisor over a fake worker, the
commit barrier over the port's ``TcpKV``, the wire protocol held against
the JAX package's (each package's client against the other's server),
and one real drill of ``elastic_demo.py``: 2 gloo ranks on the CPU, rank
1 SIGKILLed at step 3, the relaunch at world 1 resumes to step 6, and its
final checkpoint's digest equals a clean world-1 run restarted from a
copy of the committed step 3 (the oracle of an elastic resume).
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from torchrec_tpu.dynamic.tcp_kv import TcpKV as JTcpKV
from torchrec_tpu.dynamic.tcp_kv import TcpKVServer as JTcpKVServer
from torchrec_tpu_torch.checkpoint import Checkpointer
from torchrec_tpu_torch.dynamic.tcp_kv import MAX_DIM, TcpKV, TcpKVServer
from torchrec_tpu_torch.obs.flight_recorder import (
    FlightRecorder,
    current_recorder,
    install_recorder,
    uninstall_recorder,
)
from torchrec_tpu_torch.reliability import elastic_demo
from torchrec_tpu_torch.reliability.elastic import (
    EXIT_PEER_FAILURE,
    BarrierTimeout,
    ElasticJobFailed,
    ElasticSupervisor,
    Heartbeat,
    StepWatchdog,
    TcpKVCommitBarrier,
)
from torchrec_tpu_torch.reliability.fault_injection import (
    ProcessFault,
    ProcessFaultPlan,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_watchdog_fires_after_budget_and_disarms_cleanly():
    calls = []
    wd = StepWatchdog(0.1, _exit_fn=calls.append)
    with wd.armed("stuck-step"):
        time.sleep(0.4)
    assert calls == [EXIT_PEER_FAILURE] and wd.expired
    calls.clear()
    wd2 = StepWatchdog(0.2, _exit_fn=calls.append)
    with wd2.armed("fast-step"):
        pass
    time.sleep(0.35)
    assert calls == [] and not wd2.expired


def test_heartbeat_beacon_refreshes_and_carries_fields(tmp_path):
    path = str(tmp_path / "hb" / "rank_0.json")
    hb = Heartbeat(path, interval_s=0.05)
    hb.start()
    try:
        hb.beat(step=3, applied=2)
        body = json.load(open(path))
        assert body["step"] == 3 and body["applied"] == 2
        m0 = os.stat(path).st_mtime
        time.sleep(0.2)
        assert os.stat(path).st_mtime > m0
    finally:
        hb.stop()


def test_process_fault_plan_env_round_trip_and_queries(monkeypatch):
    plan = ProcessFaultPlan([
        ProcessFault(rank=1, step=3, kind="kill"),
        ProcessFault(rank=0, step=2, kind="kill_mid_save", gen=1),
        ProcessFault(rank=-1, step=4, kind="coordinator_drop"),
        ProcessFault(rank=0, step=0, kind="kill_mid_reshard"),
    ])
    monkeypatch.setenv(ProcessFaultPlan.ENV, plan.to_env())
    back = ProcessFaultPlan.from_env()
    assert back.faults == plan.faults
    assert back.kill_mid_save_step(0, 1) == 2
    assert back.kill_mid_save_step(0, 0) is None
    assert back.coordinator_drop_step(0) == 4
    assert back.coordinator_drop_step(1) is None
    assert back.migration_kill_phase(0, 0) == "reshard"
    back.maybe_fire(rank=0, gen=0, step=3)
    back.maybe_fire(rank=1, gen=0, step=2)
    assert back.fired == []
    with pytest.raises(ValueError, match="unknown process fault kind"):
        ProcessFault(rank=0, step=1, kind="meteor")
    a = ProcessFaultPlan.seeded(7, world=4, max_step=10, n_faults=3)
    b = ProcessFaultPlan.seeded(7, world=4, max_step=10, n_faults=3)
    assert a.faults == b.faults and len(a.faults) == 3


def test_flight_recorder_dumps_atomically(tmp_path):
    path = str(tmp_path / "flight" / "rank_0.json")
    rec = FlightRecorder(path, capacity=4, meta={"rank": 0},
                         autodump_interval=2)
    prev = install_recorder(rec)
    try:
        assert current_recorder() is rec
        for s in range(5):
            rec.record_step(s, loss=torch.tensor(0.5), applied=s)
        rec.note("bad_step", strikes=torch.tensor([1, 2]))
        assert rec.dump("nan_step") == path
        body = FlightRecorder.read_dump(path)
        assert body["reason"] == "nan_step" and body["last_step"] == 4
        assert len(body["steps"]) == 4 and body["steps"][-1]["loss"] == 0.5
        assert body["events"][0]["strikes"].startswith("<tensor")
        assert body["meta"]["rank"] == 0 and rec.dump_count == 3
        assert not [n for n in os.listdir(os.path.dirname(path))
                    if ".tmp." in n]
    finally:
        uninstall_recorder()
        if prev is not None:
            install_recorder(prev)


@pytest.fixture
def kv_server():
    server = TcpKVServer()
    yield server
    server.stop()


def test_tcp_kv_round_trip_and_caps(kv_server):
    kv = TcpKV(f"127.0.0.1:{kv_server.port}/ns", dim=3)
    try:
        kv.put(np.array([5, -2]), np.arange(6, dtype=np.float32).reshape(2, 3))
        rows, found = kv.get(np.array([-2, 7, 5]))
        assert found.tolist() == [True, False, True]
        np.testing.assert_array_equal(rows[0], [3, 4, 5])
        assert len(kv) == 2 and kv.keys().tolist() == [-2, 5]
        with pytest.raises(ValueError, match="conflicts"):
            TcpKV(f"127.0.0.1:{kv_server.port}/ns", dim=4)
        with pytest.raises(ValueError, match="dim"):
            TcpKV(f"127.0.0.1:{kv_server.port}/x", dim=MAX_DIM + 1)
    finally:
        kv.close()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_tcp_kv_wire_protocol_matches_jax(server_pkg):
    """Each package's client against the other's server: the same bytes
    on the wire (handshake, PUT, GET, LEN, KEYS, the dim conflict)."""
    server = JTcpKVServer() if server_pkg == "jax" else TcpKVServer()
    client_cls, other_cls = ((TcpKV, JTcpKV) if server_pkg == "jax"
                             else (JTcpKV, TcpKV))
    addr = f"127.0.0.1:{server.port}/shared"
    try:
        a, b = client_cls(addr, dim=2), other_cls(addr, dim=2)
        rows = np.array([[1.5, -2.0], [3.25, 4.0]], np.float32)
        a.put(np.array([10, 11]), rows)
        got, found = b.get(np.array([11, 10, 12]))
        assert found.tolist() == [True, True, False]
        np.testing.assert_array_equal(got[:2], rows[::-1])
        b.put(np.array([12]), np.ones((1, 2), np.float32))
        assert len(a) == len(b) == 3
        assert a.keys().tolist() == b.keys().tolist() == [10, 11, 12]
        with pytest.raises(ValueError):
            client_cls(addr, dim=5)
        a.close()
        b.close()
    finally:
        server.stop()


def test_commit_barrier_protocol(kv_server):
    addr = f"127.0.0.1:{kv_server.port}"
    b0 = TcpKVCommitBarrier(addr, "t", rank=0, world=2, deadline_s=0.5)
    b1 = TcpKVCommitBarrier(addr, "t", rank=1, world=2, deadline_s=5.0)
    try:
        b0.prepare(0)
        with pytest.raises(BarrierTimeout, match="PREPARED ack"):
            b0.wait_all_prepared(0)
        b1.prepare(0)
        b0.wait_all_prepared(0)
        b0.commit(0)
        b1.wait_committed(0)
        with pytest.raises(BarrierTimeout, match="COMMIT record"):
            TcpKVCommitBarrier(addr, "t", rank=1, world=2,
                               deadline_s=0.3).wait_committed(1)
    finally:
        b0.close()
        b1.close()


def _tiny_dmp():
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import table_wise_plan

    tables = tuple(EmbeddingBagConfig(num_embeddings=h, embedding_dim=8,
                                      name=f"t{k}", feature_names=[k])
                   for k, h in zip("ab", (64, 40)))
    dmp = DistributedModelParallel(
        DLRM(EmbeddingBagCollection(tables, device="meta"), 4, (8, 8),
             (8, 1)), tables, table_wise_plan(tables), 2, {"a": 4, "b": 2},
        device="cpu")
    return dmp, dmp.init(torch.Generator().manual_seed(3))


def test_two_phase_save_commits_only_after_all_acks(kv_server, tmp_path):
    dmp, state = _tiny_dmp()
    addr = f"127.0.0.1:{kv_server.port}"
    d = str(tmp_path / "ck")
    b0 = TcpKVCommitBarrier(addr, "g0", rank=0, world=2, deadline_s=0.5)
    ck = Checkpointer(d, commit_barrier=b0)
    with pytest.raises(BarrierTimeout):
        ck.save(dmp, state)
    assert ck.latest_step() is None
    assert [n for n in os.listdir(d) if n.startswith("step_")] == []
    assert [n for n in os.listdir(d) if n.startswith(".tmp_")] == []
    b1 = TcpKVCommitBarrier(addr, "g0", rank=1, world=2, deadline_s=10.0)
    ck.commit_barrier = TcpKVCommitBarrier(addr, "g0", rank=0, world=2,
                                           deadline_s=10.0)
    peer_done = []

    def peer():
        b1.prepare(0)
        b1.wait_committed(0)
        peer_done.append(True)

    t = threading.Thread(target=peer)
    t.start()
    ck.save(dmp, state)
    t.join(timeout=10)
    assert peer_done == [True] and ck.latest_step() == 0
    assert "fused_tables" in ck._read_payload(0)
    for b in (b0, b1, ck.commit_barrier):
        b.close()


def test_commit_barrier_excludes_async_save(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        Checkpointer(str(tmp_path), async_save=True, commit_barrier=object())


# -- the supervisor over fake workers --------------------------------------

_FAKE_WORKER = r'''
import json, os, sys, time

mode = sys.argv[1]
hb_dir = os.environ["TORCHREC_ELASTIC_HB_DIR"]
rank = int(os.environ["TORCHREC_MP_PROCESS_ID"])
gen = int(os.environ["TORCHREC_ELASTIC_GEN"])
path = os.path.join(hb_dir, f"rank_{rank}.json")

def beat(step=0, applied=0):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "applied": applied}, f)
    os.replace(tmp, path)

beat()
if mode == "alwayscrash":
    sys.exit(1)
if mode == "ok" or gen > 0:
    for i in range(3):
        time.sleep(0.05)
        beat(step=i + 1, applied=i + 1)
    sys.exit(0)
if mode == "crash1" and rank == 1:
    sys.exit(3)
if mode == "peer":
    sys.exit(113)
if mode == "hang" and rank == 1:
    time.sleep(600)
while True:
    time.sleep(0.05)
    beat(step=1)
'''


@pytest.fixture
def fake_worker(tmp_path):
    p = tmp_path / "fake_worker.py"
    p.write_text(_FAKE_WORKER)
    return str(p)


def _supervisor(fake_worker, tmp_path, mode, **kw):
    kw.setdefault("num_processes", 2)
    kw.setdefault("poll_interval_s", 0.02)
    kw.setdefault("hang_timeout_s", 0.8)
    kw.setdefault("startup_grace_s", 60.0)
    kw.setdefault("generation_timeout_s", 60.0)
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("with_kv", False)
    n = kw.pop("num_processes")
    return ElasticSupervisor(fake_worker, n, args=[mode],
                             run_dir=str(tmp_path / f"run_{mode}"), **kw)


def _assert_no_orphans(report):
    for g in report.generations:
        for pid in g.pids:
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                continue
            raise AssertionError(f"orphaned worker pid {pid}")


def test_supervisor_clean_generation(fake_worker, tmp_path):
    report = _supervisor(fake_worker, tmp_path, "ok").run()
    assert report.ok and report.restarts == 0
    assert report.generations[0].ok and report.generations[0].failures == []
    _assert_no_orphans(report)


def test_supervisor_detects_crash_tears_down_and_shrinks(fake_worker,
                                                         tmp_path):
    sup = _supervisor(fake_worker, tmp_path, "crash1")
    report = sup.run()
    assert report.ok and report.restarts == 1
    gen0, gen1 = report.generations
    assert [f.rank for f in gen0.failures] == [1]
    assert gen0.failures[0].cause == "crash"
    assert gen0.failures[0].returncode == 3
    assert gen1.world == 1 and gen1.ok
    assert report.detect_latency_s < 5.0 and report.mttr_s is not None
    assert report.postmortem_path and os.path.exists(report.postmortem_path)
    _assert_no_orphans(report)
    assert os.path.exists(sup.log_path(0, 0))
    assert os.path.exists(sup.log_path(0, 1))


def test_supervisor_detects_hang_via_heartbeat_staleness(fake_worker,
                                                         tmp_path):
    report = _supervisor(fake_worker, tmp_path, "hang").run()
    assert report.ok and report.restarts == 1
    assert any(f.cause == "hang" and f.rank == 1
               for f in report.generations[0].failures)
    _assert_no_orphans(report)


def test_supervisor_peer_failure_keeps_world_size(fake_worker, tmp_path):
    report = _supervisor(fake_worker, tmp_path, "peer").run()
    assert report.ok and report.restarts == 1
    gen0, gen1 = report.generations
    assert {f.cause for f in gen0.failures} == {"peer"}
    assert gen1.world == 2
    _assert_no_orphans(report)


def test_supervisor_classifies_collateral_collective_deaths(fake_worker,
                                                            tmp_path):
    sup = _supervisor(fake_worker, tmp_path, "unused")
    os.makedirs(os.path.dirname(sup.log_path(0, 0)), exist_ok=True)
    with open(sup.log_path(0, 0), "w") as f:
        f.write("RuntimeError: [gloo/transport/tcp/pair.cc:553] Connection "
                "closed by peer [127.0.0.1]:1203\n")
    with open(sup.log_path(0, 1), "w") as f:
        f.write("Traceback ... ValueError: my own bug\n")
    with open(sup.log_path(0, 2), "w") as f:
        f.write("RuntimeError: The server socket has failed to bind: "
                "Address already in use\n")
    assert sup._classify_exit(0, 0, 1) == "peer"
    assert sup._classify_exit(0, 1, 1) == "crash"
    assert sup._classify_exit(0, 1, EXIT_PEER_FAILURE) == "peer"
    assert sup._classify_exit(0, 7, 1) == "crash"
    assert sup._classify_exit(0, 2, 1) == "infra"


def test_supervisor_relaunch_budget_exhaustion(fake_worker, tmp_path):
    with pytest.raises(ElasticJobFailed) as ei:
        _supervisor(fake_worker, tmp_path, "alwayscrash", num_processes=1,
                    max_relaunches=2).run()
    report = ei.value.report
    assert not report.ok and len(report.generations) == 3
    _assert_no_orphans(report)


# -- one real drill of elastic_demo.py on gloo ------------------------------


def test_elastic_drill_kill_resume_matches_clean_restart(tmp_path):
    run_dir = str(tmp_path / "run")
    ckpt = os.path.join(run_dir, "ckpt")
    out = os.path.join(run_dir, "result.json")
    sup = ElasticSupervisor(
        elastic_demo.__file__, 2,
        args=["--steps", "6", "--ckpt", ckpt, "--out", out, "--seed", "11",
              "--device", "cpu"],
        run_dir=run_dir,
        fault_plan=ProcessFaultPlan([ProcessFault(rank=1, step=3,
                                                  kind="kill")]),
        max_relaunches=2, hang_timeout_s=30.0, generation_timeout_s=120.0,
        env_extra={"PYTHONPATH": REPO_ROOT})
    report = sup.run()
    assert report.ok and report.restarts == 1 and report.final_world == 1
    gen0, gen1 = report.generations
    assert gen0.world == 2 and gen1.world == 1
    assert [(f.rank, f.cause) for f in gen0.failures] == [(1, "crash")]
    _assert_no_orphans(report)
    with open(out) as f:
        result = json.load(f)
    assert result["resumed_from"] == 3 and result["final_step"] == 6
    assert result["world"] == 1 and result["digest"]
    # the oracle: a clean world-1 run from a copy of the committed step 3
    shutil.copytree(os.path.join(ckpt, "step_3"),
                    str(tmp_path / "clean" / "step_3"))
    clean = elastic_demo.run(6, str(tmp_path / "clean"), seed=11,
                             device="cpu")
    assert clean["resumed_from"] == 3
    assert clean["digest"] == result["digest"]
