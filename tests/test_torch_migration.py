"""The port's drift-triggered plan migration
(``torchrec_tpu_torch/reliability/migration.py``, ``migration_demo.py``)
against the JAX package's.

* ``ReplanTrigger``'s damping (edge arming, cooldown, the rejection
  cooldown, hysteresis, world changes) decides at every step what the
  JAX trigger decides on the same monitor feeds.
* A plan round-trips through ``TORCHREC_ELASTIC_PLAN`` (inline and as a
  file) with every runtime field, readable by the JAX package too.
* One 2-rank gloo launch on the CPU runs the drill's arms under the JAX
  planner's device constants: the big table's occupancy collapses at
  step 5, the monitor alarms, and the migrator decides what the JAX
  ``migration_demo`` decides at world 2 (the same attempts, outcomes and
  steps, RW -> DP; the improvements within ``rtol=1e-6``, both from
  float64 pricing of the same plans), with no committed step lost; a
  clean restart from a copy of the migration's committed step under the
  new plan ends on the migrated run's checkpoint digest (the same bytes);
  a clean arm raises no alert.
* The SIGKILL-mid-migration matrix (supervised, ``kill_mid_reshard`` /
  ``kill_mid_validate``) is ``slow``-marked, as in
  ``tests/test_migration.py``.
"""

import json
import os

import numpy as np
import pytest

from torchrec_tpu.ir.serializer import deserialize_plan as jdeserialize
from torchrec_tpu.obs import HealthMonitor as JMonitor
from torchrec_tpu.obs import MetricsRegistry as JRegistry
from torchrec_tpu.obs import PlanAssumptions as JPlan
from torchrec_tpu.obs import TableAssumptions as JTable
from torchrec_tpu.parallel.planner import types as jtypes
from torchrec_tpu.reliability import migration_demo as jdemo
from torchrec_tpu.reliability.migration import ReplanTrigger as JTrigger
from torchrec_tpu_torch.obs import (
    HealthMonitor,
    MetricsRegistry,
    PlanAssumptions,
    TableAssumptions,
)
from torchrec_tpu_torch.parallel.multiprocess import launch
from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
from torchrec_tpu_torch.reliability.migration import (
    ENV_PLAN,
    MigrationReport,
    ReplanTrigger,
    plan_from_env,
    serialize_plan_for_env,
)
from torchrec_tpu_torch.reliability import migration_demo
from torchrec_tpu_torch.utils.profiling import counter_key

TARGET, DRIFT, CLEAN = 16, 5, 8
JAX_PROFILE = dict(jtypes.TPU_PROFILES[jtypes.TpuVersion.V5P], host_bw=32)


def _pair(expected=0.9):
    kw = dict(expected_occupancy=expected, feature_names=["f"])
    reg, jreg = MetricsRegistry(), JRegistry()
    return (reg, HealthMonitor(reg, PlanAssumptions(
        tables={"t": TableAssumptions(**kw)}), warmup=2, min_consecutive=2),
        jreg, JMonitor(jreg, JPlan(tables={"t": JTable(**kw)}), warmup=2,
                       min_consecutive=2))


@pytest.mark.parametrize("schedule", [
    # (occupancy by step, outcomes recorded when a trigger fires)
    ([0.9] * 4 + [0.1] * 30, ["completed"]),
    ([0.1] * 30, ["rejected_improvement", "rejected_same_plan",
                  "completed"]),
    ([0.1] * 6 + [0.9] * 20, []),
    ([0.9] * 3 + [0.1] * 10 + [0.9] * 5 + [0.1] * 20,
     ["rolled_back", "completed", "completed"]),
], ids=["edge_cooldown", "rejections", "hysteresis", "rollback_recross"])
@pytest.mark.parametrize("cooldowns", [(10, 3), (0, None), (50, 2)])
def test_trigger_decides_as_jax(schedule, cooldowns):
    occs, outcomes = schedule
    reg, mon, jreg, jmon = _pair()
    cd, rcd = cooldowns
    trig = ReplanTrigger(mon, cooldown_steps=cd, reject_cooldown_steps=rcd)
    jtrig = JTrigger(jmon, cooldown_steps=cd, reject_cooldown_steps=rcd)
    outcomes = list(outcomes)
    fired = 0
    for step, occ in enumerate(occs):
        for r in (reg, jreg):
            r.gauge(counter_key("kjt", "f", "occupancy_rate"), occ)
        mon.observe(step)
        jmon.observe(step)
        a, b = trig.should_fire(step), jtrig.should_fire(step)
        assert a == b and trig.armed == jtrig.armed
        if a is not None and outcomes:
            out = outcomes.pop(0)
            trig.record_outcome(step, out)
            jtrig.record_outcome(step, out)
            fired += 1
    assert trig.alarm_onsets == jtrig.alarm_onsets
    if schedule[1]:
        assert fired >= 1


def test_trigger_world_change_as_jax():
    for outcome in ("rejected_same_plan", "rejected_improvement",
                    "rolled_back", "completed"):
        trig, jtrig = ReplanTrigger(None, 2), JTrigger(None, 2)
        for t in (trig, jtrig):
            t.note_world_change(4, 2)
        assert trig.should_fire(0) == jtrig.should_fire(0) == (
            "world_change:4->2")
        trig.record_outcome(0, outcome)
        jtrig.record_outcome(0, outcome)
        for step in (1, 5, 100):
            assert trig.should_fire(step) == jtrig.should_fire(step)
        assert trig.armed == jtrig.armed


def test_env_plan_round_trip(tmp_path, monkeypatch):
    """A planned plan through ``TORCHREC_ELASTIC_PLAN``, inline and as a
    file: the same plan back, every runtime field; the JAX package reads
    the same payload to the same plan; no variable, no plan."""
    w = migration_demo.Widths()
    plan = EmbeddingShardingPlanner(
        world_size=2, constraints=migration_demo.plan_constraints(w),
        batch_size_per_device=w.batch).plan(migration_demo.table_configs(w))
    payload = serialize_plan_for_env(plan)
    monkeypatch.delenv(ENV_PLAN, raising=False)
    assert plan_from_env() is None
    monkeypatch.setenv(ENV_PLAN, payload)
    got = plan_from_env()
    assert dict(got) == dict(plan)
    path = tmp_path / "plan.json"
    path.write_text(payload)
    monkeypatch.setenv(ENV_PLAN, str(path))
    assert dict(plan_from_env()) == dict(plan)
    jplan = jdeserialize(payload)
    assert {t: ps.sharding_type.value for t, ps in jplan.items()} == {
        t: ps.sharding_type.value for t, ps in plan.items()}
    assert {t: ps.ranks for t, ps in jplan.items()} == {
        t: ps.ranks for t, ps in plan.items()}


def test_report_records_phase_seconds():
    r = MigrationReport(reason="drift:t/occupancy", step=3, outcome="")
    assert r.phase_seconds == {} and r.duration_s == 0.0


@pytest.fixture(scope="module")
def jax_drill(tmp_path_factory):
    """The JAX recipe's drift arm at world 2 (two CPU devices)."""
    tmp = tmp_path_factory.mktemp("jax_drill")
    return jdemo.run(TARGET, str(tmp / "ckpt"), ndev=2, seed=11,
                     drift_step=DRIFT, migrate=True)


def test_two_rank_drill_matches_jax(jax_drill, tmp_path):
    """One 2-rank gloo launch: the drift arm migrates as the JAX recipe
    does, a clean restart under the new plan reproduces its bytes, the
    clean arm never alarms."""
    results = launch(
        _drill_rank, 2, args=(str(tmp_path), TARGET, DRIFT, CLEAN,
                              JAX_PROFILE), timeout=400)
    r0 = results[0]
    drift, restart, clean = r0["drift"], r0["restart"], r0["clean"]
    jreps = jax_drill["migration"]["reports"]
    reps = drift["migration"]["reports"]
    assert [(r["step"], r["outcome"], r["committed_step"]) for r in reps] \
        == [(r["step"], r["outcome"], r["committed_step"]) for r in jreps]
    for a, b in zip(reps, jreps):
        if b["improvement"] is None:
            assert a["improvement"] is None
        else:
            np.testing.assert_allclose(a["improvement"], b["improvement"],
                                       rtol=1e-6)
    assert drift["initial_plan"] == jax_drill["initial_plan"] == {
        "t_f0": "row_wise", "t_f1": "table_wise"}
    assert drift["final_plan"] == jax_drill["final_plan"] == {
        "t_f0": "data_parallel", "t_f1": "table_wise"}
    assert drift["alarms"] == jax_drill["alarms"] >= 1
    # every step committed: the final step is the target
    assert drift["final_step"] == TARGET
    assert drift["migration"]["rolled_back"] == 0
    done = [r for r in reps if r["outcome"] == "completed"][0]
    assert set(done["phase_seconds"]) == {"quiesce", "commit", "replan",
                                          "reshard", "validate"}
    assert restart["resumed_from"] == done["committed_step"]
    assert restart["digest"] == drift["digest"] is not None
    assert clean["alarms"] == 0 and clean["migration"]["attempts"] == 0
    assert clean["final_plan"] == clean["initial_plan"]
    # both ranks saw the same decisions
    assert [r["outcome"] for r in results[1]["drift"]["migration"][
        "reports"]] == [r["outcome"] for r in reps]


def _drill_rank(*args):
    from torch_migration_workers import drill_rank

    return drill_rank(*args)


@pytest.mark.slow
@pytest.mark.parametrize("phase", ["reshard", "validate"])
def test_kill_mid_migration_resumes_from_the_commit(tmp_path, phase,
                                                     monkeypatch):
    """A supervised worker SIGKILLed inside the reshard window or the
    validation: the relaunch resumes from the committed pre-migration
    step (zero committed-step loss) and finishes the target."""
    from torchrec_tpu_torch.reliability.elastic import ElasticSupervisor
    from torchrec_tpu_torch.reliability.fault_injection import (
        ProcessFault,
        ProcessFaultPlan,
    )

    for k in [k for k in os.environ if k.startswith("TORCHREC_ELASTIC_")]:
        monkeypatch.delenv(k, raising=False)
    run_dir = str(tmp_path / "run")
    out = os.path.join(run_dir, "r.json")
    sup = ElasticSupervisor(
        migration_demo.__file__, 2,
        args=["--steps", str(TARGET), "--ckpt",
              os.path.join(run_dir, "ckpt"), "--out", out, "--seed", "11",
              "--drift-step", str(DRIFT), "--device", "cpu"],
        run_dir=run_dir, fault_plan=ProcessFaultPlan(
            [ProcessFault(rank=1, step=0, kind=f"kill_mid_{phase}", gen=0)]),
        max_relaunches=2, hang_timeout_s=30.0, generation_timeout_s=300.0,
        seed=11)
    report = sup.run()
    assert report.ok and report.restarts == 1, report
    assert report.generations[0].failures[0].cause == "crash"
    with open(sup.log_path(0, 1)) as f:
        log = f.read()
    anchor = int(log.rsplit("committed step ", 1)[1].split(")")[0])
    with open(out) as f:
        r = json.load(f)
    assert r["resumed_from"] == anchor >= DRIFT
    assert r["final_step"] == TARGET
