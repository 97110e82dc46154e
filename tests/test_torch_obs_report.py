"""``python -m torchrec_tpu_torch.obs report`` (``obs/report.py``) against
the JAX package's report, and a traced tiered pipeline in both packages.

* The same hand-built artifacts (``events.jsonl`` spans with measured
  ``seconds``, two ``metrics.jsonl`` dump rows carrying table, wire,
  health, recovery, mesh and freshness families, a Chrome trace, a
  ``PlanAssumptions`` file) give equal ``report()`` dicts, the same
  printed report and equal ``--placement-features`` rows in both
  packages; the CLI with no artifacts exits 2, and over the artifacts 0.
* A tiny ``TieredTrainPipeline`` with prefetch (4,000 logical rows
  through a 1,024-slot cache, D=16, B=32, 4 ids an example: the JAX
  ``obs`` bench's smoke size), traced in each package over the same
  stream: each span name appears the same number of times, and each
  report's prefetch overlap equals its own ``TieredStats`` within 1e-9.
"""

import io
import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu import obs as jobs
from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.inference import serving as jserving
from torchrec_tpu.models.dlrm import DLRM as JDLRM
from torchrec_tpu.modules.embedding_configs import EmbeddingBagConfig as JCfg
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import EmbeddingBagCollection
from torchrec_tpu.obs import report as jreport
from torchrec_tpu.obs.assumptions import PlanAssumptions as JAssumptions
from torchrec_tpu.obs.assumptions import TableAssumptions as JTableAssume
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
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.tiered import TieredCollection as JCollection
from torchrec_tpu.tiered import TieredTable as JTable
from torchrec_tpu.tiered import TieredTrainPipeline as JPipeline
from torchrec_tpu.tiered import storage as jstorage
from torchrec_tpu_torch import obs
from torchrec_tpu_torch.convert import train_state_from_jax
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.obs import report as preport
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import table_wise_plan
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor
from torchrec_tpu_torch.tiered import (
    TieredCollection,
    TieredTable,
    TieredTrainPipeline,
    opt_slot_widths,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the report over hand-built artifacts ----------------------------------------


def _artifacts(d):
    spans = []
    for i in range(6):
        spans.append({"event": "span", "name": "pipeline/step_dispatch",
                      "dur_s": 0.010 + 0.001 * i, "tid": 1,
                      "thread": "MainThread", "depth": 0, "mono": i})
        spans.append({"event": "span", "name": "pipeline/host_load",
                      "dur_s": 0.0005 * i, "tid": 1, "attrs": {"n": 1}})
        spans.append({"event": "span", "name": "tiered/prefetch_stage",
                      "dur_s": 0.012, "tid": 2,
                      "attrs": {"seconds": 0.0113 + 1e-4 * i}})
        spans.append({"event": "span", "name": "tiered/prefetch_wait",
                      "dur_s": 0.003, "tid": 1,
                      "attrs": {"seconds": 0.0021 * (i % 2)}})
    events = os.path.join(d, "events.jsonl")
    with open(events, "w") as f:
        f.write(json.dumps({"event": "plan", "t": 0.0}) + "\n")
        for s in spans:
            f.write(json.dumps(s) + "\n")
        f.write('{"event": "span", "trunc')  # a crash's torn last line
    last = {
        "tiered/big/hit_rate": 0.9, "tiered/big/lookup_count": 100.0,
        "tiered/big/occupancy_rate": 0.5, "zch/big/eviction_count": 5.0,
        "bucketing/q/mean_occupancy": 12.5,
        "wire/all_to_all:fwd/bytes_per_step": 64.0,
        "wire/link:ici/bytes_per_step": 48.0,
        "wire/link:dcn/bytes_per_step": 16.0,
        "obs/wire_bytes_per_step": 64.0,
        "tiered/bucketing/batches": 3.0, "obs/pump/dropped_count": 0.0,
        "health/big/occupancy_drift": 0.3, "health/big/occupancy_live": 0.5,
        "health/big/occupancy_expected": 0.4,
        "health/big/occupancy_alarm": 0.0,
        "health/monitor/alert_count": 2.0, "health/monitor/check_count": 9.0,
        "elastic/hist/restore_ms/p50": 12.0,
        "elastic/hist/restore_ms/p99": 30.0,
        "elastic/hist/restore_ms/count": 3.0,
        "mesh/r0/healthy": 1.0, "mesh/r0/queue_depth": 2.0,
        "mesh/r1/healthy": 0.0, "mesh/r1/ejected": 1.0,
        "mesh/request_count": 40.0, "mesh/request_latency_ms/p50": 3.5,
        "freshness/big/staleness_steps": 1.0,
        "freshness/big/applied_rows": 77.0,
        "freshness/rollback_count": 1.0, "freshness/generation": 4.0,
    }
    metrics = os.path.join(d, "metrics.jsonl")
    with open(metrics, "w") as f:
        f.write(json.dumps({"t": 0.0, "step": 3, "metrics": {
            "health/monitor/alert_count": 5.0}}) + "\n")
        f.write(json.dumps({"t": 1.0, "step": 7, "metrics": last,
                            "plan_assumptions": "abc123"}) + "\n")
    trace = os.path.join(d, "trace.json")
    t = obs.SpanTracer()
    with t.span("a/b"):
        with t.span("a/c"):
            pass
    t.export_chrome_trace(trace)
    assume = os.path.join(d, "assumptions.json")
    JAssumptions(tables={"big": JTableAssume(expected_occupancy=0.4)},
                 wire_bytes_per_step={"ici": 40.0, "dcn": 32.0},
                 world_size=4, hierarchical=True).save(assume)
    return events, metrics, trace, assume


def test_report_matches_jax(tmp_path):
    events, metrics, trace, assume = _artifacts(str(tmp_path))
    outs, texts = [], []
    for mod, tag in ((jreport, "jax"), (preport, "port")):
        buf = io.StringIO()
        place = str(tmp_path / f"placement_{tag}.jsonl")
        outs.append(mod.report(events, metrics, trace, place, out=buf,
                               health=True, mesh=True,
                               assumptions_path=assume))
        texts.append(buf.getvalue())
        outs[-1]["rows_file"] = [json.loads(ln) for ln in open(place)]
    assert outs[0] == outs[1]
    assert texts[0].replace("placement_jax", "placement_port") == texts[1]
    got = outs[1]
    assert preport.PLACEMENT_FEATURES_SCHEMA_VERSION == \
        jreport.PLACEMENT_FEATURES_SCHEMA_VERSION
    assert got["overlap"]["prefetch_overlap_ratio"] == pytest.approx(
        1 - 3 * 0.0021 / sum(0.0113 + 1e-4 * i for i in range(6)))
    # the bucketing pipeline's per-key mean occupancy makes ``q`` a row
    assert [r["table"] for r in got["placement_features"]] == ["big", "q"]
    assert got["trace_events"] == 2 and got["health"]["alerts"] == 5.0
    assert got["flagship"]["links"]["dcn"]["ratio"] == 0.5


def test_report_cli(tmp_path):
    assert preport.main(["report", "--dir", str(tmp_path / "nope")]) == 2
    _artifacts(str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "torchrec_tpu_torch.obs", "report", "--dir",
         str(tmp_path), "--health", "--placement-features",
         str(tmp_path / "rows.jsonl")],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "## stages (24 spans)" in proc.stdout
    assert "## health" in proc.stdout
    assert len(open(tmp_path / "rows.jsonl").readlines()) == 2


# -- a traced tiered pipeline in both packages -----------------------------------

R, CACHE, D, B, IDS, SIDE, STEPS = 4_000, 1_024, 16, 32, 4, 64, 6
CAPS = {"q": IDS * B, "r": B}
LR = 0.05
JAX_TRACE_TIME_SPANS = ("dense_fwd_bwd", "sparse_backward_fused_update",
                        "sparse_forward")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's id transformer (``csrc/id_transformer.cpp``)
    built with g++ into a private directory for the JAX tables."""
    import ctypes

    from torchrec_tpu_torch.ops import _native

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


def _stream():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        q = (rng.zipf(1.1, size=IDS * B) - 1) % R
        r = rng.randint(0, SIDE, size=B)
        out.append((rng.rand(B, 4).astype(np.float32), q.astype(np.int64),
                    r.astype(np.int64),
                    rng.randint(0, 2, size=(B,)).astype(np.float32)))
    return out


def _lengths():
    return np.concatenate([np.full((B,), IDS), np.ones((B,))]).astype(
        np.int32)


def _drain(pipe, it):
    while True:
        try:
            pipe.progress(it)
        except StopIteration:
            return


def _traced_report(spans, tmp, tag, mod):
    events = os.path.join(tmp, f"events_{tag}.jsonl")
    with open(events, "w") as f:
        for rec in spans:
            f.write(json.dumps({"event": "span", **rec}) + "\n")
    return mod.report(events_path=events, out=io.StringIO())


def test_traced_tiered_pipeline_matches_jax(jax_native, tmp_path):
    raw = _stream()
    w0 = np.random.RandomState(5).uniform(
        -0.05, 0.05, size=(R, D)).astype(np.float32)

    # the JAX package
    tables = tuple(JCfg(num_embeddings=n, embedding_dim=D, name=t,
                        feature_names=[f], pooling=JPooling.SUM)
                   for n, t, f in ((CACHE, "big", "q"), (SIDE, "side", "r")))
    env = JEnv.from_mesh(create_mesh((1,), (MODEL_AXIS,)))
    jdmp = JDMP(
        model=JDLRM(embedding_bag_collection=EmbeddingBagCollection(
            tables=tables), dense_in_features=4,
            dense_arch_layer_sizes=(8, D), over_arch_layer_sizes=(8, 1)),
        tables=tables, env=env,
        plan={t.name: JPS(JST.TABLE_WISE, ranks=[0]) for t in tables},
        batch_size_per_device=B, feature_caps=CAPS, dense_in_features=4,
        fused_config=JFused(optim=JOptim.ADAGRAD, learning_rate=LR),
        dense_optimizer=optax.adagrad(LR))
    jstate = jdmp.init(jax.random.key(0))
    jstart = jax.tree.map(np.asarray, jstate)
    jcoll = JCollection({"big": JTable(
        "big", R, D, CACHE, opt_slots=jstorage.opt_slot_widths(
            JFused(optim=JOptim.ADAGRAD, learning_rate=LR), D),
        init_fn=lambda s, e: w0[s:e], eviction_policy="lru")}, {"q": "big"})
    jbatches = [JBatch(jnp.asarray(d), JKJT.from_lengths_packed(
        ["q", "r"], np.concatenate([q, r]), _lengths(),
        caps=[CAPS["q"], CAPS["r"]]), jnp.asarray(y)) for d, q, r, y in raw]
    jt = jobs.SpanTracer()
    jobs.install_tracer(jt)
    try:
        with trace_kernels(pooled="xla", update="xla"):
            jpipe = JPipeline(jdmp, jstate, env, jcoll)
            _drain(jpipe, iter(jbatches))
            jpipe.close()
    finally:
        jobs.uninstall_tracer()

    # the port, from the same start state
    ptables = tuple(EmbeddingBagConfig(num_embeddings=n, embedding_dim=D,
                                       name=t, feature_names=[f])
                    for n, t, f in ((CACHE, "big", "q"),
                                    (SIDE, "side", "r")))
    fc = FusedOptimConfig(optim=EmbOptimType.ADAGRAD, learning_rate=LR)
    dmp = DistributedModelParallel(
        DLRM(TEBC(ptables, device="meta"), 4, (8, D), (8, 1)), ptables,
        table_wise_plan(ptables), B, CAPS, fused_config=fc,
        dense_optimizer=adagrad(LR), device="cpu")
    st = train_state_from_jax(jstart, device="cpu")
    coll = TieredCollection({"big": TieredTable(
        "big", R, D, CACHE, opt_slots=opt_slot_widths(fc, D),
        init_fn=lambda s, e: w0[s:e], eviction_policy="lru")}, {"q": "big"})
    batches = [Batch(torch.from_numpy(d), KeyedJaggedTensor.from_lengths_packed(
        ["q", "r"], torch.from_numpy(np.concatenate([q, r])),
        torch.from_numpy(_lengths()), caps=[CAPS["q"], CAPS["r"]]),
        torch.from_numpy(y)) for d, q, r, y in raw]
    pt = obs.SpanTracer()
    obs.install_tracer(pt)
    try:
        pipe = TieredTrainPipeline(dmp, st, coll)
        _drain(pipe, iter(batches))
        pipe.close()
    finally:
        obs.uninstall_tracer()

    # the JAX step's ``annotate`` phases sit inside the jitted step, so
    # they record once, while it is traced (a compile's time); the port
    # compiles nothing and has no such span
    jcount = Counter(s["name"] for s in jt.spans
                     if s["name"] not in JAX_TRACE_TIME_SPANS)
    assert Counter(s["name"] for s in jt.spans
                   if s["name"] in JAX_TRACE_TIME_SPANS) == dict.fromkeys(
                       JAX_TRACE_TIME_SPANS, 1)
    pcount = Counter(s["name"] for s in pt.spans)
    assert pcount == jcount
    assert pcount["pipeline/step_dispatch"] == STEPS
    assert pcount["tiered/prefetch_wait"] > 0
    assert coll.stats.per_table["big"] == jcoll.stats.per_table["big"]
    for spans, stats, tag, mod in ((jt.spans, jcoll.stats, "jax", jreport),
                                   (pt.spans, coll.stats, "port", preport)):
        rep = _traced_report(spans, str(tmp_path), tag, mod)
        assert abs(rep["overlap"]["prefetch_overlap_ratio"]
                   - stats.prefetch_overlap_ratio()) <= 1e-9, tag
        assert rep["overlap"]["data_load_overlap_ratio"] is not None
