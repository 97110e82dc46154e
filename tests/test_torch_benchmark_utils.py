"""The port's measurement utilities (``torchrec_tpu_torch/utils/
{benchmark,benchmark_pipeline,benchmark_comms,bench_results}.py``,
``parallel/hier_bench_worker.py``) on the CPU:

* ``benchmark_func`` / ``benchmark_grid`` time a call, write a profiler
  Chrome trace, and record no device peak where there is no card;
* ``measure_overlap_win`` over the port's pipelines on a tiny DMP gives
  the JAX package's keys;
* ``merge_calibration`` from 4 processes at once loses no key, and a
  reader never sees a torn file; ``write_comms_calibration`` writes only
  a CUDA measurement over two or more cards, from process 0;
* the ``bench_results`` store round trip;
* one 2-rank gloo launch: ``benchmark_collectives`` and the qcomm sweep,
  whose ledger bytes equal the ``wire_bytes_per_f32`` model (the JAX
  package's model too), and ``hier_bench_worker``'s smoke A/B with its
  contracts (bitwise flat = two-level on an fp32 DCN leg, the int8 leg
  within tolerance, no overflow, fewer DCN bytes)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from torchrec_tpu.parallel.qcomm import CommType as JCommType
from torchrec_tpu.parallel.qcomm import QCommsConfig as JQComms
from torchrec_tpu.parallel.qcomm import wire_bytes_per_f32 as j_wire_bpf
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel import hier_bench_worker
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.multiprocess import launch
from torchrec_tpu_torch.parallel.qcomm import CommType, QCommsConfig
from torchrec_tpu_torch.parallel.qcomm import wire_bytes_per_f32
from torchrec_tpu_torch.parallel.types import table_wise_plan
from torchrec_tpu_torch.utils import bench_results
from torchrec_tpu_torch.utils.benchmark import (
    benchmark_func,
    benchmark_grid,
    undonated_train_step,
)
from torchrec_tpu_torch.utils.benchmark_comms import (
    merge_calibration,
    write_comms_calibration,
)
from torchrec_tpu_torch.utils.benchmark_pipeline import (
    PIPELINE_VARIANTS,
    measure_overlap_win,
)

import torch_benchmark_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_benchmark_func_and_grid(tmp_path):
    x = torch.ones(64, 64)
    res = benchmark_func("matmul", lambda: x @ x, warmup=1, iters=4,
                         trace_dir=str(tmp_path / "trace"))
    assert res.runtimes_ms.shape == (4,) and res.p50_ms > 0
    assert res.p90_ms >= res.p50_ms and res.mean_ms > 0
    assert res.peak_hbm_bytes == {}  # no card: no device peak
    doc = json.load(open(tmp_path / "trace" / "trace.json"))
    assert doc["traceEvents"]
    assert "matmul: mean=" in str(res)
    grid = benchmark_grid([("a", lambda: x + 1), ("b", lambda: x * 2)],
                          warmup=0, iters=2)
    assert [r.name for r in grid] == ["a", "b"]


def _tiny_dmp():
    keys, hashes = ["a", "b"], [50, 40]
    tables = [EmbeddingBagConfig(num_embeddings=h, embedding_dim=8,
                                 name=f"t{k}", feature_names=[k])
              for k, h in zip(keys, hashes)]
    ds = RandomRecDataset(keys, 16, hashes, [2, 1], num_dense=4,
                          manual_seed=0)
    dmp = DistributedModelParallel(
        DLRM(EmbeddingBagCollection(tables, device="meta"), 4, (8, 8),
             (8, 1)), tables, table_wise_plan(tables), 16,
        dict(zip(keys, ds.caps)), device="cpu")
    it = iter(ds)
    return dmp, dmp.init(torch.Generator().manual_seed(0)), [
        next(it) for _ in range(3)]


def test_pipeline_variants_and_overlap_win():
    dmp, state, batches = _tiny_dmp()
    step = undonated_train_step(dmp)
    state, m = step(state, batches[0])
    assert np.isfinite(float(m["loss"]))
    out = measure_overlap_win(dmp, state, batches, host_delay_s=0.002,
                              iters=3)
    assert set(out) == ({f"{k}_ms" for k in PIPELINE_VARIANTS}
                        | {f"{k}_vs_naive" for k in PIPELINE_VARIANTS[1:]}
                        | {"host_delay_ms"})
    assert out["host_delay_ms"] == 2.0
    assert all(v > 0 for v in out.values())


_WRITER = """
import sys
from torchrec_tpu_torch.utils.benchmark_comms import merge_calibration
w, path = int(sys.argv[1]), sys.argv[2]
for i in range(25):
    merge_calibration({f"w{w}_k{i}": i, "tables": {f"w{w}": i}}, path=path)
"""


def test_merge_calibration_concurrent_writers(tmp_path):
    path = str(tmp_path / "PLANNER_CALIBRATION.json")
    merge_calibration({"hbm_bw": 1.0, "tables": {"seed": 0}}, path=path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, str(w), path],
                              env=env) for w in range(4)]
    torn = reads = 0
    while any(p.poll() is None for p in procs):
        try:
            with open(path) as f:
                json.load(f)
            reads += 1
        except json.JSONDecodeError:
            torn += 1
        time.sleep(0.001)
    assert all(p.wait(timeout=120) == 0 for p in procs)
    assert torn == 0 and reads > 0
    ledger = json.load(open(path))
    assert all(f"w{w}_k{i}" in ledger for w in range(4) for i in range(25))
    assert ledger["tables"] == {"seed": 0, **{f"w{w}": 24 for w in range(4)}}
    assert ledger["hbm_bw"] == 1.0


def test_write_comms_calibration_gates(tmp_path):
    path = str(tmp_path / "cal.json")
    args = dict(eff_gbps=100.0, collective="all_to_all",
                device_kind="NVIDIA H100 80GB HBM3", path=path)
    assert write_comms_calibration(n_cards=4, platform="cpu", **args) is None
    assert write_comms_calibration(n_cards=1, platform="cuda",
                                   **args) is None  # ranks share one card
    assert write_comms_calibration(n_cards=4, platform="cuda",
                                   process_index=1, **args) is None
    assert not os.path.exists(path)
    assert write_comms_calibration(n_cards=4, platform="cuda",
                                   **args) == "ici_bw"
    assert write_comms_calibration(n_cards=8, platform="cuda", n_hosts=2,
                                   **args) == "dcn_bw"
    ledger = json.load(open(path))
    assert ledger["ici_bw"] == ledger["dcn_bw"] == 100.0e9
    assert "4x NVIDIA H100" in ledger["ici_bw_source"]


def test_bench_results_round_trip(tmp_path):
    path = str(tmp_path / "results.jsonl")
    assert bench_results.latest_hardware_result("m", path=path) is None
    cfg = {"B": 8, "D": 16}
    bench_results.record_hardware_result({"metric": "m", "value": 1.0},
                                         "card-a", config=cfg, path=path)
    bench_results.record_hardware_result({"metric": "m", "value": 2.0},
                                         "card-a", path=path)
    with open(path, "a") as f:
        f.write('{"metric": "m", "val')  # a torn last line
    assert bench_results.latest_hardware_result("m", path=path)[
        "value"] == 2.0
    rec = bench_results.latest_hardware_result("m", config=cfg, path=path)
    assert rec["value"] == 1.0 and rec["device"] == "card-a"
    assert rec["config_hash"] == bench_results.config_hash(
        {"D": 16, "B": 8})
    assert bench_results.latest_hardware_result(
        "m", config={"B": 9}, path=path) is None
    assert bench_results.RESULTS_FILE.endswith(
        os.path.join("torchrec_tpu_torch", "BENCH_RESULTS.jsonl"))


def test_gloo_comms_bench_and_hier_worker():
    (flat, sweep, hier), _ = launch(workers.comms_rank, 2, timeout=300)
    n = 2 * workers.ROWS * workers.DIM  # a rank's [N, rows, dim] floats
    assert [r[0].split("[")[0] for r in flat] == [
        "all_to_all", "reduce_scatter", "all_gather"]
    for name, payload, ledger, iters, positive in flat:
        assert payload == ledger == n * 4.0 and iters == 3 and positive
    for prec, rows in sweep.items():
        (name, payload, ledger, _, _), = rows
        port_cfg = (None if prec == "fp32"
                    else QCommsConfig(forward_precision=CommType(prec)))
        jax_cfg = (None if prec == "fp32"
                   else JQComms(forward_precision=JCommType(prec)))
        bpf = wire_bytes_per_f32(port_cfg, "fwd", workers.DIM)
        assert bpf == j_wire_bpf(jax_cfg, "fwd", workers.DIM)
        assert payload == int(n * bpf) and ledger == n * bpf, prec
    assert sorted(sweep) == ["bf16", "fp32", "int8"]
    assert hier["topology"] == "2x1"
    assert hier_bench_worker.contracts_hold(hier), hier
    assert hier["dcn_bytes_hier_int8"] < hier["dcn_bytes_flat_fp32"]
