"""The port stands alone: ``torchrec_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``torchrec_tpu``."""

import os
import pkgutil
import re
import subprocess
import sys

import torchrec_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "torchrec_tpu_torch")

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|torchrec_tpu)(?:[.\s,]|$)",
    re.MULTILINE,
)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            torchrec_tpu_torch.__path__, prefix="torchrec_tpu_torch."
        )
    )


def test_every_module_imports_without_jax():
    modules = _port_modules()
    for m in ("ops.tbe", "ops.tbe_backward", "ops.fused_update",
              "inference.serving", "optim.adagrad", "parallel.types",
              "parallel.grouped", "parallel.embeddingbag",
              "parallel.model_parallel", "parallel.sharding.tw",
              "modules.embedding_modules", "sparse.validator",
              "sparse.tensor_dict", "parallel.planner.planners",
              "parallel.planner.provider", "ir.serializer",
              "obs.assumptions", "optim.warmup", "metrics.metric_module",
              "datasets.criteo", "examples.dlrm.dlrm_main",
              "parallel.embedding", "parallel.chunked_a2a",
              "parallel.comm", "parallel.multiprocess",
              "parallel.sharding.rw", "parallel.sequence_model_parallel",
              "models.experimental.bert4rec",
              "models.experimental.transformerdlrm", "models.deepfm",
              "models.two_tower", "modules.deepfm",
              "modules.embedding_tower", "modules.feature_processor",
              "modules.regroup", "modules.crossnet", "optim.adam",
              "ops.ring_attention", "datasets.movielens",
              "examples.bert4rec.main", "inference.bucketed_serving",
              "inference.mesh", "inference.grpc_server",
              "inference.protos.predictor_pb2", "obs.registry",
              "ops.custom_ops", "inference.predict_factory", "robustness",
              "robustness.sanitize", "robustness.policy",
              "robustness.quarantine", "utils.profiling",
              "parallel.train_pipeline", "parallel.sharding.hier",
              "checkpoint", "parallel.dynamic_sharding",
              "obs.flight_recorder", "dynamic", "dynamic.tcp_kv",
              "reliability", "reliability.fault_injection",
              "reliability.train_loop", "reliability.elastic",
              "reliability.elastic_demo", "convert", "tiered",
              "tiered.storage", "tiered.collection", "tiered.prefetch",
              "tiered.pipeline", "modules.host_offload", "obs.health",
              "reliability.migration", "reliability.migration_demo",
              "dynamic.kv_store", "dynamic.vocab", "modules.mc_modules",
              "inference.freshness", "parallel.production",
              "examples.zch.main", "obs.spans", "obs.device_poll",
              "obs.report", "obs.__main__", "metrics.computations",
              "metrics.cpu_offloaded", "utils.benchmark",
              "utils.benchmark_pipeline", "utils.benchmark_comms",
              "utils.bench_results", "parallel.hier_bench_worker"):
        assert f"torchrec_tpu_torch.{m}" in modules, m
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'torchrec_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_source_scan_finds_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        hit = _FORBIDDEN.search(src)
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_forbidden_pattern_catches_jax_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from torchrec_tpu.ops import quant_ops",
                 "import torchrec_tpu", "    from flax import linen"):
        assert _FORBIDDEN.search(line), line
    for line in ("import torchrec_tpu_torch", "from torchrec_tpu_torch.ops "
                 "import tbe", "# jax is the reference", "import jaxtyping"):
        assert not _FORBIDDEN.search(line), line
