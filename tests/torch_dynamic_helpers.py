"""Shared pieces of the dynamic-embedding tests (``tests/test_torch_
{kv_store,mc_modules,dynamic_vocab,freshness}.py``): the JAX package's
host library built from ``csrc/`` into a private directory, and the ranks
of the one gloo launch that holds ``SyncedCollisionCollection`` and
``TouchedRowTracker`` across processes.  The rank functions run in
spawned processes and import torch, numpy and the port only."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HOST_SOURCES = ("id_transformer.cpp", "lfu_id_transformer.cpp",
                    "mp_id_transformer.cpp", "kv_store.cpp")


def build_jax_native(out_dir: str) -> ctypes.CDLL:
    """The JAX package's id transformers and KV store (``csrc/``) built
    with g++ into ``out_dir`` and bound under their ``trec_`` names with
    the port's signatures (the same C interface, ``trt_`` there)."""
    from torchrec_tpu_torch.ops import _native

    out = os.path.join(out_dir, "libjax_dynamic.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    out, *(os.path.join(ROOT, "csrc", s)
                           for s in JAX_HOST_SOURCES), "-lpthread"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    for name, (argtypes, restype) in _native._HOST_SIGNATURES.items():
        jname = name.replace("trt_", "trec_")
        if hasattr(lib, jname):
            fn = getattr(lib, jname)
            fn.argtypes, fn.restype = list(argtypes), restype
    return lib


def patch_jax_native(mp, lib) -> None:
    """Make the JAX transformers and KV store load ``lib`` in place of
    ``csrc_build.load_native``."""
    import torchrec_tpu.dynamic.kv_store as jkv
    import torchrec_tpu.inference.serving as jserving

    mp.setattr(jserving, "load_native", lambda: lib)
    mp.setattr(jkv, "load_native", lambda: lib)


# ---------------------------------------------------------------------------
# the gloo ranks
# ---------------------------------------------------------------------------

ZCH, B, D = 24, 8, 4
KEYS = ["q", "r"]


def zch_batches(seed: int, world: int, steps: int):
    """``steps`` global batches of raw int64 ids, ``world`` local batches
    each ([F * B] lengths of 1 or 2, key-major values): a small hot set
    mixed with fresh ids, so the tables evict."""
    rng = np.random.RandomState(seed)
    hot = np.arange(1 << 50, (1 << 50) + 6, dtype=np.int64)
    out = []
    for _ in range(steps):
        locals_ = []
        for _ in range(world):
            lengths = rng.randint(1, 3, size=(len(KEYS) * B,)).astype(
                np.int32)
            n = int(lengths.sum())
            fresh = rng.randint(0, 1 << 60, size=(n,)).astype(np.int64)
            pick = rng.rand(n) < 0.5
            values = np.where(pick, hot[rng.randint(0, len(hot), size=n)],
                              fresh)
            locals_.append((values, lengths))
        out.append(locals_)
    return out


def zch_tables():
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
        PoolingType,
    )

    return tuple(EmbeddingBagConfig(num_embeddings=ZCH, embedding_dim=D,
                                    name=f"t_{k}", feature_names=[k],
                                    pooling=PoolingType.SUM) for k in KEYS)


def zch_collection(policy: str = "lru"):
    from torchrec_tpu_torch.modules.mc_modules import (
        ManagedCollisionCollection,
        MCHManagedCollisionModule,
    )

    return ManagedCollisionCollection({
        k: MCHManagedCollisionModule(ZCH, f"t_{k}", eviction_policy=policy)
        for k in KEYS})


def dynamic_rank(seed: int, steps: int) -> Dict[str, object]:
    """One rank of the launch: remap this rank's batches through a
    ``SyncedCollisionCollection`` (every eviction of the global stream
    collected), record the remapped ids in a ``TouchedRowTracker`` and
    drain it over a DMP's tables.  Returns the remapped values, the
    evictions and the drained ``(ids, rows)`` with the table weights the
    rows came from."""
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel import multiprocess
    from torchrec_tpu_torch.parallel.comm import ShardingEnv
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.production import TouchedRowTracker
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    multiprocess.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device="cpu")
    rank, world = env.rank, env.world_size
    synced = multiprocess.SyncedCollisionCollection(zch_collection())
    tracker = TouchedRowTracker()
    tables = zch_tables()
    plan = {t.name: ParameterSharding(ShardingType.ROW_WISE,
                                      ranks=list(range(world)))
            for t in tables}
    dmp = DistributedModelParallel(
        DLRM(EmbeddingBagCollection(tables, device="meta"), 3, (8, D),
             (8, 1)), tables, plan, B, {k: 2 * B for k in KEYS},
        fused_config=FusedOptimConfig(learning_rate=0.1),
        dense_optimizer=adagrad(0.1), env=env)
    state = dmp.init(torch.Generator().manual_seed(0))
    out: Dict[str, List] = {"values": [], "evictions": []}
    for s, locals_ in enumerate(zch_batches(seed, world, steps)):
        values, lengths = locals_[rank]
        kjt = KeyedJaggedTensor.from_lengths_packed(KEYS, values, lengths,
                                                    caps=2 * B)
        evs: list = []
        (kjt2,) = synced.remap_local([kjt], evs)
        for e in evs:
            state = dmp.reset_table_rows(state, e.table, e.slots)
        out["evictions"].append([(e.table, e.global_ids.tolist(),
                                  e.slots.tolist()) for e in evs])
        vals = kjt2.values().numpy()
        out["values"].append(vals.copy())
        lo, co = kjt2._length_offsets(), kjt2.cap_offsets()
        lens = kjt2.lengths().numpy()
        for f, k in enumerate(KEYS):
            n = int(lens[lo[f]:lo[f + 1]].sum())
            tracker.record(f"t_{k}", vals[co[f]:co[f] + n])
    drained = tracker.drain(dmp, state)
    weights = dmp.table_weights(state)
    return {**out, "drained": {t: (ids, rows)
                               for t, (ids, rows) in drained.items()},
            "weights": {t: np.asarray(w) for t, w in weights.items()}}
