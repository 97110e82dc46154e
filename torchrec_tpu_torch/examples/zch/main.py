"""Zero-collision hashing, the port of the JAX package's
``examples/zch/main.py``: raw 64-bit ids stream through a managed-collision
module (the host library's LRU id transformer) in the input pipeline, the
model only ever sees bounded rows, and the rows of evicted ids are reset on
the card before the step that reuses them.

Run on the card:
  python -m torchrec_tpu_torch.examples.zch.main --steps 20

``--device cpu`` runs the kernels' plain versions on the CPU.  Under a
process group (``parallel/multiprocess.py``) each rank remaps its own
batch through a ``SyncedCollisionCollection`` (every rank replays the
global id stream in rank order and applies every eviction), else one
rank.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.mc_modules import (
    ManagedCollisionCollection,
    MCHManagedCollisionModule,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.multiprocess import SyncedCollisionCollection
from torchrec_tpu_torch.parallel.planner import EmbeddingShardingPlanner
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--zch_size", type=int, default=2_000,
                   help="rows of the managed table")
    p.add_argument("--embedding_dim", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=64, help="per rank")
    p.add_argument("--dense_in", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _env(device: torch.device) -> ShardingEnv:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return ShardingEnv.from_process_group(
            torch.distributed.get_backend(), device=device)
    return ShardingEnv.single_device(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train ``--steps`` steps on raw ids uniform over ``[0, 2^60)``, one or
    two a example; print the loss, the table's occupancy and the evictions
    every 5 steps (rank 0).  Returns the DMP, the trained state, the
    losses (device tensors) and the evictions applied."""
    args = parse_args(argv)
    env = _env(resolve_device(args.device))
    dev, n, r = env.device, env.world_size, env.rank
    B, D, Z = args.batch_size, args.embedding_dim, args.zch_size
    keys = ["q"]
    tables = (EmbeddingBagConfig(num_embeddings=Z, embedding_dim=D,
                                 name="t_q", feature_names=["q"],
                                 pooling=PoolingType.SUM),)
    mcc = ManagedCollisionCollection({"q": MCHManagedCollisionModule(Z, "t_q")})
    synced = SyncedCollisionCollection(mcc)
    model = DLRM(EmbeddingBagCollection(tables, device="meta"),
                 args.dense_in, (32, D), (32, 1))
    plan = EmbeddingShardingPlanner(
        world_size=n, batch_size_per_device=B).plan(tables)
    dmp = DistributedModelParallel(
        model, tables, plan, B, {"q": 2 * B},
        fused_config=FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                                      learning_rate=args.lr),
        dense_optimizer=adagrad(args.lr), env=env)
    state = dmp.init(torch.Generator(device=dev).manual_seed(0))
    step = dmp.make_train_step()

    rng = np.random.RandomState(0)
    evicted_total = 0
    losses: List[torch.Tensor] = []
    for i in range(args.steps):
        # every rank draws the n local batches of the step in rank order
        # and keeps its own: the seeded stream of the JAX example's mesh
        locals_ = []
        for _ in range(n):
            lengths = rng.randint(1, 3, size=(B,)).astype(np.int32)
            raw = rng.randint(0, 1 << 60, size=(int(lengths.sum()),))
            kjt = KeyedJaggedTensor.from_lengths_packed(keys, raw, lengths,
                                                        caps=2 * B)
            dense = torch.from_numpy(rng.rand(B, args.dense_in).astype(
                np.float32))
            labels = torch.from_numpy(rng.randint(0, 2, size=(B,)).astype(
                np.float32))
            locals_.append(Batch(dense, kjt, labels))
        evictions: list = []
        (kjt,) = synced.remap_local([locals_[r].sparse_features], evictions)
        for e in evictions:
            # a fresh id must not inherit the evicted id's row
            state = dmp.reset_table_rows(state, e.table, e.slots)
            evicted_total += len(e.global_ids)
        batch = Batch(locals_[r].dense_features, kjt, locals_[r].labels)
        state, m = step(state, batch.to(dev))
        losses.append(m["loss"])
        if (i + 1) % 5 == 0 and r == 0:
            occ = mcc.modules["q"].occupancy
            print(f"step {i + 1}: loss={float(m['loss']):.4f} "
                  f"zch_occupancy={occ}/{Z} evictions={evicted_total}")
    return {"dmp": dmp, "state": state, "losses": losses, "mcc": mcc,
            "evicted": evicted_total}


if __name__ == "__main__":
    main()
