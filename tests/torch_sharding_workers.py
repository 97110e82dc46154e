"""The ranks of the port's multi-process sharding tests
(``tests/test_torch_sharded_ebc.py``, ``tests/test_torch_sharded_dmp.py``):
functions that ``multiprocess.launch`` runs in spawned processes over a
gloo process group on the CPU, and one rank over NCCL on the card
(``tests/test_torch_cuda_kernels.py``).  They import torch, numpy and the
port only (the JAX side runs in the test's own process), take plain data
and return numpy."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.convert import train_state_from_jax
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimConfig,
)
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel import multiprocess
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.qcomm import wire_accounting
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.sparse import KeyedJaggedTensor


def _join() -> ShardingEnv:
    torch.set_num_threads(1)
    multiprocess.initialize("gloo")
    return ShardingEnv.from_process_group("gloo", device="cpu")


def make_tables(spec: Sequence[dict]) -> List[EmbeddingBagConfig]:
    """Table configs from ``{name, rows, dim, features, pooling}``."""
    return [EmbeddingBagConfig(num_embeddings=t["rows"],
                               embedding_dim=t["dim"], name=t["name"],
                               feature_names=list(t["features"]),
                               pooling=PoolingType(t["pooling"]))
            for t in spec]


def make_plan(spec: Dict[str, tuple]) -> Dict[str, ParameterSharding]:
    """A plan from ``{table: (sharding type value, ranks, col shards)}``."""
    return {name: ParameterSharding(ShardingType(st), ranks=ranks,
                                    num_col_shards=ncs)
            for name, (st, ranks, ncs) in spec.items()}


def ebc_rank(table_spec, plans, caps, batch, weights, kjts, grads, lr,
             shifted):
    """One rank of the sharded-EBC test: for each plan, this rank's KJT
    through ``forward_local`` and one SGD ``backward_and_update_local``
    with this rank's gradients; plan ``shifted`` reads the row-wise stacks
    off by one row on rank 1 (the negative control).  Returns ({plan:
    (outputs, the updated full tables from rank 0, the ledger, dedup)}, the
    unsharded EmbeddingBagCollection's output on this rank's KJT).  On
    the tw and dp plans the dedup kernels' plain versions run too: (their
    outputs equal the per-id ones, the largest table difference after
    their update)."""
    env = _join()
    r = env.rank
    tables = make_tables(table_spec)
    kjt = KeyedJaggedTensor.from_lengths_packed(*kjts[r])
    g_rank = {f: torch.from_numpy(g) for f, g in grads[r].items()}
    cfg = FusedOptimConfig(optim=EmbOptimType.SGD, learning_rate=lr)
    out = {}
    for kind, spec in plans.items():
        ebc = ShardedEmbeddingBagCollection.build(
            tables, make_plan(spec), env.world_size, batch, caps)
        params = ebc.params_from_tables(weights, rank=r)
        if kind == shifted and r == 1:
            params = {n: torch.roll(t, 1, 0) if n.startswith("rw") else t
                      for n, t in params.items()}
        fused = ebc.init_fused_state(cfg)
        dedup = None
        if kind in ("tw", "dp"):  # the dedup kernels' plain versions
            d_params = {n: t.clone() for n, t in params.items()}
            d_outs, d_ctxs = ebc.forward_local(d_params, kjt, "dedup", env)
            ebc.backward_and_update_local(d_params, ebc.init_fused_state(cfg),
                                          d_ctxs, g_rank, cfg,
                                          update_kernel="dedup", env=env)
        with wire_accounting() as ledger:
            outs, ctxs = ebc.forward_local(params, kjt, env=env)
            ebc.backward_and_update_local(params, fused, ctxs, g_rank, cfg,
                                          env=env)
        if kind in ("tw", "dp"):
            dedup = (all(torch.equal(d_outs[f], o) for f, o in outs.items()),
                     max(float((d_params[n] - t).abs().max())
                         for n, t in params.items()))
        full = ebc.tables_to_weights(ebc.gather_stacks(params, env))
        out[kind] = ({f: o.numpy() for f, o in outs.items()},
                     {t: w.numpy() for t, w in full.items()} if r == 0
                     else None, dict(ledger), dedup)
    ref = EmbeddingBagCollection(tables, is_weighted=True, device="cpu",
                                 generator=torch.Generator())
    ref.load_state_dict({t: torch.from_numpy(w) for t, w in weights.items()})
    kt = ref(kjt)
    return out, {f: v.detach().numpy() for f, v in kt.to_dict().items()}


def over_cap(batch, key_index, length):
    """``batch`` with every example of key ``key_index`` claiming
    ``length`` ids, past the key's capacity (the saturation a device-side
    relayout leaves; ``id_overflow`` counts the drop)."""
    kjt = batch.sparse_features
    lengths = kjt.lengths().clone()
    B = kjt.stride()
    lengths[key_index * B:(key_index + 1) * B] = length
    return dataclasses.replace(batch, sparse_features=KeyedJaggedTensor(
        kjt.keys(), kjt.values(), lengths, stride=B, caps=kjt.caps))


def dmp_rank(table_spec, jobs, keys, caps, batch, ids, dense_in,
             dense_arch, over_arch, lr, steps, over):
    """One rank of the sharded-DMP test, for each job ``(plan spec, the
    JAX DMP's initial state, its replicated groups)``: the port's DMP from
    rank ``r``'s share of that state, ``steps`` train steps on this rank's
    batches (batch ``step * N + r`` of the dataset both packages draw
    from), the eval forward on the next step's batch, then one step whose
    rank-0 batch is over capacity (``over`` = (key index, ids an
    example)).  Returns per job (the losses, the forward's logits, the
    over-cap step's ``id_overflow``, the full tables and the dense
    parameters after the steps; tables and dense from rank 0 only)."""
    env = _join()
    r, N = env.rank, env.world_size
    tables = make_tables(table_spec)
    out = []
    for plan_spec, jax_state, replicated in jobs:
        model = DLRM(EmbeddingBagCollection(tables, device="meta"), dense_in,
                     dense_arch, over_arch)
        dmp = DistributedModelParallel(
            model, tables, make_plan(plan_spec), batch, caps,
            fused_config=FusedOptimConfig(learning_rate=lr),
            dense_optimizer=adagrad(lr), env=env)
        state = train_state_from_jax(jax_state, device="cpu", rank=r,
                                     world_size=N, replicated=replicated)
        it = iter(RandomRecDataset(keys, batch,
                                   [t["rows"] for t in table_spec], ids,
                                   num_dense=dense_in, manual_seed=0))
        losses = []
        for _ in range(steps):
            mine = [next(it) for _ in range(N)][r]
            state, m = dmp.train_step(state, mine)
            if m["id_overflow"].any():
                raise AssertionError(f"id_overflow {m['id_overflow']}")
            losses.append(float(m["loss"]))
        weights = dmp.table_weights(state)
        # copies: the over-cap step below updates the state in place
        dense = {k: v.numpy().copy() for k, v in state["dense"].items()}
        logits = dmp.make_forward()(state["dense"], state["tables"],
                                    [next(it) for _ in range(N)][r])
        mine = [next(it) for _ in range(N)][r]
        if r == 0:
            mine = over_cap(mine, *over)
        _, m = dmp.train_step(state, mine)
        out.append((losses, logits.numpy(), m["id_overflow"].numpy(),
                    (weights, dense) if r == 0 else None))
    return out


def nccl_rank():
    """One rank over NCCL on the card: the row-wise plan at 4 tables x
    1,000 x 16 against the one-device DMP (a table-wise plan), forward
    and one step."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multiprocess.initialize("nccl")
    env = ShardingEnv.from_process_group("nccl", device=dev)
    keys = [f"f{i}" for i in range(4)]
    spec = [{"name": f"t_{k}", "rows": 1000, "dim": 16, "features": [k],
             "pooling": "SUM"} for k in keys]
    tables = make_tables(spec)
    ds = RandomRecDataset(keys, 64, [1000] * 4, [3, 1, 2, 4], num_dense=13)
    batch = next(iter(ds)).to(dev)
    caps = dict(zip(keys, ds.caps))

    def build(plan, env):
        dmp = DistributedModelParallel(
            DLRM(EmbeddingBagCollection(tables, device="meta"), 13,
                 (32, 16), (32, 1)),
            tables, make_plan(plan), 64, caps, device=dev, env=env)
        return dmp, dmp.init(torch.Generator(device=dev).manual_seed(0))

    rw, rw_state = build({t["name"]: ("row_wise", [0], 1) for t in spec}, env)
    one, one_state = build({t["name"]: ("table_wise", [0], 1)
                            for t in spec}, None)
    kt, _ = rw.sparse_forward(rw_state, batch)
    kt_one, _ = one.sparse_forward(one_state, batch)
    rw_state, m = rw.train_step(rw_state, batch)
    one_state, m1 = one.train_step(one_state, batch)
    a, b = rw.table_weights(rw_state), one.table_weights(one_state)
    return {"backend": env.backend, "kt_equal": bool(torch.equal(kt, kt_one)),
            "tables_equal": all(np.array_equal(a[t], b[t]) for t in a),
            "loss": float(m["loss"]), "one_loss": float(m1["loss"])}


def failing_rank():
    """Rank 1 raises after joining; rank 0 waits on it at a barrier."""
    env = _join()
    if env.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return env.rank


def tag_rank(tag):
    """This launch's ``tag`` from every rank of the group: a group that
    took in a rank of another launch would gather that launch's tag."""
    env = _join()
    return env.rank, multiprocess.allgather_host(
        np.array([tag], np.int64)).reshape(-1).tolist()
