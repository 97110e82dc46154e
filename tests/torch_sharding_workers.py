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


def _clone_state(tree):
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _states_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def all_reduce_check(env, n):
    """``comm.all_reduce_sum`` of an ``n``-element float32 tensor drawn
    per rank against the all-gather and rank-order sum: (``torch.equal``,
    the ledger's bytes under its tag)."""
    from torchrec_tpu_torch.parallel.comm import (
        all_gather,
        all_reduce_sum,
        sum_over_ranks,
    )

    x = torch.randn(n, generator=torch.Generator().manual_seed(env.rank))
    with wire_accounting() as ledger:
        got = all_reduce_sum(x, env, tag="check")
    return (bool(torch.equal(got, sum_over_ranks(all_gather(x, env)))),
            ledger.get("check"))


def dmp_rank(table_spec, jobs, keys, caps, batch, ids, dense_in,
             dense_arch, over_arch, lr, steps, over):
    """One rank of the sharded-DMP test, for each job ``(plan spec, the
    JAX DMP's initial state, its replicated groups, qcomms as (forward,
    backward) precision values or None)``: the port's DMP from rank
    ``r``'s share of that state, ``steps`` train steps on this rank's
    batches (batch ``step * N + r`` of the dataset both packages draw
    from), the first also as the split step (``make_embed_step`` then
    ``make_dense_update_step`` from a copy of the state), the eval forward
    on the next step's batch, then one step whose rank-0 batch is over
    capacity (``over`` = (key index, ids an example)).  Returns
    {"jobs": per job (the losses, the forward's logits, the over-cap
    step's ``id_overflow``, whether the split step left the state and
    metrics ``torch.equal`` to ``train_step``'s, the full tables and the
    dense parameters after the steps; tables and dense from rank 0 only),
    "all_reduce": :func:`all_reduce_check` of 1,001 elements}."""
    from torchrec_tpu_torch.parallel.qcomm import CommType, QCommsConfig

    env = _join()
    r, N = env.rank, env.world_size
    tables = make_tables(table_spec)
    out = []
    for plan_spec, jax_state, replicated, qc in jobs:
        model = DLRM(EmbeddingBagCollection(tables, device="meta"), dense_in,
                     dense_arch, over_arch)
        dmp = DistributedModelParallel(
            model, tables, make_plan(plan_spec), batch, caps,
            fused_config=FusedOptimConfig(learning_rate=lr),
            dense_optimizer=adagrad(lr), env=env,
            qcomms=None if qc is None else QCommsConfig(CommType(qc[0]),
                                                        CommType(qc[1])))
        state = train_state_from_jax(jax_state, device="cpu", rank=r,
                                     world_size=N, replicated=replicated)
        it = iter(RandomRecDataset(keys, batch,
                                   [t["rows"] for t in table_spec], ids,
                                   num_dense=dense_in, manual_seed=0))
        losses, split_equal = [], None
        for s in range(steps):
            mine = [next(it) for _ in range(N)][r]
            if s == 0:
                split = _clone_state(state)
                kt, ctxs = dmp.make_embed_step()(split["tables"], mine)
                split, ms = dmp.make_dense_update_step()(split, mine, kt,
                                                         ctxs)
            state, m = dmp.train_step(state, mine)
            if s == 0:
                split_equal = _states_equal(split, state) and all(
                    torch.equal(ms[k], m[k]) for k in m)
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
                    split_equal, (weights, dense) if r == 0 else None))
    return {"jobs": out, "all_reduce": all_reduce_check(env, 1001)}


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


def dp_every_row_rank(table_spec, plan_spec, caps, batch, weights, kjts,
                      grads, configs):
    """One rank of the data-parallel every-row test: for each fused
    config ``(optim value, lr, weight decay)``, steps over this rank's
    KJTs and gradients (``kjts[step][r]``, ``grads[step][r]``) from the
    same full tables.  Returns the full tables after the steps per config
    (rank 0 only)."""
    env = _join()
    r = env.rank
    tables = make_tables(table_spec)
    ebc = ShardedEmbeddingBagCollection.build(
        tables, make_plan(plan_spec), env.world_size, batch, caps)
    out = []
    for optim, lr, wd in configs:
        cfg = FusedOptimConfig(optim=EmbOptimType(optim), learning_rate=lr,
                               weight_decay=wd)
        params = ebc.params_from_tables(weights, rank=r)
        fused = ebc.init_fused_state(cfg)
        for step_kjts, step_grads in zip(kjts, grads):
            kjt = KeyedJaggedTensor.from_lengths_packed(*step_kjts[r])
            _, ctxs = ebc.forward_local(params, kjt, env=env)
            ebc.backward_and_update_local(
                params, fused, ctxs,
                {f: torch.from_numpy(g) for f, g in step_grads[r].items()},
                cfg, env=env)
        full = ebc.tables_to_weights(ebc.gather_stacks(params, env))
        out.append({t: w.numpy() for t, w in full.items()} if r == 0
                   else None)
    return out


def _numpy_tree(tree):
    """A train state with every tensor a numpy copy (to cross processes)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy().copy() if isinstance(tree, torch.Tensor) else tree


def dmp2d_rank(table_spec, jobs, keys, caps, batch, ids, dense_in,
               dense_arch, over_arch, lr, steps, num_replicas):
    """One rank of the 2D test (``num_replicas`` replicas of ``world /
    num_replicas`` model ranks), for each job ``(strategy, plan spec, the
    JAX DMPCollection's initial state, its replicated groups, sync
    interval, fused optimizer)``: the port's DMPCollection from this
    rank's share of that state, ``steps`` train steps each followed by ``maybe_sync`` (global
    rank ``g`` takes batch ``step * world + g``), then the eval forward on
    the next step's batch.  Returns per job (the losses, whether the
    replicas' tables and states were ``torch.equal`` after each step, the
    forward's logits, the train state)."""
    from torchrec_tpu_torch.parallel.comm import all_gather
    from torchrec_tpu_torch.parallel.model_parallel import DMPCollection

    torch.set_num_threads(1)
    multiprocess.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device="cpu",
                                         num_replicas=num_replicas)
    g, W = env.global_rank, env.global_size
    tables = make_tables(table_spec)
    out = []
    for strategy, plan_spec, jax_state, replicated, interval, optim in jobs:
        model = DLRM(EmbeddingBagCollection(tables, device="meta"), dense_in,
                     dense_arch, over_arch)
        dmp = DMPCollection(
            model, tables, make_plan(plan_spec), batch, caps,
            fused_config=FusedOptimConfig(optim=EmbOptimType(optim),
                                          learning_rate=lr),
            dense_optimizer=adagrad(lr), env=env, sync_interval=interval,
            sharding_strategy=strategy)
        state = train_state_from_jax(
            jax_state, device="cpu", rank=env.rank,
            world_size=env.world_size, replicated=replicated,
            replica=env.replica_rank, num_replicas=env.num_replicas,
            fully_sharded=strategy == "fully_sharded")
        it = iter(RandomRecDataset(keys, batch,
                                   [t["rows"] for t in table_spec], ids,
                                   num_dense=dense_in, manual_seed=0))
        losses, in_step = [], []
        for _ in range(steps):
            state, m = dmp.train_step(state, [next(it) for _ in range(W)][g])
            state = dmp.maybe_sync(state)
            losses.append(float(m["loss"]))
            # FULLY_SHARDED ranks hold slices: only whole groups compare
            names = (list(dmp.sharded_ebc.dp_groups)
                     if strategy == "fully_sharded" else list(state["tables"]))
            arrays = [state["tables"][n] for n in names] + [
                v for n in names for v in state["fused"][n].values()
                if isinstance(v, torch.Tensor)]
            in_step.append(all(
                all(torch.equal(c[0], c[q]) for q in range(1, len(c)))
                for c in (all_gather(a, env.replica_env) for a in arrays)))
        logits = dmp.make_forward()(state["dense"], state["tables"],
                                    [next(it) for _ in range(W)][g])
        out.append((losses, in_step, logits.numpy(), _numpy_tree(state)))
    return out


def ec_rank(table_spec, plans, caps, batch, weights, cases, lr):
    """One rank of the sharded-EC test.  ``cases`` maps a case name to
    ``(plan kind, index_dedup, per-rank KJT data, step)``: the sharded
    ``EmbeddingCollection`` of that plan on this rank's KJT, its per-id
    rows, and with ``step`` one SGD update (gradient ones) whose full
    tables rank 0 returns.  Also the unsharded collection's rows of the
    rank's KJT per case.  Returns {case: (rows by feature, tables or None,
    the unsharded rows)}."""
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingCollection,
    )
    from torchrec_tpu_torch.parallel.embedding import (
        ShardedEmbeddingCollection,
    )

    env = _join()
    r = env.rank
    tables = [EmbeddingConfig(num_embeddings=t["rows"],
                              embedding_dim=t["dim"], name=t["name"],
                              feature_names=list(t["features"]))
              for t in table_spec]
    ref = EmbeddingCollection(tables, device="cpu",
                              generator=torch.Generator())
    ref.load_state_dict({t: torch.from_numpy(w) for t, w in weights.items()})
    cfg = FusedOptimConfig(optim=EmbOptimType.SGD, learning_rate=lr)
    out = {}
    for case, (kind, dedup, kjts, step) in cases.items():
        ec = ShardedEmbeddingCollection.build(
            tables, make_plan(plans[kind]), env.world_size, batch, caps,
            index_dedup=dedup)
        params = ec.params_from_tables(weights, rank=r)
        kjt = KeyedJaggedTensor.from_lengths_packed(*kjts[r])
        outs, ctxs = ec.forward_local(params, kjt, env)
        full = None
        if step:
            grads = {f: torch.ones_like(jt.values())
                     for f, jt in outs.items()}
            ec.backward_and_update_local(params, ec.init_fused_state(cfg),
                                         ctxs, grads, cfg, env)
            full = ec.tables_to_weights(ec.gather_stacks(params, env))
            full = {t: w.numpy() for t, w in full.items()} if r == 0 else None
        want = ref(kjt)
        out[case] = ({f: jt.values().numpy() for f, jt in outs.items()},
                     full, {f: jt.values().detach().numpy()
                            for f, jt in want.items()})
    return out


def chunked_rank(xs, w, ks):
    """One rank of the chunked all-to-all test: for each K of ``ks``,
    ``chunked_pooled_a2a`` and ``chunked_a2a_linear`` of this rank's
    ``xs[r]`` ``[N, B, D]``, one all-to-all of it (and its product with
    ``w``), and each call's ledger.  Returns {K: (chunked, one a2a,
    linear, one a2a @ w, ledger)}."""
    from torchrec_tpu_torch.parallel.chunked_a2a import (
        chunked_a2a_linear,
        chunked_pooled_a2a,
    )
    from torchrec_tpu_torch.parallel.comm import all_to_all

    env = _join()
    x = torch.from_numpy(xs[env.rank])
    wt = torch.from_numpy(w)
    mono = all_to_all(x, env).reshape(-1, x.shape[-1])
    out = {}
    for k in ks:
        with wire_accounting() as ledger:
            c = chunked_pooled_a2a(x, env, k)
            lin = chunked_a2a_linear(x, wt, env, k)
        out[k] = (c.numpy(), mono.numpy(), lin.numpy(), (mono @ wt).numpy(),
                  dict(ledger))
    return out
