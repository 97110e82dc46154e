"""The ranks of the port's multi-process reliability tests
(``tests/test_torch_dynamic_sharding.py``): functions that
``multiprocess.launch`` runs in spawned processes over a gloo process
group on the CPU.  They import torch, numpy and the port only (the JAX
side runs in the test's own process), take plain data and return numpy."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torchrec_tpu_torch.checkpoint import Checkpointer
from torchrec_tpu_torch.convert import train_state_from_jax
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.dynamic_sharding import (
    reshard,
    scatter_slots,
    slots_to_tables,
)
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel

from torch_sharding_workers import (
    _clone_state,
    _join,
    _states_equal,
    make_plan,
    make_tables,
)


def _np_slots(slots):
    return {t: ({k: int(v) for k, v in s.items()} if t == "__scalars__"
                else {k: v.numpy().copy() for k, v in s.items()})
            for t, s in slots.items()}


def _dmp(w, plan_spec, env):
    tables = make_tables(w["tables"])
    model = DLRM(EmbeddingBagCollection(tables, device="meta"), w["dense_in"],
                 w["dense_arch"], w["over_arch"])
    return DistributedModelParallel(
        model, tables, make_plan(plan_spec), w["batch"], w["caps"],
        fused_config=FusedOptimConfig(learning_rate=w["lr"]),
        dense_optimizer=adagrad(w["lr"]), env=env)


def _batches(w, rank, world, first, n):
    """Rank ``rank``'s batches of global steps ``first .. first + n - 1``
    (batch ``step * world + rank`` of the dataset both packages use)."""
    it = iter(RandomRecDataset(w["keys"], w["batch"],
                               [t["rows"] for t in w["tables"]], w["ids"],
                               num_dense=w["dense_in"], manual_seed=0))
    every = [next(it) for _ in range((first + n) * world)]
    return [every[s * world + rank] for s in range(first, first + n)]


def _snapshot(dmp, state):
    """(per-table weights, per-table slots), both collectives."""
    return dmp.table_weights(state), _np_slots(slots_to_tables(dmp, state))


def _same(a, b) -> bool:
    return all(np.array_equal(a[t], b[t]) for t in a) and a.keys() == b.keys()


def _same_slots(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[t] == b[t] if t == "__scalars__" else _same(a[t], b[t]) for t in a)


def reshard_rank(w, plans, jax_start, steps, ckpt_dir):
    """One rank of the reshard test.  From rank ``r``'s share of the JAX
    start state under plan ``A``: ``steps`` train steps, then for each
    other plan: ``reshard`` (weights and slots ``np.array_equal`` across
    it, the forward's logits on the next batch), one step under the new
    plan (weights and slots returned for the JAX comparison) and the same
    step on a fresh DMP of the new plan loaded with the same weights,
    slots and dense state (``torch.equal`` states); then A -> B -> A gives
    the first stacks and fused states bit for bit; a world-4 checkpoint
    into ``ckpt_dir``; and ``restore_elastic`` of it on ranks 0 and 1 as a
    world of 2 under plan ``two`` (weights and slots equal to the saved
    ones)."""
    env = _join()
    r, N = env.rank, env.world_size
    dmp = _dmp(w, plans["A"], env)
    state = train_state_from_jax(jax_start, device="cpu", rank=r,
                                 world_size=N)
    for b in _batches(w, r, N, 0, steps):
        state, _ = dmp.train_step(state, b)
    nxt = _batches(w, r, N, steps, 1)[0]
    weights, slots = _snapshot(dmp, state)
    logits_a = dmp.forward(state["dense"], state["tables"], nxt).numpy()
    out = {"logits": {"A": logits_a}}
    for name in ("B", "C"):
        new_dmp, new_state = reshard(dmp, _clone_state(state),
                                     make_plan(plans[name]))
        w2, s2 = _snapshot(new_dmp, new_state)
        if not (_same(weights, w2) and _same_slots(slots, s2)):
            raise AssertionError(f"{name}: weights or slots moved")
        out["logits"][name] = new_dmp.forward(
            new_state["dense"], new_state["tables"], nxt).numpy()
        fresh_dmp = _dmp(w, plans[name], env)
        fresh = fresh_dmp.init(torch.Generator().manual_seed(1))
        fresh_dmp.load_table_weights(fresh, w2)
        scatter_slots(fresh_dmp, fresh["fused"],
                      slots_to_tables(new_dmp, new_state))
        fresh.update(dense=_clone_state(new_state["dense"]),
                     dense_opt=_clone_state(new_state["dense_opt"]),
                     step=new_state["step"])
        new_state, _ = new_dmp.train_step(new_state, nxt)
        fresh, _ = fresh_dmp.train_step(fresh, nxt)
        out[f"{name}_fresh_equal"] = _states_equal(new_state, fresh)
        out[name] = _snapshot(new_dmp, new_state)
    # A -> B -> A: the first stacks and fused states bit for bit
    b_dmp, b_state = reshard(dmp, _clone_state(state),
                             make_plan(plans["B"]))
    a_dmp, a_state = reshard(b_dmp, b_state, dmp.plan)
    out["chain_equal"] = all(
        torch.equal(a_state["tables"][g], state["tables"][g])
        for g in state["tables"]) and all(
        torch.equal(a_state["fused"][g][k], state["fused"][g][k])
        for g in state["fused"] for k in state["fused"][g])
    # the world-4 checkpoint, then a world-2 restore_elastic on ranks 0-1
    Checkpointer(ckpt_dir).save(dmp, state)
    dist.barrier()
    pair = dist.new_group([0, 1])
    if r < 2:
        env2 = ShardingEnv(2, r, torch.device("cpu"), pair, "gloo")
        dmp2 = _dmp(w, plans["two"], env2)
        s2 = Checkpointer(ckpt_dir).restore_elastic(dmp2, state["step"])
        w2, sl2 = _snapshot(dmp2, s2)
        out["world2_equal"] = _same(weights, w2) and _same_slots(slots, sl2)
    out["weights"], out["slots"] = weights, slots
    out["dmp2d"] = _dmp2d_round_trips(w, plans["two"], ckpt_dir)
    return out


def _dmp2d_round_trips(w, plan_spec, ckpt_dir):
    """A ``DMPCollection`` of 2 replicas x 2 model ranks, each strategy:
    one step (and a sync), a save and a restore of every rank's share,
    and a table's rows and rowwise slots gathered, zeroed and scattered
    back in place.  Returns {strategy: restored and round-tripped states
    ``torch.equal`` to the trained one}."""
    from torchrec_tpu_torch.parallel.model_parallel import DMPCollection

    env = ShardingEnv.from_process_group("gloo", device="cpu",
                                         num_replicas=2)
    batch = _batches(w, env.global_rank, env.global_size, 0, 1)[0]
    out = {}
    for strategy in ("replicated", "fully_sharded"):
        tables = make_tables(w["tables"])
        dmp = DMPCollection(
            DLRM(EmbeddingBagCollection(tables, device="meta"),
                 w["dense_in"], w["dense_arch"], w["over_arch"]),
            tables, make_plan(plan_spec), w["batch"], w["caps"],
            fused_config=FusedOptimConfig(learning_rate=w["lr"]),
            dense_optimizer=adagrad(w["lr"]), env=env,
            sharding_strategy=strategy)
        state = dmp.init(torch.Generator().manual_seed(2))
        state, _ = dmp.train_step(state, batch)
        dmp.sync(state)
        d = f"{ckpt_dir}_{strategy}"
        Checkpointer(d).save(dmp, state)
        dist.barrier()
        restored = Checkpointer(d).restore(dmp, state["step"])
        trained = _clone_state(state)
        rows, slots = np.array([0, 7, 63, 199]), {"momentum": 1}
        packed = dmp.gather_row_state(state, "tb", rows, slots)
        dmp.reset_table_rows(state, "tb", rows)
        zeroed = not np.any(dmp.gather_row_state(state, "tb", rows))
        dmp.scatter_row_state(state, "tb", rows, packed, slots)
        out[strategy] = (zeroed and _states_equal(restored, trained)
                         and _states_equal(state, trained))
    return out
