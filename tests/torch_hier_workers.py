"""The ranks of ``tests/test_torch_hier.py``: the port's two-level ICI/DCN
dists on 4 gloo processes on the CPU, as 2 slices x 2 ranks
(``ShardingEnv.from_process_group(num_slices=2)``).  Each function runs in
a spawned process, imports torch, numpy and the port only, takes plain
data and returns numpy."""

from __future__ import annotations

from typing import Dict

import torch

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
from torchrec_tpu_torch.parallel import multiprocess
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.planner.planners import (
    EmbeddingShardingPlanner,
)
from torchrec_tpu_torch.parallel.planner.types import ParameterConstraints
from torchrec_tpu_torch.parallel.qcomm import wire_accounting
from torchrec_tpu_torch.parallel.sequence_model_parallel import (
    SequenceModelParallel,
)
from torchrec_tpu_torch.parallel.sharding.hier import HierTopology
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

S, L = 2, 2
FEATS = ["f0", "f1", "f2", "f3"]
ROWS = {"f0": 64, "f1": 40, "f2": 32, "f3": 48}


def tables(mean_pool: bool):
    """The tables of ``tests/test_hier_sharding.py``: one MEAN feature on
    general data, SUM everywhere in the exact regime."""
    return [EmbeddingBagConfig(
        num_embeddings=ROWS[f], embedding_dim=8, name=f"t{i}",
        feature_names=[f],
        pooling=(PoolingType.MEAN if mean_pool and f == "f1"
                 else PoolingType.SUM))
        for i, f in enumerate(FEATS)]


def plan(hier: bool, dedup: bool, hier_factor: float = 1.0):
    """Two RW tables, one TWRW (node = slice 0), one TW."""
    rw = [0, 1, 2, 3]
    return {
        "t0": ParameterSharding(ShardingType.ROW_WISE, ranks=rw, dedup=dedup,
                                hier=hier, hier_factor=hier_factor),
        "t1": ParameterSharding(ShardingType.ROW_WISE, ranks=rw, dedup=dedup,
                                hier=hier, hier_factor=hier_factor),
        "t2": ParameterSharding(ShardingType.TABLE_ROW_WISE, ranks=[0, 1],
                                dedup=dedup, hier=hier,
                                hier_factor=hier_factor),
        "t3": ParameterSharding(ShardingType.TABLE_WISE, ranks=[1]),
    }


CFG = FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD, learning_rate=0.05)


def _run(env, tbls, pl, cap, weights, kjt_data):
    """Forward and one rowwise-Adagrad update from grads ``2 * out`` (the
    JAX test's step): (outputs, the full tables, the overflow over ranks,
    the step's ledger, the layouts' names)."""
    ebc = ShardedEmbeddingBagCollection.build(
        tbls, pl, env.world_size, 4, {f: cap for f in FEATS},
        hier_topo=HierTopology(S, L))
    params = ebc.params_from_tables(weights, rank=env.rank)
    fused = ebc.init_fused_state(CFG)
    kjt = KeyedJaggedTensor.from_lengths_packed(*kjt_data)
    with wire_accounting() as ledger:
        outs, ctxs = ebc.forward_local(params, kjt, env=env)
        ebc.backward_and_update_local(params, fused, ctxs,
                                      {f: 2.0 * o for f, o in outs.items()},
                                      CFG, env=env)
    ov = ebc.dedup_overflow(ctxs)
    ov = torch.zeros((), dtype=torch.int32) if ov is None else ov
    from torchrec_tpu_torch.parallel.comm import all_gather

    ov_all = int(all_gather(ov.reshape(1), env).sum())
    full = ebc.tables_to_weights(ebc.gather_stacks(params, env))
    return ({f: o.numpy() for f, o in outs.items()},
            {t: w.numpy() for t, w in full.items()}, ov_all, dict(ledger),
            sorted(ebc.group_names))


def _portability(env, flat_env):
    """The planner's hierarchical plan through the DMP on the two-level
    world (hier layouts, 3 steps) and on a flat world of the same ranks
    (no hier layout, 3 steps): (losses, layout names) of each."""
    keys, hashes = ["a", "b"], [64, 48]
    tbls = [EmbeddingBagConfig(num_embeddings=h, embedding_dim=8,
                               name=f"t{k}", feature_names=[k])
            for k, h in zip(keys, hashes)]
    pl = EmbeddingShardingPlanner(
        world_size=S * L, hierarchical=True,
        constraints={t.name: ParameterConstraints(
            sharding_types=[ShardingType.ROW_WISE]) for t in tbls},
    ).plan(tbls)
    hier_flags = [bool(ps.hier) for ps in pl.values()]
    out = {}
    for name, e in (("hier", env), ("flat", flat_env)):
        ds = RandomRecDataset(keys, 4, hashes, [2, 1], num_dense=4,
                              manual_seed=0)
        model = DLRM(EmbeddingBagCollection(tbls, device="meta"), 4, (8, 8),
                     (8, 1))
        dmp = DistributedModelParallel(
            model, tbls, pl, 4, dict(zip(keys, ds.caps)), fused_config=CFG,
            env=e)
        state = dmp.init(torch.Generator().manual_seed(0))
        it = iter(ds)
        batch = [next(it) for _ in range(S * L)][e.rank]
        losses = []
        for _ in range(3):
            state, m = dmp.train_step(state, batch)
            losses.append(float(m["loss"]))
        out[name] = (losses, sorted(dmp.sharded_ebc.rw_layouts),
                     [lay.hier is not None
                      for lay in dmp.sharded_ebc.rw_layouts.values()])
    return hier_flags, out


def hier_rank(weights_general, weights_grid, general, exact, overflow):
    """Every check's data on this rank: ``general`` the zipf-ish weighted
    KJTs (cap 24), ``exact`` {(dedup, cap): KJTs} of the exact regime,
    ``overflow`` the distinct-heavy KJT; each a list of per-rank
    ``from_lengths_packed`` arguments."""
    torch.set_num_threads(1)
    multiprocess.initialize("gloo")
    env = ShardingEnv.from_process_group("gloo", device="cpu", num_slices=S)
    flat_env = ShardingEnv(env.world_size, env.rank, env.device, env.group,
                           env.backend)
    r = env.rank
    assert (env.ici_size, env.slice_rank) == (L, r // L)
    res: Dict[str, object] = {}
    tg = tables(mean_pool=True)
    res["general"] = {
        mode: _run(env, tg, plan(mode == "hier", True), 24, weights_general,
                   general[r])
        for mode in ("flat", "hier")}
    te = tables(mean_pool=False)
    res["exact"] = {
        key: {mode: _run(env, te, plan(mode == "hier", key[0]), key[1],
                         weights_grid, kjts[r])
              for mode in ("flat", "hier")}
        for key, kjts in exact.items()}
    res["overflow"] = _run(env, tg, plan(True, False, hier_factor=1e6), 24,
                           weights_general, overflow[r])[2]
    res["portability"] = _portability(env, flat_env)
    try:
        SequenceModelParallel(None, [], env, {}, 4, {}, None)
        res["smp_refused"] = False
    except ValueError as e:
        res["smp_refused"] = "two-level" in str(e)
    return res
