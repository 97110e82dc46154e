"""The ranks of ``tests/test_torch_dedup_rw.py``: functions that
``multiprocess.launch`` runs in spawned gloo processes on the CPU.  They
import torch, numpy and the port only (the JAX side runs in the test's
own process), take plain data and return numpy."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from torchrec_tpu_torch.convert import train_state_from_jax
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel import train_pipeline as tp
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.qcomm import wire_accounting
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.robustness import GuardrailsConfig
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

from torch_sharding_workers import _join, make_tables


def make_plan(spec: Dict[str, tuple]) -> Dict[str, ParameterSharding]:
    """A plan from ``{table: (sharding type value, ranks, col shards,
    dedup, dedup_factor)}``."""
    return {name: ParameterSharding(ShardingType(st), ranks=ranks,
                                    num_col_shards=ncs, dedup=dedup,
                                    dedup_factor=factor)
            for name, (st, ranks, ncs, dedup, factor) in spec.items()}


def _dmp(tables, spec, keys, caps, batch, dense_in, dense_arch, over_arch,
         lr, env, kernel="tbe", guarded=False):
    model = DLRM(EmbeddingBagCollection(tables, device="meta"), dense_in,
                 dense_arch, over_arch)
    return DistributedModelParallel(
        model, tables, make_plan(spec), batch, caps,
        fused_config=FusedOptimConfig(learning_rate=lr),
        dense_optimizer=adagrad(lr), env=env, lookup_kernel=kernel,
        update_kernel=kernel,
        guardrails=GuardrailsConfig() if guarded else None)


def _poison(batch, key_index, ids):
    kjt = batch.sparse_features
    values = kjt.values().clone()
    start = kjt.cap_offsets()[key_index]
    values[start:start + len(ids)] = torch.tensor(ids, dtype=values.dtype)
    return dataclasses.replace(batch, sparse_features=kjt.with_values(values))


def _thin(batch, keep):
    """``batch`` with the ids of its first ``keep`` examples only, the
    caps kept: a rank with little traffic."""
    kjt = batch.sparse_features
    B, lens = kjt.stride(), kjt.lengths().numpy().copy()
    values = kjt.values().numpy()
    vals = []
    for f in range(kjt.num_keys):
        start = kjt.cap_offsets()[f]
        vals.append(values[start:start + int(lens[f * B:f * B + keep].sum())])
        lens[f * B + keep:(f + 1) * B] = 0
    return dataclasses.replace(
        batch, sparse_features=KeyedJaggedTensor.from_lengths_packed(
            kjt.keys(), np.concatenate(vals), lens, caps=kjt.caps))


def _bucketed_runs(dmp, stream):
    """``BucketedTrainPipeline`` and ``BucketedTrainPipelineSemiSync``
    over this rank's ``stream``, each from the seeded initial state: the
    signature each step dispatched, the downgrade count and the losses."""
    out = {}
    for name, cls in (("sync", tp.BucketedTrainPipeline),
                      ("semi_sync", tp.BucketedTrainPipelineSemiSync)):
        pipe = cls(dmp, dmp.init(torch.Generator().manual_seed(0)))
        it, sigs, losses = iter(stream), [], []
        for _ in stream:
            before = dict(pipe.stats.dispatch_counts)
            losses.append(float(pipe.progress(it)["loss"]))
            (sig,) = [s for s, c in pipe.stats.dispatch_counts.items()
                      if c != before.get(s, 0)]
            sigs.append(list(sig))
        out[name] = {"sigs": sigs, "losses": losses,
                     "overflow": pipe.stats.overflow_fallback_count}
    return out


def dedup_rank(table_spec, jobs, keys, caps, batch, ids, dense_in,
               dense_arch, over_arch, lr, steps, plain_rw, small_spec,
               poison, pipe_spec, heavy, keep):
    """For each job ``(plan spec, the JAX DMP's initial state, its
    replicated groups, kernel, guarded)``: the port's DMP from this
    rank's share, its KT on the first batch against the unsharded
    EmbeddingBagCollection's over the same weights (``torch.equal``),
    ``steps`` train steps (rank ``r`` takes batch ``step * N + r``) with
    their losses and ``dedup_overflow``, the eval forward's logits on the
    next batch, the full tables (rank 0), and for a guarded job one more
    step whose rank-0 batch carries ``poison`` = (key index, ids).  Then
    the id-dist bytes of the first batch's forward under the first job's
    plan and ``plain_rw`` (with this rank's measured duplication), and the
    local and summed ``dedup_overflow`` of one step under
    ``small_spec``.  Last, the bucketed pipelines under ``pipe_spec`` on
    a stream where rank ``heavy[s]`` takes its whole batch of step ``s``
    and every other rank only its first ``keep`` examples
    (``_bucketed_runs``), with this rank's own occupancy and dedup demand
    of each step and the dedup'd layout's geometry."""
    env = _join()
    r, N = env.rank, env.world_size
    tables = make_tables(table_spec)
    rows = [t["rows"] for t in table_spec]
    args = (keys, caps, batch, dense_in, dense_arch, over_arch, lr, env)
    out = []

    def batches():
        return iter(RandomRecDataset(keys, batch, rows, ids,
                                     num_dense=dense_in, manual_seed=0))

    for spec, jax_state, replicated, kernel, guarded in jobs:
        dmp = _dmp(tables, spec, *args, kernel=kernel, guarded=guarded)
        state = train_state_from_jax(jax_state, device="cpu", rank=r,
                                     world_size=N, replicated=replicated)
        weights = dmp.table_weights(state)
        it = batches()
        first = [next(it) for _ in range(N)][r]
        ref = EmbeddingBagCollection(tables, device="cpu",
                                     generator=torch.Generator())
        ref.load_state_dict({t: torch.from_numpy(w)
                             for t, w in weights.items()})
        kt, _ = dmp.sparse_forward(state, first)
        kt_equal = torch.equal(kt, ref(first.sparse_features).values())
        it = batches()
        losses, overflow = [], []
        for _ in range(steps):
            mine = [next(it) for _ in range(N)][r]
            state, m = dmp.train_step(state, mine)
            losses.append(float(m["loss"]))
            overflow.append(int(m["dedup_overflow"])
                            if "dedup_overflow" in m else None)
        logits = dmp.make_forward()(state["dense"], state["tables"],
                                    [next(it) for _ in range(N)][r])
        full = dmp.table_weights(state)
        violations = None
        if guarded:
            mine = [next(it) for _ in range(N)][r]
            if r == 0:
                mine = _poison(mine, *poison)
            _, m = dmp.train_step(state, mine)
            violations = m["id_violations"].numpy()
        out.append((kt_equal, losses, overflow, logits.numpy(),
                    full if r == 0 else None, violations))

    it = batches()
    first = [next(it) for _ in range(N)][r]
    ledgers = {}
    for name, spec in (("dedup", jobs[0][0]), ("plain", plain_rw)):
        dmp = _dmp(tables, spec, *args)
        state = dmp.init(torch.Generator().manual_seed(0))
        with wire_accounting() as ledger:
            dmp.sparse_forward(state, first)
        ledgers[name] = sum(v for k, v in ledger.items() if ":id_dist" in k)
    kjt = first.sparse_features
    lens = kjt.lengths().numpy()
    real = distinct = 0
    for f in range(len(keys)):
        occ = int(lens[f * batch:(f + 1) * batch].sum())
        start = kjt.cap_offsets()[f]
        vals = kjt.values()[start:start + occ].numpy()
        real += vals.size
        distinct += np.unique(vals).size
    small = _dmp(tables, small_spec, *args)
    state = small.init(torch.Generator().manual_seed(0))
    _, ctxs = small.sparse_forward(state, first)
    local = int(small.sharded_ebc.dedup_overflow(ctxs))
    _, m = small.train_step(state, first)

    it = batches()
    stream = []
    for h in heavy:
        mine = [next(it) for _ in range(N)][r]
        stream.append(mine if r == h else _thin(mine, keep))
    pdmp = _dmp(tables, pipe_spec, *args)
    (lay,) = pdmp.sharded_ebc.rw_layouts.values()
    pipes = _bucketed_runs(pdmp, stream)
    pipes["local_occupancy"] = [
        list(b.sparse_features.occupancy_per_key()) for b in stream]
    pipes["local_demand"] = [tp._dedup_demand(lay, [b]) for b in stream]
    pipes["layout"] = ([(f.name, f.table_name) for f in lay.features],
                       dict(lay.block_size), lay.dedup_factor)
    return {"jobs": out, "ledgers": ledgers, "dup": real / distinct,
            "overflow": (local, int(m["dedup_overflow"])),
            "pipelines": pipes}
