"""The ranks of the port's multi-process sequence tests
(``tests/test_torch_sequence_model_parallel.py``,
``tests/test_torch_ring_attention.py``): functions that
``multiprocess.launch`` runs in spawned processes over a gloo process
group on the CPU.  They import torch, numpy and the port only (the JAX
side runs in the test's own process), take plain data and return
numpy."""

from __future__ import annotations

import numpy as np
import torch

from torchrec_tpu_torch.parallel import multiprocess
from torchrec_tpu_torch.parallel.comm import ShardingEnv


def _join() -> ShardingEnv:
    torch.set_num_threads(1)
    multiprocess.initialize("gloo")
    return ShardingEnv.from_process_group("gloo", device="cpu")


def session_batch(data, cap):
    """A port ``Batch`` from ``(values, lengths, targets, mask)``."""
    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    values, lengths, targets, mask = data
    kjt = KeyedJaggedTensor.from_lengths_packed(["item"], values, lengths,
                                                caps=cap)
    return Batch(torch.from_numpy(targets), kjt, torch.from_numpy(mask))


def smp_rank(spec, plans, states, steps):
    """One rank of the sequence test: for each plan kind of ``plans``
    (``{kind: (sharding type value, ranks)}``), BERT4Rec's
    ``SequenceModelParallel`` from the JAX state ``states[kind]`` (numpy
    leaves; this rank keeps its rows), this rank's per-id rows of the
    first step's batch before training (and the unsharded
    ``EmbeddingCollection``'s rows of it), then one train step a batch of
    ``steps`` (``steps[s][r]`` this rank's data).  Also whether the class
    refuses a 2D world.  Returns ({kind: (rows, unsharded rows, losses,
    the full tables on rank 0)}, refused)."""
    from torchrec_tpu_torch.convert import sequence_train_state_from_jax
    from torchrec_tpu_torch.examples.bert4rec.main import make_loss_fn
    from torchrec_tpu_torch.models.experimental.bert4rec import BERT4Rec
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingCollection,
    )
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim.adam import adam
    from torchrec_tpu_torch.parallel.sequence_model_parallel import (
        SequenceModelParallel,
    )
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType,
    )

    env = _join()
    r, N = env.rank, env.world_size
    B, L, V, D, H = (spec[k] for k in ("B", "L", "V", "D", "H"))
    tables = [EmbeddingConfig(num_embeddings=V, embedding_dim=D,
                              name="t_item", feature_names=["item"])]

    def build(kind, e):
        st, ranks = plans[kind]
        return SequenceModelParallel(
            BERT4Rec(V, L, D, spec["blocks"], H, device="meta"), tables, e,
            {"t_item": ParameterSharding(ShardingType(st), ranks=ranks)},
            B, {"item": B * L}, make_loss_fn(L),
            FusedOptimConfig(optim=EmbOptimType.ADAM,
                             learning_rate=spec["lr"]),
            adam(spec["lr"]))

    out = {}
    for kind in plans:
        smp = build(kind, env)
        state = sequence_train_state_from_jax(states[kind], "cpu", rank=r,
                                              world_size=N)
        first = session_batch(steps[0][r], B * L)
        outs, _ = smp.sharded_ec.forward_local(state["tables"],
                                               first.sparse_features, env)
        full = smp.table_weights(state)  # a collective
        ref = EmbeddingCollection(tables, device="cpu",
                                  generator=torch.Generator())
        ref.load_state_dict({"t_item": torch.from_numpy(full["t_item"])})
        want = ref(first.sparse_features)["item"].values().detach()
        losses = []
        for s in range(len(steps)):
            state, m = smp.train_step(state, session_batch(steps[s][r],
                                                           B * L))
            losses.append(float(m["loss"]))
        full = smp.table_weights(state)
        out[kind] = (outs["item"].values().numpy(), want.numpy(), losses,
                     full["t_item"] if r == 0 else None)
    env2 = ShardingEnv.from_process_group("gloo", device="cpu",
                                          num_replicas=2)
    try:
        build(next(iter(plans)), env2)
        refused = False
    except ValueError:
        refused = True
    return out, refused


def ring_rank(cases):
    """One rank of the ring-attention test: for each case ``{q, k, v,
    valid, causal, g}`` (the whole ``[B, T, H, Dh]`` arrays; this rank
    takes its ``T / N`` slice), the ring's output slice and the gradients
    of ``sum(out * g)`` with respect to its q, k and v slices; and the
    sequence-sharded multi-head step's output slice for ``mha``.  Returns
    {case: (out, dq, dk, dv)}."""
    from torchrec_tpu_torch.ops.ring_attention import (
        make_ring_attention_step,
        ring_attention,
    )

    env = _join()
    r, N = env.rank, env.world_size
    out = {}
    for name, c in cases.items():
        n = c["valid"].shape[1] // N

        def mine(a):
            return torch.from_numpy(np.ascontiguousarray(
                a[:, r * n:(r + 1) * n]))

        if name == "mha":
            step = make_ring_attention_step(env, c["heads"], c["causal"])
            params = {k: torch.from_numpy(c[k])
                      for k in ("wq", "wk", "wv", "wo")}
            out[name] = (step(params, mine(c["x"]),
                              mine(c["valid"])).numpy(),)
            continue
        q, k, v = (mine(c[x]).requires_grad_() for x in ("q", "k", "v"))
        o = ring_attention(q, k, v, env, mine(c["valid"]), c["causal"])
        (o * mine(c["g"])).sum().backward()
        out[name] = (o.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
                     v.grad.numpy())
    return out
