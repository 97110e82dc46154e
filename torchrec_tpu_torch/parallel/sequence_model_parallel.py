"""SequenceModelParallel: the hybrid train step of models over per-id
(sequence) embeddings (``torchrec_tpu/parallel/sequence_model_parallel.py``),
one process per rank.

The same design as ``model_parallel.DistributedModelParallel``, with a
``ShardedEmbeddingCollection`` (``parallel/embedding.py``) as the sparse
stage: its forward returns each feature's per-id rows ``[cap_f, D]``, the
task's ``loss_fn(model, dense_params, embeddings, batch)`` reads them
(BERT4Rec's masked-item loss builds the dense ``[B, L, D]`` sequence from
them and calls the model's ``forward_from_embeddings``), and the step
takes the gradients of both the dense parameters and the per-id rows.
The rows enter ``loss_fn`` as leaves that require grad, as
``jax.value_and_grad(argnums=(0, 1))`` takes them; a feature the loss
does not read gets a zero gradient.

The step's arithmetic is the JAX step's: the loss and the dense gradients
are averaged over the ranks (summed in rank order, then divided by the
world size, ``comm.all_reduce_sum``), the per-id gradients are divided by
the world size (the reference's gradient division) before the reverse
dists, the collection's fused update applies them through the dedup
fused update (B6, ``csrc/tbe_dedup_backward.cu``; each id its own segment
of weight 1), then the dense optimizer steps (``optim/adam.py``, optax's
Adam, by default at lr 1e-3).  The state is updated in place::

    {"dense": {param name: tensor}, "dense_opt": the optimizer's state,
     "tables": {group: [rows, D] stack}, "fused": {group: state},
     "step": int}

``env`` is the rank's world (``comm.ShardingEnv``); without one the step
runs one rank on ``device``: CUDA unless the caller names another, and it
raises without a card.  Like the JAX class it refuses a 2D world (an env
with replicas).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim.adam import Adam, adam
from torchrec_tpu_torch.parallel.comm import ShardingEnv, all_reduce_sum
from torchrec_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
from torchrec_tpu_torch.parallel.model_parallel import init_dense_params
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

State = Dict[str, Any]
# the model's item collection (BERT4Rec's ``history``): the step's tables
# are the sharded collection's stacks, so these are never read or trained
SPARSE_PREFIX = "history."


class SequenceModelParallel:
    """Compile a (sequence model, plan) pair into init and train-step
    functions for one rank of ``env``.

    ``model`` has ``forward_from_embeddings`` (BERT4Rec); its parameters
    outside :data:`SPARSE_PREFIX` are the dense part, which
    :meth:`init` draws.  ``loss_fn(model, dense_params, embeddings:
    {feature: [cap_f, D]}, batch) -> loss`` defines the task and calls
    the model through ``model_parallel.forward_from_embeddings(model,
    dense_params, ...)``.  ``dense_optimizer``: default
    ``adam(1e-3)``."""

    def __init__(
        self,
        model: nn.Module,
        tables: Sequence[EmbeddingConfig],
        env: Optional[ShardingEnv],
        plan: EmbeddingModuleShardingPlan,
        batch_size_per_device: int,
        feature_caps: Dict[str, int],
        loss_fn: Callable,
        fused_config: Optional[FusedOptimConfig] = None,
        dense_optimizer: Optional[Adam] = None,
        device: DeviceLike = None,
    ):
        if env is None:
            env = ShardingEnv.single_device(device)
        elif device is not None and resolve_device(device) != env.device:
            raise ValueError(f"device {device} vs the env's {env.device}")
        if env.num_slices > 1:
            raise ValueError(
                "SequenceModelParallel runs its dists over one flat world: "
                f"a two-level env of {env.num_slices} slices is refused, as "
                "the JAX class refuses a DCN mesh axis")
        if env.num_replicas > 1:
            raise ValueError("SequenceModelParallel runs on a 1D world: an "
                             f"env of {env.num_replicas} replicas")
        self.env = env
        self.device = env.device
        self.model = model.to(self.device)  # a meta collection stays
        self.tables = tuple(tables)
        self.plan = plan
        self.loss_fn = loss_fn
        self.fused_config = fused_config or FusedOptimConfig()
        self.dense_tx = dense_optimizer or adam(1e-3)
        self.batch_size = batch_size_per_device
        self.sharded_ec = ShardedEmbeddingCollection.build(
            tables, plan, env.world_size, batch_size_per_device,
            feature_caps)

    # -- state -------------------------------------------------------------

    def init(self, generator: torch.Generator) -> State:
        """This rank's share of a fresh train state on the device, every
        random number drawn from ``generator`` (on ``self.device``, seeded
        alike on every rank): the tables (each uniform in +-sqrt(1/rows),
        in table order; the rank keeps its rows), then the dense
        parameters by flax's default initializers
        (``model_parallel.init_dense_params``)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, train step "
                             f"on {self.device}")
        ec = self.sharded_ec
        tables = ec.init_params(generator, rank=self.env.rank)
        fused = ec.init_fused_state(self.fused_config, self.device)
        dense = init_dense_params(self.model, generator, self.device,
                                  SPARSE_PREFIX)
        return {"dense": dense, "dense_opt": self.dense_tx.init(dense),
                "tables": tables, "fused": fused, "step": 0}

    def table_weights(self, state: State) -> Dict[str, np.ndarray]:
        """Full per-table weights from a train state, as float32 numpy
        copies: each sharded group's stacks gathered from every rank (a
        collective: every rank calls it)."""
        ec = self.sharded_ec
        full = ec.gather_stacks(state["tables"], self.env)
        return {name: w.to("cpu", torch.float32, copy=True).numpy()
                for name, w in ec.tables_to_weights(full).items()}

    # -- train step --------------------------------------------------------

    def dense_forward_backward(self, state: State, batch: Batch,
                               emb_values: Mapping[str, torch.Tensor]):
        """The loss on this rank's batch and its gradients: (loss, dense
        gradients by name, per-id gradients by feature), before any
        reduction over ranks."""
        ev = {f: v.detach().requires_grad_() for f, v in emb_values.items()}
        dense = {k: v.detach().requires_grad_()
                 for k, v in state["dense"].items()}
        with torch.enable_grad():
            loss = self.loss_fn(self.model, dense, ev, batch)
            grads = torch.autograd.grad(loss, [*dense.values(),
                                               *ev.values()],
                                        allow_unused=True)
        leaves = [*dense.values(), *ev.values()]
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        g_dense = dict(zip(dense, grads[:len(dense)]))
        g_emb = dict(zip(ev, grads[len(dense):]))
        return loss.detach(), g_dense, g_emb

    def reduce_grads(self, loss: torch.Tensor,
                     g_dense: Dict[str, torch.Tensor],
                     g_emb: Dict[str, torch.Tensor]):
        """The JAX step's reductions: the loss and the dense gradients
        averaged over the ranks (one rank-order sum), the per-id
        gradients divided by the world size."""
        N = self.env.world_size
        if N == 1:
            return loss, g_dense, g_emb
        flat = torch.cat([loss.reshape(1).to(torch.float32)]
                         + [g.reshape(-1) for g in g_dense.values()])
        flat = all_reduce_sum(flat, self.env,
                              tag="dense_grads:all_reduce") / N
        pieces = flat[1:].split([g.numel() for g in g_dense.values()])
        g_dense = {k: p.view_as(g) for (k, g), p in
                   zip(g_dense.items(), pieces)}
        return flat[0], g_dense, {f: g / N for f, g in g_emb.items()}

    def train_step(self, state: State, batch: Batch):
        """One step on this rank's batch (on the device); updates
        ``state`` in place and returns it with ``{"loss": ...}`` (a device
        scalar, the mean over ranks; no host sync)."""
        ec = self.sharded_ec
        outs, ctxs = ec.forward_local(state["tables"],
                                      batch.sparse_features, self.env)
        loss, g_dense, g_emb = self.dense_forward_backward(
            state, batch, {f: jt.values() for f, jt in outs.items()})
        loss, g_dense, g_emb = self.reduce_grads(loss, g_dense, g_emb)
        ec.backward_and_update_local(state["tables"], state["fused"], ctxs,
                                     g_emb, self.fused_config, self.env)
        self.dense_tx.update(state["dense"], g_dense, state["dense_opt"])
        state["step"] += 1
        return state, {"loss": loss}

    def make_train_step(self) -> Callable[[State, Batch], Any]:
        """The train step (JAX's ``make_train_step`` compiles one; the port
        runs eagerly and returns :meth:`train_step`)."""
        return self.train_step
