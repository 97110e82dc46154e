"""DistributedModelParallel: the hybrid sparse-model-parallel /
dense-data-parallel train step (a subset of
``torchrec_tpu/parallel/model_parallel.py``), one process per rank.

The train state is a dict with the JAX package's keys, each rank holding
its own share::

    {"dense": {param name: tensor},      # the model's parameters
     "dense_opt": {param name: tensor},  # Adagrad sum_of_squares
     "tables": {group: [rows, D] stack}, # this rank's rows; float32 or
                                         # bfloat16
     "fused": {group: optimizer state},  # ops/fused_update.py's layouts,
                                         # e.g. {"momentum": [rows]}
     "step": int}

The dense parameters and data-parallel tables are replicated; the
sharded groups' stacks hold the rank's rows.  :meth:`train_step` runs on
every rank with its own batch and mirrors ``_local_step`` /
``_dense_and_update_local``: the sharded collection's forward (the
dists over the rank's :class:`~torchrec_tpu_torch.parallel.comm.ShardingEnv`
and a pooled kernel of ``ops/tbe.py``), the dense forward and backward
with respect to both the dense parameters and the pooled values (the KT
values are detached and given ``requires_grad``, as
``jax.value_and_grad(argnums=(0, 1))`` takes both), the loss and dense
gradients averaged over ranks (summed in rank order, then divided by the
world size), the KT gradient divided by the world size and split per
feature, the fused backward + optimizer update (a kernel of
``ops/tbe_backward.py``), then the dense Adagrad.  The state is updated in
place, which stands in for the JAX step's buffer donation: the returned
state is the one passed in.

The kernels are arguments, ``lookup_kernel`` and ``update_kernel``, each
``"tbe"`` (the per-id kernels, the default) or ``"dedup"`` (the ragged
dedup kernels; on table-wise and data-parallel groups only, see
``parallel/embeddingbag.py``): the port runs eagerly and reads them at
call time, where the JAX package reads process-wide switches while it
traces (``set_pooled_lookup_kernel``, ``set_sparse_update_kernel``,
``trace_kernels``).  :meth:`with_feature_caps` is the capacity-bucketing
entry point (``parallel/train_pipeline.py``).

The loss is the DLRM's ``bce_with_logits_loss``.  The stochastic-rounding
seeds of bfloat16 tables come from a ``torch.Generator`` seeded per step:
a sharded group's differ by rank, a data-parallel group's are the same on
every rank (the JAX package folds the step, the device and the group
into a ``jax.random`` key; the numbers differ).

Every step returns ``id_overflow``, the ``[F]`` int32 count of ids the
batch's lengths claim beyond each key's capacity, summed over ranks
(``KeyedJaggedTensor.overflow_counts``): a relayout saturates, and this
count keeps the drop visible.  A ``sparse_lr_schedule`` (``optim/
warmup.py``) scales the fused update's lr each step, as the JAX step
does: ``float32(schedule(step)) * learning_rate``, in float32 on the host.
:meth:`make_forward` is the eval forward.  Plans come from
``parallel/planner`` or by hand.  Left out: ``DMPCollection`` (2D
parallelism), qcomms on the DMP, guardrails, dense rematerialisation, the
split (semi-sync) steps ``make_embed_step`` / ``make_dense_update_step``,
row IO helpers and the guardrail metrics (ROADMAP A6, A7).
"""

from __future__ import annotations

import copy
from typing import (
    Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import SPARSE_PREFIX, bce_with_logits_loss
from torchrec_tpu_torch.modules.crossnet import lecun_normal_
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.ops.embedding_ops import POOLED_KERNELS
from torchrec_tpu_torch.ops.fused_update import (
    FusedOptimConfig,
    require_kernel,
)
from torchrec_tpu_torch.optim.adagrad import Adagrad, adagrad
from torchrec_tpu_torch.optim.warmup import Schedule, WarmupOptimizer
from torchrec_tpu_torch.parallel.comm import ShardingEnv, all_reduce_sum
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.types import EmbeddingModuleShardingPlan
from torchrec_tpu_torch.sparse import KeyedTensor
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

State = Dict[str, Any]
SR_SEED_BASE = 0x5EED
_INT32_MAX = 2**31 - 1


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """The batch one process feeds its step: the identity on its one
    batch (the JAX package stacks N batches along a leading device axis;
    the port runs one process per rank, each with its own batch)."""
    if len(batches) != 1:
        raise NotImplementedError(
            f"{len(batches)} batches for one process: each rank's process "
            "feeds its own batch to its own train step"
        )
    return batches[0]


class _FromEmbeddings(nn.Module):
    """A model's ``forward_from_embeddings`` as a module's forward, for
    ``torch.func.functional_call`` (its parameters under ``model.``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, dense_features: torch.Tensor,
                kt: KeyedTensor) -> torch.Tensor:
        return self.model.forward_from_embeddings(dense_features, kt)


class DistributedModelParallel:
    """Compile a (model, plan) pair into init and train-step functions for
    one rank of ``env``.

    ``model`` is the port's ``DLRM``, ``DLRM_DCN`` or ``DLRM_Projection``
    (anything with ``forward_from_embeddings(dense, kt)``, its parameters
    in the layout of ``convert.py``), its ``EmbeddingBagCollection`` best
    built on ``torch.device("meta")``: the step's tables are the group
    stacks of ``tables``, so the model's own tables are never read, and
    its dense parameters (the train state's ``"dense"``) leave them out,
    as the JAX DMP's init through ``forward_from_embeddings`` never
    creates them; ``plan`` maps every table to its
    ``ParameterSharding`` (``types.table_wise_plan`` on one device);
    ``dense_optimizer`` is an
    :class:`~torchrec_tpu_torch.optim.adagrad.Adagrad` (default
    ``adagrad(fused_config.learning_rate)``); ``table_dtype`` is the
    stacks' dtype, float32 or bfloat16 (the momentum stays float32 and
    bfloat16 write-backs round stochastically); ``lookup_kernel`` and
    ``update_kernel`` name the kernels (module docstring; both update
    kernels take all eight fused optimizers, whose states
    ``init`` allocates: an ``[R, D]`` momentum for Adagrad, ``m`` and
    ``v`` for the Adam family).  ``dense_optimizer`` may be a
    :class:`~torchrec_tpu_torch.optim.warmup.WarmupOptimizer`, and
    ``sparse_lr_schedule`` a ``step -> multiplier`` schedule of the fused
    lr (``optim.warmup.warmup_schedule``).  ``env`` is the rank's world
    (``comm.ShardingEnv``); without one the step runs one rank on
    ``device``: CUDA unless the caller names another, and it raises
    without a card.  Every rank builds the same DMP."""

    def __init__(
        self,
        model: nn.Module,
        tables: Sequence[EmbeddingBagConfig],
        plan: EmbeddingModuleShardingPlan,
        batch_size_per_device: int,
        feature_caps: Dict[str, int],
        fused_config: Optional[FusedOptimConfig] = None,
        dense_optimizer: Optional[Union[Adagrad, WarmupOptimizer]] = None,
        table_dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
        lookup_kernel: str = "tbe",
        update_kernel: str = "tbe",
        env: Optional[ShardingEnv] = None,
        sparse_lr_schedule: Optional[Schedule] = None,
    ):
        if table_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"table_dtype must be float32 or bfloat16, got "
                            f"{table_dtype}")
        self.fused_config = fused_config or FusedOptimConfig()
        self._set_kernels(lookup_kernel, update_kernel)
        if env is None:
            env = ShardingEnv.single_device(device)
        elif device is not None and resolve_device(device) != env.device:
            raise ValueError(f"device {device} vs the env's {env.device}")
        self.env = env
        self.device = env.device
        self.model = model.to(self.device)  # a meta collection stays
        self._dense_forward = _FromEmbeddings(self.model)
        self.tables = tuple(tables)
        self.plan = plan
        self.batch_size = batch_size_per_device
        self.feature_caps = dict(feature_caps)
        self.dense_tx = dense_optimizer or adagrad(
            self.fused_config.learning_rate)
        self.table_dtype = table_dtype
        self.sparse_lr_schedule = sparse_lr_schedule
        self.sharded_ebc = ShardedEmbeddingBagCollection.build(
            tables, plan, env.world_size, batch_size_per_device,
            feature_caps)

    def _set_kernels(self, lookup_kernel: str, update_kernel: str) -> None:
        if lookup_kernel not in POOLED_KERNELS:
            raise ValueError(
                f"unknown pooled-lookup kernel {lookup_kernel!r}")
        require_kernel(update_kernel)
        self.lookup_kernel = lookup_kernel
        self.update_kernel = update_kernel

    def with_feature_caps(
        self,
        feature_caps: Mapping[str, int],
        lookup_kernel: Optional[str] = None,
        update_kernel: Optional[str] = None,
    ) -> "DistributedModelParallel":
        """Shallow clone with the group layouts rebuilt for other
        per-feature id capacities (and, when given, other kernels).
        Capacities shape only the slot geometry; parameters and optimizer
        state are shaped by table rows, so the clone's train step runs on
        the same train state as the original."""
        missing = set(self.feature_caps) - set(feature_caps)
        if missing:
            raise ValueError(f"with_feature_caps: missing features "
                             f"{sorted(missing)}")
        clone = copy.copy(self)
        clone._set_kernels(lookup_kernel or self.lookup_kernel,
                           update_kernel or self.update_kernel)
        clone.feature_caps = {k: int(feature_caps[k])
                              for k in self.feature_caps}
        clone.sharded_ebc = ShardedEmbeddingBagCollection.build(
            self.tables, self.plan, self.env.world_size, self.batch_size,
            clone.feature_caps)
        return clone

    # -- state -------------------------------------------------------------

    def _init_dense(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """flax's defaults from ``generator``, in parameter order: every
        matrix lecun-normal (variance 1 / fan_in, truncated at two standard
        deviations), every bias zero.  fan_in is flax's ``shape[-2]`` of
        the flax layout: an ``nn.Linear.weight`` is a transposed flax
        ``kernel``, so its ``shape[1]``; any other matrix (the cross net's
        ``w_l`` and ``v_l``) is stored as flax has it, so its
        ``shape[0]``."""
        out = {}
        for name, p in self.model.named_parameters():
            if name.startswith(SPARSE_PREFIX):
                continue
            t = torch.zeros(p.shape, dtype=torch.float32, device=self.device)
            if p.dim() == 2:
                fan_in = p.shape[1] if name.endswith("weight") else p.shape[0]
                lecun_normal_(t, fan_in, generator)
            out[name] = t
        return out

    def init(self, generator: torch.Generator) -> State:
        """This rank's share of a fresh train state on the device, every
        random number drawn from ``generator`` (a generator on
        ``self.device``, seeded alike on every rank): the tables (each
        uniform in +-sqrt(1/rows), in table order; the rank keeps its
        rows), then the dense parameters."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, train step "
                             f"on {self.device}")
        ebc = self.sharded_ebc
        tables = ebc.init_params(generator, dtype=self.table_dtype,
                                 rank=self.env.rank)
        fused = ebc.init_fused_state(self.fused_config, self.device)
        dense = self._init_dense(generator)
        return {
            "dense": dense,
            "dense_opt": self.dense_tx.init(dense),
            "tables": tables,
            "fused": fused,
            "step": 0,
        }

    def table_weights(self, state: State) -> Dict[str, np.ndarray]:
        """Full per-table weights from a train state, as float32 numpy
        copies (bfloat16 stacks widen exactly; a later step does not
        change them): each sharded group's stacks gathered from every rank
        (a collective: every rank calls it)."""
        ebc = self.sharded_ebc
        full = ebc.gather_stacks(state["tables"], self.env)
        return {
            name: w.to("cpu", torch.float32, copy=True).numpy()
            for name, w in ebc.tables_to_weights(full).items()
        }

    def load_table_weights(
        self, state: State, weights: Mapping[str, Any]
    ) -> State:
        """Inverse of :meth:`table_weights`: copy full per-table weights
        (numpy or tensors) into the state's stacks, in place."""
        packed = self.sharded_ebc.params_from_tables(
            weights, self.table_dtype, self.device, rank=self.env.rank)
        for name, t in packed.items():
            state["tables"][name].copy_(t)
        return state

    # -- train step --------------------------------------------------------

    def sr_seeds(self, step: int) -> Optional[Tuple[int, ...]]:
        """One int32 stochastic-rounding seed per group (the sharded
        collection's ``group_names`` order) for ``step``, from a generator
        seeded with the step: ``world_size`` seeds per sharded group, one
        for each rank's rows, then one per data-parallel group, the same
        on every rank so that the replicas apply the same update.  None
        for float32 tables."""
        if self.table_dtype != torch.bfloat16:
            return None
        ebc = self.sharded_ebc
        n, N = len(ebc.sharded_layouts), self.env.world_size
        gen = torch.Generator().manual_seed((SR_SEED_BASE << 32) + step)
        seeds = [int(s) for s in torch.randint(
            0, _INT32_MAX, (N * n + len(ebc.dp_groups),), generator=gen)]
        r = self.env.rank
        return tuple(seeds[r * n:(r + 1) * n] + seeds[N * n:])

    def sparse_forward(
        self, state: State, batch: Batch
    ) -> Tuple[torch.Tensor, Dict[str, Tuple]]:
        """The sharded collection's forward: (pooled KT values [B, sum of
        dims], ctx per group)."""
        ebc = self.sharded_ebc
        outs, ctxs = ebc.forward_local(state["tables"], batch.sparse_features,
                                       self.lookup_kernel, self.env)
        return ebc.output_kt(outs).values(), ctxs

    def dense_forward_backward(
        self, state: State, batch: Batch, kt_values: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor],
               Dict[str, torch.Tensor]]:
        """Dense forward and backward on the pooled values: (loss and
        dense gradients averaged over ranks, this rank's logits [B], dense
        gradients by name, this rank's KT gradient divided by the world
        size and split per feature)."""
        ebc = self.sharded_ebc
        kv = kt_values.detach().requires_grad_()
        dense = {k: v.detach().requires_grad_()
                 for k, v in state["dense"].items()}
        with torch.enable_grad():
            kt = KeyedTensor(ebc.feature_order, ebc.feature_dims, kv)
            logits = torch.func.functional_call(
                self._dense_forward, {f"model.{k}": v for k, v in
                                      dense.items()},
                (batch.dense_features, kt))
            loss = bce_with_logits_loss(logits, batch.labels, batch.weights)
            grads = torch.autograd.grad(loss, [*dense.values(), kv])
        loss = loss.detach()
        g_dense = dict(zip(dense, grads[:-1]))
        N = self.env.world_size
        if N > 1:
            # the pmeans of the JAX step: one sum over ranks of the loss
            # and every dense gradient, in rank order, then / N
            flat = torch.cat([loss.reshape(1).to(torch.float32)]
                             + [g.reshape(-1) for g in g_dense.values()])
            flat = all_reduce_sum(flat, self.env) / N
            loss = flat[0]
            pieces = flat[1:].split([g.numel() for g in g_dense.values()])
            g_dense = {k: p.view_as(g) for (k, g), p in
                       zip(g_dense.items(), pieces)}
        # the global loss is the mean over ranks, so each rank's KT
        # gradient (whose contributions the sparse path sums) is / N
        g_kv = grads[-1] / N if N > 1 else grads[-1]
        offs = kt.offset_per_key()
        grad_by_feature = {
            f: g_kv[:, offs[i]: offs[i + 1]]
            for i, f in enumerate(ebc.feature_order)
        }
        return loss, logits.detach().reshape(-1), g_dense, grad_by_feature

    def sparse_lr(self, step: int) -> Optional[float]:
        """The fused update's lr at ``step`` under the sparse lr schedule,
        ``float32(schedule(step)) * float32(learning_rate)`` rounded to
        float32 as the JAX step forms it (None without a schedule)."""
        if self.sparse_lr_schedule is None:
            return None
        return float(np.float32(self.sparse_lr_schedule(step))
                     * np.float32(self.fused_config.learning_rate))

    def train_step(self, state: State, batch: Batch) -> Tuple[State, Dict]:
        """One step on a batch already on the device; updates ``state`` in
        place and returns it with the metrics (loss, logits, labels and
        ``id_overflow``, as device tensors; no host sync)."""
        kt_values, ctxs = self.sparse_forward(state, batch)
        loss, logits, g_dense, grad_by_feature = self.dense_forward_backward(
            state, batch, kt_values)
        self.sharded_ebc.backward_and_update_local(
            state["tables"], state["fused"], ctxs, grad_by_feature,
            self.fused_config, sr_seeds=self.sr_seeds(state["step"]),
            update_kernel=self.update_kernel, env=self.env,
            learning_rate=self.sparse_lr(state["step"]),
        )
        self.dense_tx.update(state["dense"], g_dense, state["dense_opt"])
        state["step"] += 1
        overflow = all_reduce_sum(batch.sparse_features.overflow_counts(),
                                  self.env)
        return state, {"loss": loss, "logits": logits,
                       "labels": batch.labels.reshape(-1),
                       "id_overflow": overflow}

    def make_train_step(self) -> Callable[[State, Batch], Tuple[State, Dict]]:
        """The train step (JAX's ``make_train_step`` compiles one; the port
        runs eagerly and returns :meth:`train_step`)."""
        return self.train_step

    def forward(self, dense: Mapping[str, torch.Tensor],
                tables: Mapping[str, torch.Tensor],
                batch: Batch) -> torch.Tensor:
        """This rank's logits ``[B]`` of its batch: the sharded
        collection's forward (the dists and the pooled kernel) and the
        dense ``forward_from_embeddings``, with no autograd graph.  A
        collective at more than one rank: every rank calls it."""
        with torch.no_grad():
            kt_values, _ = self.sparse_forward({"tables": tables}, batch)
            ebc = self.sharded_ebc
            kt = KeyedTensor(ebc.feature_order, ebc.feature_dims, kt_values)
            logits = torch.func.functional_call(
                self._dense_forward,
                {f"model.{k}": v for k, v in dense.items()},
                (batch.dense_features, kt))
        return logits.reshape(-1)

    def make_forward(self) -> Callable[[Mapping[str, torch.Tensor],
                                        Mapping[str, torch.Tensor], Batch],
                                       torch.Tensor]:
        """The eval forward ``(dense_params, tables, batch) -> logits
        [B]`` of this rank (JAX's ``make_forward`` compiles one over the
        mesh, logits ``[N, B]``; each rank here returns its own row):
        :meth:`forward`."""
        return self.forward
