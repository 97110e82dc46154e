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
``"tbe"`` (the per-id kernels) or ``"dedup"`` (the ragged dedup kernels,
on every group; see ``parallel/embeddingbag.py``).  Left None, each is
read from the process-wide registry
(``set_pooled_lookup_kernel``, ``set_sparse_update_kernel``,
``trace_kernels`` of ``ops/``) when the DMP is built, and again when a
bucketed signature's clone is built, the port's counterpart of the JAX
package reading those switches while it traces; the default registry
gives the per-id kernels (B1, B2).  :meth:`with_feature_caps` is the capacity-bucketing
entry point (``parallel/train_pipeline.py``).

The loss is the DLRM's ``bce_with_logits_loss``.  The stochastic-rounding
seeds of bfloat16 tables come from a ``torch.Generator`` seeded per step:
a sharded group's differ by rank, a data-parallel group's are the same on
every rank (the JAX package folds the step, the device and the group
into a ``jax.random`` key; the numbers differ).

Every step returns ``id_overflow``, the ``[F]`` int32 count of ids the
batch's lengths claim beyond each key's capacity, summed over ranks
(``KeyedJaggedTensor.overflow_counts``): a relayout saturates, and this
count keeps the drop visible.  The sums over ranks are
``comm.all_reduce_sum`` (a reduce-scatter and an all-gather, in rank
order), the dense gradients' under the ledger tag
``dense_grads:all_reduce``.  A ``sparse_lr_schedule`` (``optim/
warmup.py``) scales the fused update's lr each step, as the JAX step
does: ``float32(schedule(step)) * learning_rate``, in float32 on the host.
:meth:`make_forward` is the eval forward; :meth:`make_embed_step` and
:meth:`make_dense_update_step` are the two halves of the split
(semi-sync) step, which on one batch give :meth:`train_step`'s result.
``qcomms`` (``parallel/qcomm.py``) sets the wire precision of the sharded
groups' pooled dists.  Plans come from ``parallel/planner`` or by hand.

:class:`DMPCollection` is 2D parallelism over an env of ``num_replicas``
replicas of ``world_size`` model ranks (``comm.ShardingEnv``): REPLICATED
(each replica its own copy of every table, averaged by :meth:`~DMPCollection.sync`
every ``sync_interval`` steps) or FULLY_SHARDED (each rank a slice of its
model rank's stacks, gathered over the replicas for the forward; every
replica's gradients applied to each slice every step).  The dense
gradients and the loss are averaged over all ranks; the KT gradient is
divided by ``world_size``, the model group's size, as in the JAX step.

``guardrails`` (a ``robustness.GuardrailsConfig``) with its
``traced_sanitize`` on runs the traced id sanitizer in every step and
forward; the step then also returns ``id_violations``, the ``[F]`` int32
count of ids remapped to the null row, and a plan with a dedup'd
row-wise group returns ``dedup_overflow``, the distinct ids its wire
capacity dropped; both summed over ranks like ``id_overflow``, and each
present exactly when the JAX step emits it.

On a two-level env (``ShardingEnv`` with ``num_slices``; the JAX
package's ``(dcn, model)`` mesh) the plan's ``hier`` entries compile to
the two-level ICI/DCN dists (``parallel/sharding/hier.py``), whose dropped
rows ``dedup_overflow`` counts too; on a flat env the same plan runs the
flat dists.  Every step takes a variable-batch KJT with inverse indices
(``parallel/embeddingbag.py``).

The row-state surface reads and writes table rows and their per-row
optimizer slots in the live state, in place on the device (index writes
and gathers on the stacks): :meth:`~DistributedModelParallel.
reset_table_rows`, :meth:`~DistributedModelParallel.set_table_rows`,
:meth:`~DistributedModelParallel.gather_row_state` and
:meth:`~DistributedModelParallel.scatter_row_state`.  Each rank writes only
the rows it holds (a row another rank owns is skipped there);
``gather_row_state`` is a collective.  :meth:`~DistributedModelParallel.
gather_group_state` gathers every rank's stacks and fused states into the
JAX package's global group layout (the checkpoint's and the reshard's),
:meth:`~DistributedModelParallel.local_fused_state` takes a rank's share
of fused states back out of it, and ``_fused_struct`` gives the layout's
slot shapes.

Left out: dense rematerialisation.
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
from torchrec_tpu_torch.ops.embedding_ops import resolve_lookup_kernel
from torchrec_tpu_torch.ops.fused_update import (
    FusedOptimConfig,
    SparseSegGrad,
    apply_sparse_update_segments,
    resolve_update_kernel,
)
from torchrec_tpu_torch.optim.adagrad import Adagrad, adagrad
from torchrec_tpu_torch.optim.warmup import Schedule, WarmupOptimizer
from torchrec_tpu_torch.parallel.comm import (
    ShardingEnv,
    all_gather,
    all_reduce_sum,
)
from torchrec_tpu_torch.parallel.embeddingbag import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.qcomm import QCommsConfig, record_wire_bytes
from torchrec_tpu_torch.parallel.types import (
    EmbeddingModuleShardingPlan,
    ShardingStrategy,
)
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


def _gather_counted(x: torch.Tensor, env: ShardingEnv,
                    tag: str) -> torch.Tensor:
    """``comm.all_gather`` over ``env``, its bytes (``x``'s own dtype,
    times the fan-out) in the ledger under ``tag``."""
    record_wire_bytes(tag, x.numel() * x.element_size() * env.world_size,
                      env.dcn_fraction)
    return all_gather(x, env)


class _FromEmbeddings(nn.Module):
    """A model's ``forward_from_embeddings`` as a module's forward, for
    ``torch.func.functional_call`` (its parameters under ``model.``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args) -> torch.Tensor:
        return self.model.forward_from_embeddings(*args)


def forward_from_embeddings(model: nn.Module,
                            params: Mapping[str, torch.Tensor],
                            *args) -> torch.Tensor:
    """``model.forward_from_embeddings(*args)`` with ``params`` (the
    model's parameter names) in place of its own parameters: the
    functional form a loss over the train state's ``"dense"`` calls."""
    return torch.func.functional_call(
        _FromEmbeddings(model), {f"model.{k}": v for k, v in params.items()},
        args)


def init_dense_params(model: nn.Module, generator: torch.Generator,
                      device: torch.device,
                      skip_prefix: str = SPARSE_PREFIX
                      ) -> Dict[str, torch.Tensor]:
    """flax's default initializers from ``generator``, in parameter order,
    for every parameter outside ``skip_prefix``: every matrix
    lecun-normal (variance 1 / fan_in, truncated at two standard
    deviations), every bias zero, a LayerNorm's scale one and an
    embedding table normal with variance 1 / its width (flax ``nn.Embed``).
    fan_in is flax's ``shape[-2]`` of the flax layout: an
    ``nn.Linear.weight`` is a transposed flax ``kernel`` (a
    ``DenseGeneral`` kernel flattened), so its ``shape[1]``; any other
    matrix (the cross nets' weights) is stored as flax has it, so its
    ``shape[0]``."""
    kinds = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            kinds[f"{mname}.{pname}" if mname else pname] = type(m)
    out = {}
    for name, p in model.named_parameters():
        if name.startswith(skip_prefix):
            continue
        t = torch.zeros(p.shape, dtype=torch.float32, device=device)
        kind = kinds[name]
        if issubclass(kind, nn.LayerNorm):
            if name.endswith("weight"):
                t.fill_(1.0)
        elif issubclass(kind, nn.Embedding):
            t.normal_(0.0, 1.0, generator=generator).mul_(
                float(np.sqrt(1.0 / p.shape[1])))
        elif p.dim() == 2:
            fan_in = p.shape[1] if name.endswith("weight") else p.shape[0]
            lecun_normal_(t, fan_in, generator)
        out[name] = t
    return out


class DistributedModelParallel:
    """Compile a (model, plan) pair into init and train-step functions for
    one rank of ``env``.

    ``model`` is the port's ``DLRM``, ``DLRM_DCN``, ``DLRM_Projection``,
    ``DLRM_Transformer`` or ``SimpleDeepFMNN`` (anything with
    ``forward_from_embeddings(dense, kt)``, its parameters
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
    stacks' dtype, float32 or bfloat16 (the optimizer state takes
    ``fused_config.momentum_dtype``, and bfloat16 write-backs round
    stochastically unless ``fused_config.stochastic_rounding`` is off);
    ``lookup_kernel`` and
    ``update_kernel`` name the kernels (module docstring; both update
    kernels take all eight fused optimizers, whose states
    ``init`` allocates: an ``[R, D]`` momentum for Adagrad, ``m`` and
    ``v`` for the Adam family).  ``dense_optimizer`` may be a
    :class:`~torchrec_tpu_torch.optim.warmup.WarmupOptimizer`, and
    ``sparse_lr_schedule`` a ``step -> multiplier`` schedule of the fused
    lr (``optim.warmup.warmup_schedule``).  ``env`` is the rank's world
    (``comm.ShardingEnv``); without one the step runs one rank on
    ``device``: CUDA unless the caller names another, and it raises
    without a card.  ``qcomms`` is the sharded groups' wire precision and
    ``row_align`` a multiple every sharded stack is rounded up to;
    ``guardrails`` the traced sanitizer (module docstring).  Every rank
    builds the same DMP."""

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
        lookup_kernel: Optional[str] = None,
        update_kernel: Optional[str] = None,
        env: Optional[ShardingEnv] = None,
        sparse_lr_schedule: Optional[Schedule] = None,
        qcomms: Optional[QCommsConfig] = None,
        row_align: int = 1,
        guardrails=None,
    ):
        if table_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"table_dtype must be float32 or bfloat16, got "
                            f"{table_dtype}")
        self.fused_config = fused_config or FusedOptimConfig()
        # the kernels the caller named (None: the registry's at each build)
        self._kernel_args = (lookup_kernel, update_kernel)
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
        self.qcomms = qcomms
        self.row_align = row_align
        self.guardrails = guardrails
        self.sharded_ebc = self._build_ebc(self.feature_caps)

    @property
    def _traced_sanitize(self) -> bool:
        """Whether the steps run the traced id sanitizer (guardrails with
        ``traced_sanitize`` on)."""
        return bool(self.guardrails is not None
                    and getattr(self.guardrails, "traced_sanitize", False))

    @property
    def _hier_topo(self):
        """The env's two-level topology (None on a flat world): the plan's
        ``hier`` entries compile to the two-level dists on it."""
        if self.env.num_slices == 1:
            return None
        from torchrec_tpu_torch.parallel.sharding.hier import HierTopology

        return HierTopology(self.env.num_slices, self.env.ici_size)

    def _build_ebc(self, feature_caps) -> ShardedEmbeddingBagCollection:
        return ShardedEmbeddingBagCollection.build(
            self.tables, self.plan, self.env.world_size, self.batch_size,
            feature_caps, qcomms=self.qcomms, row_align=self.row_align,
            sanitize=self._traced_sanitize, hier_topo=self._hier_topo)

    def _set_kernels(self, lookup_kernel: Optional[str],
                     update_kernel: Optional[str]) -> None:
        self.lookup_kernel = resolve_lookup_kernel(lookup_kernel)
        self.update_kernel = resolve_update_kernel(update_kernel)

    def with_feature_caps(
        self,
        feature_caps: Mapping[str, int],
        lookup_kernel: Optional[str] = None,
        update_kernel: Optional[str] = None,
    ) -> "DistributedModelParallel":
        """Shallow clone with the group layouts rebuilt for other
        per-feature id capacities (and, when given, other kernels), each
        dedup'd group's distinct-id capacity re-derived from the new caps.
        Capacities shape only the slot geometry; parameters and optimizer
        state are shaped by table rows, so the clone's train step runs on
        the same train state as the original.  A kernel neither given here
        nor named when the DMP was built is read from the registry
        again."""
        missing = set(self.feature_caps) - set(feature_caps)
        if missing:
            raise ValueError(f"with_feature_caps: missing features "
                             f"{sorted(missing)}")
        clone = copy.copy(self)
        clone._set_kernels(lookup_kernel or self._kernel_args[0],
                           update_kernel or self._kernel_args[1])
        clone.feature_caps = {k: int(feature_caps[k])
                              for k in self.feature_caps}
        clone.sharded_ebc = clone._build_ebc(clone.feature_caps)
        return clone

    # -- state -------------------------------------------------------------

    def _init_dense(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The dense parameters, drawn by :func:`init_dense_params`."""
        return init_dense_params(self.model, generator, self.device)

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
            "tables": self._local_share(tables),
            "fused": self._local_share(fused),
            "step": 0,
        }

    def _local_share(self, groups: Dict[str, Any]) -> Dict[str, Any]:
        """The share of a model rank's group stacks (or states) this
        process holds: all of it (``DMPCollection`` FULLY_SHARDED keeps a
        slice)."""
        return groups

    def _full_stacks(self, tables: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The model rank's whole stacks from this process's share (the
        identity here; a collective under FULLY_SHARDED)."""
        return dict(tables)

    def table_weights(self, state: State) -> Dict[str, np.ndarray]:
        """Full per-table weights from a train state, as float32 numpy
        copies (bfloat16 stacks widen exactly; a later step does not
        change them): each sharded group's stacks gathered from every rank
        (a collective: every rank calls it)."""
        ebc = self.sharded_ebc
        full = ebc.gather_stacks(self._full_stacks(state["tables"]), self.env)
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
        for name, t in self._local_share(packed).items():
            state["tables"][name].copy_(t)
        return state

    # -- the global group layout (checkpoint, reshard) --------------------

    def _fused_struct(self) -> Dict[str, Dict[str, Tuple[int, ...]]]:
        """Every group's fused-state slot shapes in the global layout (a
        sharded group's ranks concatenated, ``world_size`` times its
        rows), ``()`` for a scalar (the Adam family's ``step``): what
        ``Checkpointer`` holds a checkpoint's ``fused`` entry to.  Nothing
        is allocated."""
        ebc = self.sharded_ebc
        fused = ebc.init_fused_state(self.fused_config, "meta")
        N = self.env.world_size
        out = {}
        for name, st in fused.items():
            n = 1 if name in ebc.dp_groups else N
            out[name] = {k: ((n * v.shape[0],) + tuple(v.shape[1:])
                             if isinstance(v, torch.Tensor) else ())
                         for k, v in st.items()}
        return out

    def _model_rank_groups(self, groups: Mapping[str, Any],
                           replica_mean: bool = True) -> Dict[str, Any]:
        """The model rank's whole group stacks (or fused states) from this
        process's share: the share itself here (``DMPCollection``: the
        replicas' mean or replica 0's copy, or the slices gathered)."""
        return dict(groups)

    def gather_group_state(
        self, state: State, replica_mean: bool = True
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict[str, Any]]]:
        """(tables, fused) in the JAX package's global group layout: each
        sharded group's stack and fused arrays of every rank,
        concatenated in rank order; a data-parallel group's as they are;
        scalars as they are.  Under 2D parallelism the model rank's copy
        is the replicas' mean (``replica_mean``) or replica 0's.  A
        collective: every rank calls it, and every rank gets the whole."""
        ebc, env = self.sharded_ebc, self.env
        tables = self._model_rank_groups(state["tables"], replica_mean)
        fused = self._model_rank_groups(state["fused"], replica_mean)

        def whole(name, x):
            if (name in ebc.dp_groups or not isinstance(x, torch.Tensor)
                    or x.dim() == 0):
                return x
            return all_gather(x, env).flatten(0, 1)

        return ({n: whole(n, t) for n, t in tables.items()},
                {n: {k: whole(n, v) for k, v in st.items()}
                 for n, st in fused.items()})

    def local_fused_state(self, fused: Mapping[str, Mapping]
                          ) -> Dict[str, Dict[str, Any]]:
        """This process's share of global-layout fused states (numpy or
        tensors, :meth:`gather_group_state`'s), on the device: each array
        in the dtype the optimizer's state takes, a scalar as an int."""
        ebc, r = self.sharded_ebc, self.env.rank
        zero = ebc.init_fused_state(self.fused_config, "meta")

        def mine(name, key, x):
            if not hasattr(x, "shape") or len(x.shape) == 0:
                return int(x)
            t = torch.as_tensor(x)
            if name not in ebc.dp_groups:
                L = ebc.local_rows(name)
                t = t[r * L:(r + 1) * L]
            return t.to(self.device, zero[name][key].dtype,
                        copy=True).contiguous()

        return self._local_share({n: {k: mine(n, k, v) for k, v in st.items()}
                                  for n, st in fused.items()})

    # -- the row-state surface ---------------------------------------------

    def _tile_stack_rows(self, name: str, stack_rows: np.ndarray,
                         which: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Rows of the model rank's stack of group ``name`` -> (the rows of
        this process's share that hold them, which of the request they
        are): every one here (``DMPCollection`` FULLY_SHARDED keeps those
        in its slice)."""
        return stack_rows, which

    def _row_owners_env(self) -> ShardingEnv:
        """The ranks among which each row of a sharded group is held once:
        the model group (``DMPCollection`` FULLY_SHARDED: every rank)."""
        return self.env

    def _rows_here(self, table: str, rows) -> Tuple[str, torch.Tensor,
                                                    np.ndarray]:
        """(group, this process's stack rows holding ``table``'s ``rows``
        as a device index, which of ``rows`` they are): one entry per
        column shard; rows other ranks hold are left out."""
        rows = np.ascontiguousarray(rows, np.int64)
        name, stack_rows, which = self.sharded_ebc.stack_rows_for_table(
            table, rows, rank=self.env.rank)
        stack_rows, which = self._tile_stack_rows(name, stack_rows, which)
        return (name, torch.as_tensor(stack_rows, dtype=torch.int64,
                                      device=self.device), which)

    def reset_table_rows(self, state: State, table: str, rows) -> State:
        """Zero a table's rows in the live train state, in place (ZCH
        eviction and ITEP pruning reset rows so), every column shard this
        process holds."""
        name, idx, _ = self._rows_here(table, rows)
        if idx.numel():
            state["tables"][name].index_fill_(0, idx, 0.0)
        return state

    def _single_column_shard(self, table: str, what: str) -> None:
        ps = self.plan.get(table)
        if ps is not None and ps.num_col_shards != 1:
            raise ValueError(f"{what} needs a single-column-shard plan for "
                             f"{table}; got {ps.num_col_shards} column "
                             "shards")

    def set_table_rows(self, state: State, table: str, rows,
                       values) -> State:
        """Write a table's rows (``values`` ``[k, D]``, numpy or a tensor)
        into the live train state, in place (the parameter-server restore
        path); each process writes the rows it holds.  A single column
        shard only."""
        self._single_column_shard(table, "set_table_rows")
        rows = np.ascontiguousarray(rows, np.int64)
        name, idx, which = self._rows_here(table, rows)
        if idx.numel():
            t = state["tables"][name]
            vals = torch.as_tensor(values).reshape(rows.size, -1)
            t.index_copy_(0, idx, vals[torch.as_tensor(which)].to(
                t.device, t.dtype))
        return state

    def gather_row_state(self, state: State, table: str, rows,
                         opt_slots: Optional[Mapping[str, int]] = None
                         ) -> np.ndarray:
        """A table's rows and their per-row fused slots as one packed
        float32 host array ``[k, D + sum of widths]``; ``opt_slots`` is the
        ordered slot -> width map, the packing :meth:`scatter_row_state`
        inverts.  Each row comes from the rank that holds it (summed over
        ranks: a collective at more than one rank; under REPLICATED each
        replica's own copy, under FULLY_SHARDED the slice that holds it).
        A single column shard only."""
        return self.gather_row_state_tensor(state, table, rows,
                                            opt_slots).cpu().numpy()

    def gather_row_state_tensor(self, state: State, table: str, rows,
                                opt_slots: Optional[Mapping[str, int]] = None
                                ) -> torch.Tensor:
        """:meth:`gather_row_state` left on the device: the packed rows as
        a float32 ``[k, D + sum of widths]`` tensor, gathered on the
        current stream."""
        self._single_column_shard(table, "gather_row_state")
        rows = np.ascontiguousarray(rows, np.int64)
        k = rows.size
        name, idx, which = self._rows_here(table, rows)
        D = {c.name: c.embedding_dim for c in self.tables}[table]
        widths = dict(opt_slots or {})
        out = torch.zeros((k, D + sum(widths.values())), dtype=torch.float32,
                          device=self.device)
        w = torch.as_tensor(which, dtype=torch.int64, device=self.device)
        cols = [state["tables"][name].index_select(0, idx).float()]
        for slot, width in widths.items():
            full = state["fused"][name][slot]
            per_row = full[0].numel() if full.shape[0] else width
            if per_row != width:
                raise ValueError(f"fused slot {slot} of {table}: width "
                                 f"{per_row} != declared {width}")
            cols.append(full.index_select(0, idx).float().reshape(
                idx.numel(), width))
        out.index_copy_(0, w, torch.cat(cols, dim=1))
        owners = self._row_owners_env()
        if name not in self.sharded_ebc.dp_groups and owners.world_size > 1:
            out = all_reduce_sum(out, owners, tag="row_state:all_reduce")
        return out

    def scatter_row_state(self, state: State, table: str, rows, packed,
                          opt_slots: Optional[Mapping[str, int]] = None
                          ) -> State:
        """Inverse of :meth:`gather_row_state`: write packed ``[k, D +
        widths]`` rows (weights, then each slot; a host array or a tensor
        on any device) into the live train state, in place, on the current
        stream; each process writes the rows it holds."""
        self._single_column_shard(table, "scatter_row_state")
        rows = np.ascontiguousarray(rows, np.int64)
        name, idx, which = self._rows_here(table, rows)
        if not idx.numel():
            return state
        D = {c.name: c.embedding_dim for c in self.tables}[table]
        if isinstance(packed, torch.Tensor):
            p = packed.to(self.device, torch.float32).reshape(rows.size, -1)
        else:
            p = torch.as_tensor(np.ascontiguousarray(packed, np.float32)
                                ).reshape(rows.size, -1).to(self.device)
        if which.size != rows.size or not (
                which == np.arange(rows.size)).all():
            p = p[torch.as_tensor(which, device=p.device)]
        t = state["tables"][name]
        t.index_copy_(0, idx, p[:, :D].to(t.dtype))
        off = D
        for slot, width in (opt_slots or {}).items():
            s = state["fused"][name][slot]
            v = p[:, off:off + width].reshape((idx.numel(),)
                                              + tuple(s.shape[1:]))
            s.index_copy_(0, idx, v.to(s.dtype))
            off += width
        return state

    # -- train step --------------------------------------------------------

    def _seed_ranks(self) -> Tuple[int, int]:
        """(the ranks that draw their own stochastic-rounding seeds for a
        sharded group, this process's index among them)."""
        return self.env.world_size, self.env.rank

    def sr_seeds(self, step: int) -> Optional[Tuple[int, ...]]:
        """One int32 stochastic-rounding seed per group (the sharded
        collection's ``group_names`` order) for ``step``, from a generator
        seeded with the step: a seed per rank holding its own rows of each
        sharded group (``world_size`` of them; ``DMPCollection``
        FULLY_SHARDED: every rank), then one per data-parallel group, the
        same on every rank so that the replicas apply the same update.
        None for float32 tables and with stochastic rounding off."""
        if (self.table_dtype != torch.bfloat16
                or not self.fused_config.stochastic_rounding):
            return None
        ebc = self.sharded_ebc
        n = len(ebc.sharded_layouts)
        N, r = self._seed_ranks()
        gen = torch.Generator().manual_seed((SR_SEED_BASE << 32) + step)
        seeds = [int(s) for s in torch.randint(
            0, _INT32_MAX, (N * n + len(ebc.dp_groups),), generator=gen)]
        return tuple(seeds[r * n:(r + 1) * n] + seeds[N * n:])

    def _sparse_params_for_forward(
        self, tables: Mapping[str, torch.Tensor]
    ) -> Mapping[str, torch.Tensor]:
        """The stacks the lookup runs against: the state's own here
        (FULLY_SHARDED gathers its slices over the replicas)."""
        return tables

    def sparse_forward(
        self, state: State, batch: Batch
    ) -> Tuple[torch.Tensor, Dict[str, Tuple]]:
        """The sharded collection's forward: (pooled KT values [B, sum of
        dims], ctx per group)."""
        ebc = self.sharded_ebc
        outs, ctxs = ebc.forward_local(
            self._sparse_params_for_forward(state["tables"]),
            batch.sparse_features, self.lookup_kernel, self.env)
        return ebc.output_kt(outs).values(), ctxs

    def dense_forward_backward(
        self, state: State, batch: Batch, kt_values: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor],
               Dict[str, torch.Tensor]]:
        """Dense forward and backward on the pooled values: (loss and
        dense gradients averaged over every rank, this rank's logits [B],
        dense gradients by name, this rank's KT gradient divided by the
        model world size and split per feature)."""
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
        world = self.env.global_env
        if world.world_size > 1:
            # the pmeans of the JAX step over every mesh axis: one sum over
            # ranks of the loss and every dense gradient, in rank order,
            # then / ranks
            flat = torch.cat([loss.reshape(1).to(torch.float32)]
                             + [g.reshape(-1) for g in g_dense.values()])
            flat = all_reduce_sum(flat, world, tag="dense_grads:all_reduce"
                                  ) / world.world_size
            loss = flat[0]
            pieces = flat[1:].split([g.numel() for g in g_dense.values()])
            g_dense = {k: p.view_as(g) for (k, g), p in
                       zip(g_dense.items(), pieces)}
        # the global loss is the mean over ranks, so each rank's KT
        # gradient (whose contributions the sparse path sums over the
        # model group) is / the model group's size, as the JAX step does
        N = self.env.world_size
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

    def _sparse_update(self, state: State, ctxs: Mapping[str, Tuple],
                       grad_by_feature: Mapping[str, torch.Tensor]) -> None:
        """The fused backward + optimizer of every group, in place."""
        self.sharded_ebc.backward_and_update_local(
            state["tables"], state["fused"], ctxs, grad_by_feature,
            self.fused_config, sr_seeds=self.sr_seeds(state["step"]),
            update_kernel=self.update_kernel, env=self.env,
            learning_rate=self.sparse_lr(state["step"]),
        )

    def _dense_and_update(self, state: State, batch: Batch,
                          kt_values: torch.Tensor,
                          ctxs: Mapping[str, Tuple]) -> Tuple[State, Dict]:
        """The second half of the step, shared by :meth:`train_step` and
        the split step: dense forward and backward on (possibly stale)
        pooled values, the fused sparse update, the dense update."""
        loss, logits, g_dense, grad_by_feature = self.dense_forward_backward(
            state, batch, kt_values)
        self._sparse_update(state, ctxs, grad_by_feature)
        self.dense_tx.update(state["dense"], g_dense, state["dense_opt"])
        state["step"] += 1
        overflow = all_reduce_sum(batch.sparse_features.overflow_counts(),
                                  self.env.global_env,
                                  tag="id_overflow:all_reduce")
        metrics = {"loss": loss, "logits": logits,
                   "labels": batch.labels.reshape(-1),
                   "id_overflow": overflow}
        self._guardrail_metrics(metrics, ctxs)
        return state, metrics

    def _guardrail_metrics(self, metrics: Dict,
                           ctxs: Mapping[str, Tuple]) -> None:
        """The forward's guardrail counters, summed over every rank:
        ``id_violations`` ([F], when the sanitizer ran) and
        ``dedup_overflow`` (0-d, when the plan has a dedup'd group)."""
        world = self.env.global_env
        viol = ctxs.get("__sanitize__")
        if viol is not None:
            metrics["id_violations"] = all_reduce_sum(
                viol, world, tag="id_violations:all_reduce")
        ov = self.sharded_ebc.dedup_overflow(ctxs)
        if ov is not None:
            metrics["dedup_overflow"] = all_reduce_sum(
                ov.reshape(1), world, tag="dedup_overflow:all_reduce")[0]

    def train_step(self, state: State, batch: Batch) -> Tuple[State, Dict]:
        """One step on a batch already on the device; updates ``state`` in
        place and returns it with the metrics (loss, logits, labels,
        ``id_overflow`` and the guardrail counters of the module
        docstring, as device tensors)."""
        kt_values, ctxs = self.sparse_forward(state, batch)
        return self._dense_and_update(state, batch, kt_values, ctxs)

    def make_train_step(self) -> Callable[[State, Batch], Tuple[State, Dict]]:
        """The train step (JAX's ``make_train_step`` compiles one; the port
        runs eagerly and returns :meth:`train_step`)."""
        return self.train_step

    def embed_step(self, tables: Mapping[str, torch.Tensor],
                   batch: Batch) -> Tuple[torch.Tensor, Dict[str, Tuple]]:
        """The first half of the split (semi-sync) step: the sharded
        forward of ``batch`` against ``tables`` (the pooled KT values [B,
        sum of dims] and the ctx per group), with no autograd graph.  A
        collective at more than one rank."""
        with torch.no_grad():
            return self.sparse_forward({"tables": tables}, batch)

    def make_embed_step(self) -> Callable[..., Tuple[torch.Tensor,
                                                     Dict[str, Tuple]]]:
        """``(tables, batch) -> (kt_values, ctxs)``: :meth:`embed_step`
        (JAX's compiles one over the mesh, its outputs with a leading
        device axis; each rank here returns its own)."""
        return self.embed_step

    def dense_update_step(self, state: State, batch: Batch,
                          kt_values: torch.Tensor,
                          ctxs: Mapping[str, Tuple]) -> Tuple[State, Dict]:
        """The second half of the split step: dense forward and backward on
        the precomputed (possibly stale) ``kt_values``, the fused sparse
        update through ``ctxs`` and the dense update, in place; the
        metrics of :meth:`train_step`, ``id_overflow`` and the guardrail
        counters included."""
        return self._dense_and_update(state, batch, kt_values, ctxs)

    def make_dense_update_step(self) -> Callable[..., Tuple[State, Dict]]:
        """``(state, batch, kt_values, ctxs) -> (state, metrics)``:
        :meth:`dense_update_step`."""
        return self.dense_update_step

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


class DMPCollection(DistributedModelParallel):
    """2D parallelism (the JAX package's ``DMPCollection``): model
    sharding within each of ``env.num_replicas`` replicas, the dense
    model data-parallel over every rank.  ``env`` is a 2D
    ``comm.ShardingEnv`` (``ShardingEnv.from_process_group(backend,
    num_replicas=R)``); the other arguments are the DMP's.

    ``sharding_strategy``:

    * REPLICATED (the default): each replica trains its own copy of every
      group (a data-parallel group per replica too); :meth:`sync` averages
      every table and fused-state array over the replicas (a rank-order
      sum, then / R, so every replica ends with the same bits), and
      :meth:`maybe_sync` does so every ``sync_interval`` steps by a host
      counter.
    * FULLY_SHARDED: process ``(r, m)`` holds slice ``r`` of model rank
      ``m``'s sharded stacks and their states (``row_align`` defaults to
      R so they split evenly); the forward gathers the slices over the
      replicas; the update gathers every replica's slot stream of each
      sharded group over the replicas, divides the gradients by R and
      runs the DMP's ``update_kernel`` on the slots that fall in this
      slice.  A data-parallel group stays whole on every rank, its slots
      gathered over all ranks and divided by R.  :meth:`sync` and
      :meth:`maybe_sync` are the identity.  The bfloat16
      stochastic-rounding seeds of a sharded group differ per (model
      rank, replica); a data-parallel group's are the same everywhere."""

    def __init__(
        self,
        *args,
        env: ShardingEnv,
        sync_interval: int = 10,
        sharding_strategy: ShardingStrategy = ShardingStrategy.REPLICATED,
        **kwargs,
    ):
        self.sharding_strategy = ShardingStrategy(sharding_strategy)
        if self._is_fully_sharded:
            kwargs.setdefault("row_align", env.num_replicas)
        super().__init__(*args, env=env, **kwargs)
        if self._is_fully_sharded and self.row_align % env.num_replicas:
            raise ValueError(f"row_align {self.row_align} must be a multiple "
                             f"of the {env.num_replicas} replicas")
        self.sync_interval = sync_interval
        self._steps_since_sync = 0

    @property
    def _is_fully_sharded(self) -> bool:
        return self.sharding_strategy == ShardingStrategy.FULLY_SHARDED

    def _local_share(self, groups: Dict[str, Any]) -> Dict[str, Any]:
        """FULLY_SHARDED: slice ``replica_rank`` of each sharded group's
        stack and state arrays (0-d leaves and data-parallel groups
        whole)."""
        if not self._is_fully_sharded:
            return groups
        R, r = self.env.num_replicas, self.env.replica_rank
        dp = self.sharded_ebc.dp_groups

        def cut(name, x):
            if name in dp or not isinstance(x, torch.Tensor) or x.dim() == 0:
                return x
            return x.view((R, -1) + tuple(x.shape[1:]))[r].clone()

        return {name: ({k: cut(name, v) for k, v in g.items()}
                       if isinstance(g, dict) else cut(name, g))
                for name, g in groups.items()}

    def _model_rank_groups(self, groups, replica_mean=True):
        """REPLICATED: every table and fused array averaged over the
        replicas (a rank-order float32 sum / R, cast back: the JAX
        checkpoint's replica mean), or replica 0's copy; FULLY_SHARDED:
        each sharded group's slices gathered over the replicas.  A
        collective over the replica group."""
        R = self.env.num_replicas
        if R == 1:
            return dict(groups)
        dp = self.sharded_ebc.dp_groups
        renv = self.env.replica_env

        def one(name, x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0:
                return x
            if self._is_fully_sharded:
                return x if name in dp else self._gather_slices(name, x)
            if replica_mean:
                s = all_reduce_sum(x.to(torch.float32), renv,
                                   tag="replica_mean")
                return (s / R).to(x.dtype)
            return all_gather(x, renv)[0]

        return {n: ({k: one(n, v) for k, v in g.items()}
                    if isinstance(g, dict) else one(n, g))
                for n, g in groups.items()}

    def _tile_stack_rows(self, name, stack_rows, which):
        """FULLY_SHARDED: the rows in this process's slice of a sharded
        group, as rows of the slice."""
        if not self._is_fully_sharded or name in self.sharded_ebc.dp_groups:
            return stack_rows, which
        n = self.sharded_ebc.local_rows(name) // self.env.num_replicas
        lo = self.env.replica_rank * n
        keep = (stack_rows >= lo) & (stack_rows < lo + n)
        return stack_rows[keep] - lo, which[keep]

    def _row_owners_env(self):
        return self.env.global_env if self._is_fully_sharded else self.env

    def _gather_slices(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A sharded group's whole stack from every replica's slice (an
        all-gather over the replicas, in the ledger under
        ``{group}:fs_gather``)."""
        return _gather_counted(t, self.env.replica_env,
                               f"{name}:fs_gather").flatten(0, 1)

    def _full_stacks(self, tables):
        if not self._is_fully_sharded:
            if self.env.num_replicas == 1:
                return dict(tables)
            # replica 0's copy, as the JAX package reads it
            return {n: all_gather(t, self.env.replica_env)[0]
                    for n, t in tables.items()}
        return self._sparse_params_for_forward(tables)

    def _sparse_params_for_forward(self, tables):
        if not self._is_fully_sharded:
            return tables
        dp = self.sharded_ebc.dp_groups
        return {n: t if n in dp else self._gather_slices(n, t)
                for n, t in tables.items()}

    def _seed_ranks(self) -> Tuple[int, int]:
        if not self._is_fully_sharded:
            return super()._seed_ranks()
        return self.env.global_size, self.env.global_rank

    def _sparse_update(self, state, ctxs, grad_by_feature) -> None:
        """FULLY_SHARDED: each sharded group's slot stream gathered over
        the replicas, its gradients / R, applied to the slots in this
        rank's slice; each data-parallel group's slots gathered over every
        rank, / R, every row stepped."""
        if not self._is_fully_sharded:
            return super()._sparse_update(state, ctxs, grad_by_feature)
        env, ebc = self.env, self.sharded_ebc
        R = env.num_replicas
        sgs = ebc.backward_local(ctxs, grad_by_feature, env,
                                 dp_env=env.global_env, dp_divisor=R)
        seeds = dict(zip(ebc.group_names, self.sr_seeds(state["step"]) or ()))
        lr = self.sparse_lr(state["step"])
        for name, sg in sgs.items():
            table = state["tables"][name]
            if name not in ebc.dp_groups:
                sg = self._replica_slots(name, sg, table.shape[0])
            apply_sparse_update_segments(
                table, state["fused"][name], sg, self.fused_config,
                sr_seed=seeds.get(name), update_kernel=self.update_kernel,
                learning_rate=lr)

    def _replica_slots(self, name: str, sg: SparseSegGrad,
                       slice_rows: int) -> SparseSegGrad:
        """Every replica's slot stream of a sharded group (gathered over
        the replicas, replica-major, the segments of replica ``q`` offset
        by ``q * S``), the gradients divided by R, the ids cut to this
        rank's slice (slots outside it not valid)."""
        env = self.env.replica_env
        R = env.world_size

        def gather(x):
            return _gather_counted(x, env, f"{name}:fs_bwd_gather")

        S = sg.grad_seg.shape[0]
        ok = gather(sg.ok()).reshape(-1)
        ids = gather(sg.ids.to(torch.int64)).reshape(-1)
        w = (None if sg.weights is None
             else gather(sg.weights).reshape(-1))
        q = torch.arange(R, device=ids.device)[:, None]
        segs = (gather(sg.segments.to(torch.int64)) + q * S).reshape(-1)
        grads = gather(sg.grad_seg).view(R * S, -1) / R
        lo = env.rank * slice_rows
        valid = ok & (ids >= lo) & (ids < lo + slice_rows)
        local = torch.where(valid, ids - lo, slice_rows)
        return SparseSegGrad(local, valid, torch.where(valid, segs, R * S),
                             w, grads)

    def make_sync_step(self) -> Callable[[State], State]:
        """The replica sync: every table and fused-state array (not the
        0-d and integer leaves) averaged over the replica group, in place:
        a rank-order sum in float32 (``comm.all_reduce_sum``, under the
        ledger tag ``replica_sync``), / R, cast back to its dtype; every
        replica ends with the same bits."""
        env = self.env.replica_env
        R = env.world_size

        def mean(x: torch.Tensor) -> None:
            s = all_reduce_sum(x.to(torch.float32), env, tag="replica_sync")
            x.copy_((s / R).to(x.dtype))

        def sync(state: State) -> State:
            for name in self.sharded_ebc.group_names:
                mean(state["tables"][name])
                for v in state["fused"][name].values():
                    if isinstance(v, torch.Tensor) and v.dim():
                        mean(v)
            return state

        return sync

    def sync(self, state: State) -> State:
        """Average the replicas' copies (every ``sync_interval`` steps);
        the identity under FULLY_SHARDED, whose replicas are in step
        every step.  A collective over the replica group."""
        if self._is_fully_sharded or self.env.num_replicas == 1:
            return state
        return self.make_sync_step()(state)

    def maybe_sync(self, state: State) -> State:
        """:meth:`sync` on every ``sync_interval``-th call, counted on the
        host (no read of the device's step)."""
        if self._is_fully_sharded:
            return state
        self._steps_since_sync += 1
        if self._steps_since_sync >= self.sync_interval:
            self._steps_since_sync = 0
            return self.sync(state)
        return state
