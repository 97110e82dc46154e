"""Carry weights between the JAX package and the port.

The JAX package's dense params are a flax tree, for ``DLRM``::

    {"params": {"dense_arch": {"MLP_0": {"Perceptron_i": {"Dense_0":
        {"bias": [out], "kernel": [in, out]}}}},
     "over_arch": {"MLP_0": {...hidden layers...},
                   "Dense_0": {...the final logit layer...}}}}

for ``DLRM_DCN`` the same plus the cross net's
``inter_arch/crossnet/{w_l [d, r], v_l [r, d], b_l [d]}``, and for
``DLRM_Projection`` the two interaction MLPs
``inter_arch/interaction_branch{1,2}/Perceptron_i/Dense_0`` (the port's
``inter_arch.interaction_branch{1,2}.layers.i.linear``).  A whole model's
tree (``model.init(key, dense, kjt)``) also holds its collection's tables
as ``embedding_bag_collection/<table>`` ``[R, D]``, the port's
``sparse_arch.embedding_bag_collection.<table>``, carried as they are (no
transpose).  The bridge is
driven by the tree's own paths, one name at a time (:func:`port_key`,
:func:`flax_path`): ``MLP_0`` is the port's ``mlp``, ``Perceptron_i``
``layers.i``, a ``Dense_0`` inside a perceptron ``linear`` and any other
``Dense_0`` ``final``, and a ``kernel`` is the transposed
``nn.Linear.weight``; every other name (``dense_arch``, ``crossnet``,
``w_0``, ``bias``, ...) is the same in both, with its leaf as it is.  An
artifact's ``dense.npz`` stores the leaves in ``jax.tree.flatten`` order:
keys sorted as strings at every level (so ``Perceptron_10`` sorts before
``Perceptron_2``, and ``over_arch/Dense_0`` before ``over_arch/MLP_0``).

A whole train state of the JAX package's ``DistributedModelParallel``
crosses in both directions (:func:`train_state_from_jax`,
:func:`train_state_to_jax`): dense params, the ``sum_of_squares`` of its
``optax.adagrad`` state (the same tree), each group's table stack, its
fused-optimizer state (any of the eight layouts: ``momentum`` ``[R]`` or
``[R, D]``, ``m``, ``v`` and the Adam family's ``step``) and the step.
A sharded JAX state holds every rank's rows of a group in one global
stack (row ``d * rows + r`` is row ``r`` of rank ``d``): with ``rank``
and ``world_size`` the crossing keeps rank ``rank``'s rows of each
sharded group and its states (:func:`shard_rows`), and every row of a
replicated (data-parallel) group.  A JAX ``DMPCollection`` state of
``num_replicas`` R replicas crosses too: REPLICATED tiles every group
once per replica (a sharded group's global stack is replica-major,
``[R * M * rows, ...]``, a data-parallel group's ``[R * rows, ...]``),
FULLY_SHARDED splits each model rank's stack over the replicas,
model-major (chunk ``m * R + r`` of ``M * R`` on rank ``(r, m)``), and
keeps data-parallel groups whole.  :func:`train_states_to_jax` puts every
rank's state back into the global layout.  Full tables cross through the
sharded collection's ``params_from_tables(weights, rank=...)``.
Everything here is numpy and torch; nothing imports JAX.
"""

from __future__ import annotations

import re
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

Path = Tuple[str, ...]
_PERCEPTRON = re.compile(r"Perceptron_(\d+)$")
# the port's module and parameter names with another flax name
_FLAX_NAMES = {"mlp": "MLP_0", "linear": "Dense_0", "final": "Dense_0",
               "weight": "kernel"}
# a whole model's tables: the flax scope and the port's key prefix
_TABLES = "embedding_bag_collection"
_PORT_TABLES = "sparse_arch.embedding_bag_collection."


def port_key(path: Path) -> str:
    """flax leaf path (under ``params``) -> the port's state-dict key."""
    if path[0] == _TABLES:
        return _PORT_TABLES + ".".join(path[1:])
    out: List[str] = []
    for i, name in enumerate(path):
        m = _PERCEPTRON.match(name)
        if name == "MLP_0":
            out.append("mlp")
        elif m:
            out += ["layers", m.group(1)]
        elif name == "Dense_0":
            inner = i > 0 and _PERCEPTRON.match(path[i - 1])
            out.append("linear" if inner else "final")
        elif name == "kernel":
            out.append("weight")
        else:
            out.append(name)
    return ".".join(out)


def flax_path(key: str) -> Path:
    """The port's state-dict key -> flax leaf path (inverse of
    :func:`port_key`)."""
    if _is_table_key(key):
        return (_TABLES, key[len(_PORT_TABLES):])
    names = key.split(".")
    out: List[str] = []
    i = 0
    while i < len(names):
        name = names[i]
        if name == "layers":
            out.append(f"Perceptron_{names[i + 1]}")
            i += 1
        else:
            out.append(_FLAX_NAMES.get(name, name))
        i += 1
    return tuple(out)


def _leaves(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _is_table_key(key: str) -> bool:
    """Whether a port state-dict key names a collection's table."""
    return key.startswith(_PORT_TABLES)


def _transposed(key: str) -> bool:
    return key.endswith(".weight") and not _is_table_key(key)


def _to_port(key: str, leaf: np.ndarray) -> torch.Tensor:
    arr = np.asarray(leaf, np.float32)
    if _transposed(key):
        arr = arr.T  # flax kernel [in, out] -> nn.Linear.weight [out, in]
    return torch.from_numpy(np.array(arr, order="C"))  # a contiguous copy


def _to_flax(key: str, t: torch.Tensor) -> np.ndarray:
    arr = t.detach().to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(arr.T if _transposed(key) else arr)


def dlrm_state_dict_from_flax(
    params: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """JAX params of a DLRM, DLRM_DCN or DLRM_Projection (a nested dict of
    numpy arrays, with or without the top ``"params"`` level; the dense
    side alone or the whole model with its tables) -> the port model's
    ``state_dict`` (float32)."""
    inner = params["params"] if "params" in params else params
    return {port_key(p): _to_port(port_key(p), leaf)
            for p, leaf in _leaves(inner).items()}


def flax_params_from_dlrm_state_dict(
    state_dict: Mapping[str, torch.Tensor],
) -> Dict[str, Any]:
    """The port model's parameters -> the flax params tree ``{"params":
    {...}}`` of float32 numpy arrays (inverse of
    :func:`dlrm_state_dict_from_flax`)."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *parents, leaf = ("params",) + flax_path(key)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_flax(key, t)
    return tree


def _flatten_order(keys: Iterable[str]) -> List[str]:
    """Port keys in the ``jax.tree.flatten`` order of their flax paths."""
    return sorted(keys, key=flax_path)


def dense_leaves_to_flax_order(
    state_dict: Mapping[str, torch.Tensor],
) -> List[np.ndarray]:
    """The port model's state dict -> float32 numpy leaves in the
    ``jax.tree.flatten`` order of the flax params (``dense.npz``)."""
    return [_to_flax(k, state_dict[k]) for k in _flatten_order(state_dict)]


def dense_leaves_from_flax_order(
    leaves: Sequence[np.ndarray],
    keys: Iterable[str],
) -> Dict[str, torch.Tensor]:
    """``dense.npz`` leaves (flatten order) -> the ``state_dict`` of a
    port model whose state-dict keys are ``keys``."""
    order = _flatten_order(keys)
    if len(leaves) != len(order):
        raise ValueError(f"{len(leaves)} dense leaves for a model with "
                         f"{len(order)}")
    return {k: _to_port(k, leaf) for k, leaf in zip(order, leaves)}


def quant_params_from_numpy(
    params: Mapping[str, Mapping[str, np.ndarray]],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-table ``{"q", "scale", "bias"}`` numpy arrays (the JAX
    ``QuantEmbeddingBagCollection.params`` after ``np.asarray``) -> CPU
    tensors for the port's ``QuantEmbeddingBagCollection``."""
    return {
        name: {
            k: torch.from_numpy(np.array(v, order="C"))
            for k, v in p.items()
        }
        for name, p in params.items()
    }


def _sum_of_squares(dense_opt: Any) -> Any:
    """The ``sum_of_squares`` tree of an ``optax.adagrad`` state: the
    chain's tuple ``(ScaleByRssState(sum_of_squares=...), EmptyState())``
    or a mapping with that key."""
    if isinstance(dense_opt, Mapping):
        return dense_opt["sum_of_squares"]
    for part in dense_opt:
        if hasattr(part, "sum_of_squares"):
            return part.sum_of_squares
    raise ValueError("no sum_of_squares in the dense optimizer state")


def _to_tensor(arr: Any, dtype: torch.dtype, device) -> torch.Tensor:
    # bfloat16 numpy arrays (ml_dtypes) widen to float32 exactly first
    t = torch.from_numpy(np.array(np.asarray(arr, np.float32), order="C"))
    return t.to(device=device, dtype=dtype)


def _fused_from_jax(st: Mapping[str, Any], device) -> Dict[str, Any]:
    """One group's fused-optimizer state: every array (``momentum``
    ``[R]`` or ``[R, D]``, ``m``, ``v``) as float32, the Adam family's
    ``step`` as an int."""
    return {k: int(np.asarray(v)) if k == "step"
            else _to_tensor(v, torch.float32, device)
            for k, v in st.items()}


def _fused_to_jax(st: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`_fused_from_jax`: float32 numpy arrays, ``step``
    an int32 scalar."""
    return {k: np.int32(v) if k == "step"
            else v.detach().to(torch.float32).cpu().numpy()
            for k, v in st.items()}


def shard_rows(arr: Any, rank: int, world_size: int) -> np.ndarray:
    """Rank ``rank``'s rows of a global ``[N * rows, ...]`` stack or
    state (the JAX package's row-sharded layout)."""
    arr = np.asarray(arr)
    if arr.shape[0] % world_size:
        raise ValueError(f"{arr.shape[0]} rows do not split over "
                         f"{world_size} ranks")
    n = arr.shape[0] // world_size
    return arr[rank * n:(rank + 1) * n]


def _chunk(rank: int, world_size: int, replica: int, num_replicas: int,
           fully_sharded: bool) -> int:
    """The index of rank ``(replica, rank)``'s rows among the ``R * M``
    chunks of a sharded group's global stack."""
    if fully_sharded:
        return rank * num_replicas + replica
    return replica * world_size + rank


def train_state_from_jax(
    state: Mapping[str, Any],
    device=None,
    table_dtype: Optional[torch.dtype] = None,
    rank: int = 0,
    world_size: int = 1,
    replicated: Sequence[str] = (),
    replica: int = 0,
    num_replicas: int = 1,
    fully_sharded: bool = False,
) -> Dict[str, Any]:
    """A JAX ``DistributedModelParallel`` (or ``DMPCollection``) train
    state with numpy leaves (``jax.tree.map(np.asarray, state)``) -> the
    share of model rank ``rank`` of replica ``replica`` of the port's
    train state on ``device``: each sharded group's rows of that rank
    (module docstring for the 2D layouts), and every row of the
    ``replicated`` (data-parallel) groups, of this replica's copy under
    REPLICATED.  Table stacks keep their dtype (float32, or bfloat16
    where the JAX stack is bfloat16) unless ``table_dtype`` is given."""
    chunk = _chunk(rank, world_size, replica, num_replicas, fully_sharded)

    def mine(group, arr):
        if np.ndim(arr) == 0:
            return arr
        if group in replicated:
            return arr if fully_sharded else shard_rows(arr, replica,
                                                        num_replicas)
        return shard_rows(arr, chunk, world_size * num_replicas)

    def table(arr):
        dt = table_dtype
        if dt is None:
            bf16 = np.asarray(arr).dtype.name == "bfloat16"
            dt = torch.bfloat16 if bf16 else torch.float32
        return _to_tensor(arr, dt, device)

    return {
        "dense": {k: v.to(device) for k, v in
                  dlrm_state_dict_from_flax(state["dense"]).items()},
        "dense_opt": {k: v.to(device) for k, v in dlrm_state_dict_from_flax(
            _sum_of_squares(state["dense_opt"])).items()},
        "tables": {g: table(mine(g, t)) for g, t in state["tables"].items()},
        "fused": {g: _fused_from_jax({k: mine(g, v) for k, v in st.items()},
                                     device)
                  for g, st in state["fused"].items()},
        "step": int(np.asarray(state["step"])),
    }


def train_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's train state -> numpy leaves in the JAX layout: ``dense``
    is the flax params tree, ``dense_opt`` is ``{"sum_of_squares": tree}``
    (wrap it as ``(optax.ScaleByRssState(**dense_opt),
    optax.EmptyState())`` for ``optax.adagrad``), table stacks and every
    fused-optimizer array are float32 (bfloat16 stacks widen exactly;
    cast back on the JAX side), the steps are int32 scalars."""
    return {
        "dense": flax_params_from_dlrm_state_dict(state["dense"]),
        "dense_opt": {"sum_of_squares": flax_params_from_dlrm_state_dict(
            state["dense_opt"])},
        "tables": {g: t.detach().to(torch.float32).cpu().numpy()
                   for g, t in state["tables"].items()},
        "fused": {g: _fused_to_jax(st) for g, st in state["fused"].items()},
        "step": np.int32(state["step"]),
    }


def train_states_to_jax(
    states: Sequence[Mapping[str, Any]],
    world_size: int = 1,
    num_replicas: int = 1,
    fully_sharded: bool = False,
    replicated: Sequence[str] = (),
) -> Dict[str, Any]:
    """Every rank's train state (global rank ``r * world_size + m`` at
    index ``r * world_size + m``) -> the JAX package's global train state
    (numpy leaves, :func:`train_state_to_jax`'s dtypes): each sharded
    group's rows put back in the global stack's chunk order (module
    docstring), a data-parallel group's copies tiled per replica under
    REPLICATED (rank 0's under FULLY_SHARDED); the dense parts and steps
    are rank 0's."""
    M, R = world_size, num_replicas
    if len(states) != M * R:
        raise ValueError(f"{len(states)} states for {R} x {M} ranks")
    parts = [train_state_to_jax(st) for st in states]
    order = [0] * (M * R)  # chunk index -> global rank
    for r in range(R):
        for m in range(M):
            order[_chunk(m, M, r, R, fully_sharded)] = r * M + m
    dp_ranks = [0] if fully_sharded else [r * M for r in range(R)]

    def merge(group, pick):
        ranks = dp_ranks if group in replicated else order
        first = pick(parts[0])
        if np.ndim(first) == 0:
            return first
        return np.concatenate([pick(parts[g]) for g in ranks])

    out = dict(parts[0])
    out["tables"] = {g: merge(g, lambda p, g=g: p["tables"][g])
                     for g in parts[0]["tables"]}
    out["fused"] = {g: {k: merge(g, lambda p, g=g, k=k: p["fused"][g][k])
                        for k in st}
                    for g, st in parts[0]["fused"].items()}
    return out
