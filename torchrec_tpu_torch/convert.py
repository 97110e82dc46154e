"""Carry weights between the JAX package and the port.

The bridge is driven by the flax tree's own paths, one name at a time,
for every model of the JAX package the port has.  The DLRM family's
trees are shown below.  The transformer models' trees (BERT4Rec's
``forward_from_embeddings`` init, ``DLRM_Transformer``'s
``inter_arch``) hold ``blocks_i`` (the port's ``blocks.i``), each with
``MultiHeadDotProductAttention_0`` (``attention``: ``query``, ``key``,
``value`` ``DenseGeneral`` kernels ``[D, H, Dh]`` flattened to the
``nn.Linear`` weight ``[H * Dh, D]``, bias ``[H, Dh]`` to ``[H * Dh]``,
``out`` ``[H, Dh, D]`` to ``[D, H * Dh]``), ``LayerNorm_i`` (``norm_i``,
``scale`` the port's ``weight``) and ``Dense_i`` (``dense_i``);
BERT4Rec's ``position_emb/embedding`` is ``position_emb.weight``.  The
way back needs the attention's ``num_heads``.  DeepFM's ``DeepFM_0`` is
``deep_fm``; the cross nets' and the towers' names are the same in both.
A sequence train state (``SequenceModelParallel``, its dense optimizer
``optax.adam``) crosses with :func:`sequence_train_state_from_jax` and
:func:`sequence_train_state_to_jax`.

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
A checkpoint crosses too: :func:`checkpoint_payload_from_jax` turns the
numpy payload the JAX ``Checkpointer._read_payload`` returns into the
port's payload (``checkpoint.py``; the dense params by the port's names,
the ``optax.adagrad`` leaves in their order), which
``Checkpointer.save_payload`` writes and ``restore`` reads as any port
checkpoint; :func:`checkpoint_payload_to_jax` goes back.
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
_BLOCK = re.compile(r"blocks_(\d+)$")
_NORM = re.compile(r"LayerNorm_(\d+)$")
_DENSE = re.compile(r"Dense_(\d+)$")
_PORT_NORM = re.compile(r"norm_\d+$")
# flax modules the port names otherwise, by their own name alone
_PORT_MODULES = {"MLP_0": "mlp", "MultiHeadDotProductAttention_0": "attention",
                 "DeepFM_0": "deep_fm"}
_FLAX_MODULES = {v: k for k, v in _PORT_MODULES.items()}
# a whole model's tables: the flax scope and the port's key prefix
_TABLES = "embedding_bag_collection"
_PORT_TABLES = "sparse_arch.embedding_bag_collection."


def port_key(path: Path, tables_prefix: str = _PORT_TABLES) -> str:
    """flax leaf path (under ``params``) -> the port's state-dict key."""
    if path[0] == _TABLES:
        return tables_prefix + ".".join(path[1:])
    out: List[str] = []
    for i, name in enumerate(path):
        parent = path[i - 1] if i else ""
        m = _PERCEPTRON.match(name) or _BLOCK.match(name)
        if name in _PORT_MODULES:
            out.append(_PORT_MODULES[name])
        elif m:
            out += ["layers" if name.startswith("P") else "blocks",
                    m.group(1)]
        elif _NORM.match(name):
            out.append(f"norm_{_NORM.match(name).group(1)}")
        elif _DENSE.match(name):
            if _PERCEPTRON.match(parent):
                out.append("linear")
            elif _BLOCK.match(parent) or not parent:  # a block's, or a
                # block's own tree
                out.append(f"dense_{_DENSE.match(name).group(1)}")
            else:
                out.append("final")
        elif name in ("kernel", "scale", "embedding"):
            out.append("weight")
        else:
            out.append(name)
    return ".".join(out)


def flax_path(key: str, tables_prefix: str = _PORT_TABLES) -> Path:
    """The port's state-dict key -> flax leaf path (inverse of
    :func:`port_key`)."""
    if key.startswith(tables_prefix):
        return (_TABLES, key[len(tables_prefix):])
    names = key.split(".")
    out: List[str] = []
    i = 0
    while i < len(names):
        name = names[i]
        parent = names[i - 1] if i else ""
        if name in ("layers", "blocks"):
            out.append(f"Perceptron_{names[i + 1]}" if name == "layers"
                       else f"blocks_{names[i + 1]}")
            i += 1
        elif name in _FLAX_MODULES:
            out.append(_FLAX_MODULES[name])
        elif _PORT_NORM.match(name):
            out.append(f"LayerNorm_{name.split('_')[1]}")
        elif name.startswith("dense_") and name[6:].isdigit():
            out.append(f"Dense_{name[6:]}")
        elif name in ("linear", "final"):
            out.append("Dense_0")
        elif name == "weight":
            out.append("scale" if _PORT_NORM.match(parent) else
                       "embedding" if parent == "position_emb" else "kernel")
        else:
            out.append(name)
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


def _to_port(path: Path, leaf: np.ndarray) -> torch.Tensor:
    """A flax leaf in the port's layout: a ``kernel`` transposed to the
    ``nn.Linear.weight`` ``[out, in]`` (a ``DenseGeneral`` kernel first
    flattened: ``[D, H, Dh]`` to ``[D, H * Dh]``, the attention's output
    ``[H, Dh, D]`` to ``[H * Dh, D]``), a ``[H, Dh]`` bias flattened."""
    arr = np.asarray(leaf, np.float32)
    if path[-1] == "kernel":
        if arr.ndim == 3:
            arr = (arr.reshape(-1, arr.shape[-1]) if path[-2] == "out"
                   else arr.reshape(arr.shape[0], -1))
        arr = arr.T
    elif path[-1] == "bias" and arr.ndim == 2:
        arr = arr.reshape(-1)
    return torch.from_numpy(np.array(arr, order="C"))  # a contiguous copy


def _to_flax(path: Path, t: torch.Tensor,
             num_heads: Optional[int] = None) -> np.ndarray:
    """Inverse of :func:`_to_port`; the attention's leaves need
    ``num_heads``."""
    arr = t.detach().to(torch.float32).cpu().numpy()
    attention = len(path) > 2 and path[-3] == _FLAX_MODULES["attention"]
    if attention and num_heads is None:
        raise ValueError(f"{'/'.join(path)}: pass num_heads")
    if path[-1] == "kernel":
        arr = arr.T
        if attention:
            arr = (arr.reshape(num_heads, -1, arr.shape[-1])
                   if path[-2] == "out"
                   else arr.reshape(arr.shape[0], num_heads, -1))
    elif path[-1] == "bias" and attention and path[-2] != "out":
        arr = arr.reshape(num_heads, -1)
    return np.ascontiguousarray(arr)


def state_dict_from_flax(
    params: Mapping[str, Any], tables_prefix: str = _PORT_TABLES,
) -> Dict[str, torch.Tensor]:
    """JAX params of any model of the JAX package the port has (a nested
    dict of numpy arrays, with or without the top ``"params"`` level; the
    dense side alone or the whole model with its tables) -> the port
    model's ``state_dict`` (float32).  ``tables_prefix``: the port's key
    prefix of an ``embedding_bag_collection`` scope."""
    inner = params["params"] if "params" in params else params
    return {port_key(p, tables_prefix): _to_port(p, leaf)
            for p, leaf in _leaves(inner).items()}


def flax_params_from_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    num_heads: Optional[int] = None,
    tables_prefix: str = _PORT_TABLES,
) -> Dict[str, Any]:
    """The port model's parameters -> the flax params tree ``{"params":
    {...}}`` of float32 numpy arrays (inverse of
    :func:`state_dict_from_flax`; ``num_heads`` of the attention, where
    the model has one)."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        path = flax_path(key, tables_prefix)
        *parents, leaf = ("params",) + path
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_flax(path, t, num_heads)
    return tree


def dlrm_state_dict_from_flax(
    params: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """JAX params of a DLRM, DLRM_DCN or DLRM_Projection -> the port
    model's ``state_dict`` (:func:`state_dict_from_flax`)."""
    return state_dict_from_flax(params)


def flax_params_from_dlrm_state_dict(
    state_dict: Mapping[str, torch.Tensor],
) -> Dict[str, Any]:
    """Inverse of :func:`dlrm_state_dict_from_flax`."""
    return flax_params_from_state_dict(state_dict)


def _flatten_order(keys: Iterable[str]) -> List[str]:
    """Port keys in the ``jax.tree.flatten`` order of their flax paths."""
    return sorted(keys, key=flax_path)


def dense_leaves_to_flax_order(
    state_dict: Mapping[str, torch.Tensor],
) -> List[np.ndarray]:
    """The port model's state dict -> float32 numpy leaves in the
    ``jax.tree.flatten`` order of the flax params (``dense.npz``)."""
    return [_to_flax(flax_path(k), state_dict[k])
            for k in _flatten_order(state_dict)]


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
    return {k: _to_port(flax_path(k), leaf) for k, leaf in zip(order, leaves)}


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


def _sharded_parts_from_jax(
    state: Mapping[str, Any], device, table_dtype: Optional[torch.dtype],
    rank: int, world_size: int, replicated: Sequence[str], replica: int,
    num_replicas: int, fully_sharded: bool,
) -> Dict[str, Any]:
    """The tables, fused states and step of a JAX train state, rank
    ``rank``'s share (:func:`train_state_from_jax`)."""
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
        "tables": {g: table(mine(g, t)) for g, t in state["tables"].items()},
        "fused": {g: _fused_from_jax({k: mine(g, v) for k, v in st.items()},
                                     device)
                  for g, st in state["fused"].items()},
        "step": int(np.asarray(state["step"])),
    }


def _dense_from_jax(tree: Mapping[str, Any], device) -> Dict[str, Any]:
    return {k: v.to(device) for k, v in state_dict_from_flax(tree).items()}


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
    return {
        "dense": _dense_from_jax(state["dense"], device),
        "dense_opt": _dense_from_jax(_sum_of_squares(state["dense_opt"]),
                                     device),
        **_sharded_parts_from_jax(state, device, table_dtype, rank,
                                  world_size, replicated, replica,
                                  num_replicas, fully_sharded),
    }


def train_state_to_jax(state: Mapping[str, Any],
                       num_heads: Optional[int] = None) -> Dict[str, Any]:
    """The port's train state -> numpy leaves in the JAX layout: ``dense``
    is the flax params tree, ``dense_opt`` is ``{"sum_of_squares": tree}``
    (wrap it as ``(optax.ScaleByRssState(**dense_opt),
    optax.EmptyState())`` for ``optax.adagrad``), table stacks and every
    fused-optimizer array are float32 (bfloat16 stacks widen exactly;
    cast back on the JAX side), the steps are int32 scalars.
    ``num_heads``: the attention's, for a model with one
    (``DLRM_Transformer``)."""
    return {
        "dense": flax_params_from_state_dict(state["dense"], num_heads),
        "dense_opt": {"sum_of_squares": flax_params_from_state_dict(
            state["dense_opt"], num_heads)},
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


def _adam_state(dense_opt: Any) -> Tuple[Any, Any, Any]:
    """(count, mu, nu) of an ``optax.adam`` state: the chain's tuple
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` or a mapping with
    those keys."""
    if isinstance(dense_opt, Mapping):
        return dense_opt["count"], dense_opt["mu"], dense_opt["nu"]
    for part in dense_opt:
        if hasattr(part, "mu"):
            return part.count, part.mu, part.nu
    raise ValueError("no Adam moments in the dense optimizer state")


def sequence_train_state_from_jax(
    state: Mapping[str, Any],
    device=None,
    rank: int = 0,
    world_size: int = 1,
    replicated: Sequence[str] = (),
) -> Dict[str, Any]:
    """A JAX ``SequenceModelParallel`` train state with numpy leaves
    (``jax.tree.map(np.asarray, state)``; its dense optimizer
    ``optax.adam``) -> rank ``rank``'s share of the port's train state on
    ``device``: the dense params (the model's flax tree, e.g. BERT4Rec's
    ``forward_from_embeddings`` init), Adam's ``mu``, ``nu`` and
    ``count``, each sharded group's rows of that rank, every row of the
    ``replicated`` (data-parallel) groups, and the fused state."""
    count, mu, nu = _adam_state(state["dense_opt"])
    return {
        "dense": _dense_from_jax(state["dense"], device),
        "dense_opt": {"mu": _dense_from_jax(mu, device),
                      "nu": _dense_from_jax(nu, device),
                      "count": int(np.asarray(count))},
        **_sharded_parts_from_jax(state, device, torch.float32, rank,
                                  world_size, replicated, 0, 1, False),
    }


def sequence_train_state_to_jax(state: Mapping[str, Any],
                                num_heads: int) -> Dict[str, Any]:
    """The port's sequence train state -> numpy leaves in the JAX layout:
    ``dense`` the flax params tree, ``dense_opt`` ``{"count", "mu",
    "nu"}`` (wrap as ``(optax.ScaleByAdamState(**dense_opt),
    optax.EmptyState())``), the tables and fused state as
    :func:`train_state_to_jax` gives them."""
    opt = state["dense_opt"]
    out = train_state_to_jax({**state, "dense": {}, "dense_opt": {}})
    out["dense"] = flax_params_from_state_dict(state["dense"], num_heads)
    out["dense_opt"] = {
        "count": np.int32(opt["count"]),
        "mu": flax_params_from_state_dict(opt["mu"], num_heads),
        "nu": flax_params_from_state_dict(opt["nu"], num_heads)}
    return out


# ---------------------------------------------------------------------------
# checkpoints (``checkpoint.py``'s payload)
# ---------------------------------------------------------------------------


def _host_tensor(arr: Any) -> torch.Tensor:
    """A numpy leaf as a host tensor of its own dtype (bfloat16 numpy
    arrays widen to float32 exactly, then narrow back)."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return _to_tensor(a, torch.bfloat16, "cpu")
    return torch.from_numpy(np.array(a, order="C"))


def _host_numpy(t: Any) -> np.ndarray:
    """A host tensor as float32 numpy (bfloat16 widens exactly; cast back
    on the JAX side), other dtypes kept."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return np.array(t.numpy())


def _adagrad_leaves(n_dense: int, n_leaves: int) -> None:
    if n_dense != n_leaves:
        raise NotImplementedError(
            f"{n_leaves} dense optimizer leaves for {n_dense} dense "
            "parameters: only an optax.adagrad state (one sum_of_squares "
            "a parameter, the port's Adagrad) crosses")


def checkpoint_payload_from_jax(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX checkpoint's payload (the numpy dict that
    ``torchrec_tpu.checkpoint.Checkpointer._read_payload`` returns) ->
    the port's payload (``checkpoint.py``): per-table weights and the
    fused states and per-table slots in their own dtypes, the dense
    params by the port's names (:func:`state_dict_from_flax`), the
    ``optax.adagrad`` ``sum_of_squares`` leaves in the same order
    (:func:`dense_leaves_from_flax_order`), the step counters as ints.
    Write it with ``Checkpointer.save_payload`` and restore it as any
    port checkpoint."""
    dense = state_dict_from_flax(payload["dense"])
    flat = payload["dense_opt_leaves"]
    _adagrad_leaves(len(dense), len(flat))
    sos = dense_leaves_from_flax_order([flat[k] for k in sorted(flat)],
                                       dense)
    fused_tables = {
        t: ({k: int(np.asarray(v)) for k, v in slots.items()}
            if t == "__scalars__"
            else {k: _host_tensor(v) for k, v in slots.items()})
        for t, slots in payload.get("fused_tables", {}).items()}
    out = {
        "tables": {k: _host_tensor(v) for k, v in payload["tables"].items()},
        "dense": dense,
        "dense_opt_leaves": {f"{i:05d}": sos[k]
                             for i, k in enumerate(dense)},
        "fused": {g: {k: int(np.asarray(v)) if k == "step"
                      else _host_tensor(v) for k, v in st.items()}
                  for g, st in payload["fused"].items()},
        "step": int(np.asarray(payload["step"])),
    }
    if fused_tables:
        out["fused_tables"] = fused_tables
    if "tiered" in payload:
        out["tiered"] = _tiered_entries(payload["tiered"], _host_tensor)
    if "vocab" in payload:
        # each vocabulary's pinned snapshot generation: the snapshot and
        # journal files are the same in both packages
        out["vocab"] = {t: {"generation": int(np.asarray(st["generation"]))}
                        for t, st in payload["vocab"].items()}
    return out


def _tiered_entries(tiered: Mapping[str, Any], rows) -> Dict[str, Any]:
    """A checkpoint's ``tiered`` entry with each table's host rows
    through ``rows`` and its pinned disk generation as an int: the packed
    row layout (weights, then the slots in name order) is the same in
    both packages."""
    return {t: ({"generation": int(np.asarray(st["generation"]))}
                if "generation" in st else
                {"host_rows": rows(st["host_rows"])})
            for t, st in tiered.items()}


def checkpoint_payload_to_jax(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`checkpoint_payload_from_jax`: the JAX payload's
    keys and layouts (float32 arrays, bfloat16 widened; ``step`` int32;
    the ``__scalars__`` counters float64, as the JAX package stores
    them), ready for the JAX ``Checkpointer``'s writer."""
    dense = dict(payload["dense"])
    flat = payload["dense_opt_leaves"]
    _adagrad_leaves(len(dense), len(flat))
    sos = dict(zip(dense, (flat[k] for k in sorted(flat))))
    return {
        "tables": {k: _host_numpy(v) for k, v in payload["tables"].items()},
        "dense": flax_params_from_state_dict(dense),
        "dense_opt_leaves": {
            f"{i:05d}": leaf
            for i, leaf in enumerate(dense_leaves_to_flax_order(sos))},
        "fused": {g: {k: np.int32(v) if k == "step" else _host_numpy(v)
                      for k, v in st.items()}
                  for g, st in payload["fused"].items()},
        "fused_tables": {
            t: ({k: np.array(float(v)) for k, v in slots.items()}
                if t == "__scalars__"
                else {k: _host_numpy(v) for k, v in slots.items()})
            for t, slots in payload["fused_tables"].items()},
        "step": np.array(np.int32(payload["step"])),
        **({"tiered": {
            t: ({"generation": np.asarray(int(st["generation"]), np.int64)}
                if "generation" in st else
                {"host_rows": _host_numpy(st["host_rows"])})
            for t, st in payload["tiered"].items()}}
           if "tiered" in payload else {}),
        **({"vocab": {
            t: {"generation": np.int64(int(st["generation"]))}
            for t, st in payload["vocab"].items()}}
           if "vocab" in payload else {}),
    }
