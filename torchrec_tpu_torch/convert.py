"""Carry weights between the JAX package and the port.

The JAX package's DLRM dense params are a flax tree::

    {"params": {"dense_arch": {"MLP_0": {"Perceptron_i": {"Dense_0":
        {"bias": [out], "kernel": [in, out]}}}},
     "over_arch": {"MLP_0": {...hidden layers...},
                   "Dense_0": {...the final logit layer...}}}}

and an artifact's ``dense.npz`` stores its leaves in ``jax.tree.flatten``
order: keys sorted as strings at every level (so ``Perceptron_10`` sorts
before ``Perceptron_2``, and ``over_arch/Dense_0`` before
``over_arch/MLP_0``), ``bias`` before ``kernel``.  The port's ``DLRM``
names the same weights ``dense_arch.mlp.layers.i.linear``,
``over_arch.mlp.layers.i.linear`` and ``over_arch.final``, with
``nn.Linear.weight`` the transposed flax ``kernel``.

A whole train state of the JAX package's ``DistributedModelParallel``
crosses in both directions (:func:`train_state_from_jax`,
:func:`train_state_to_jax`): dense params, the ``sum_of_squares`` of its
``optax.adagrad`` state, each group's table stack, its fused-optimizer
state (any of the eight layouts: ``momentum`` ``[R]`` or ``[R, D]``,
``m``, ``v`` and the Adam family's ``step``) and the step.  Everything
here is numpy and torch; nothing imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _flax_layer_paths(
    num_dense_layers: int, num_over_layers: int
) -> Dict[Path, str]:
    """flax layer path (under ``params``) -> the port's module name."""
    out: Dict[Path, str] = {}
    for i in range(num_dense_layers):
        out[("dense_arch", "MLP_0", f"Perceptron_{i}", "Dense_0")] = (
            f"dense_arch.mlp.layers.{i}.linear"
        )
    for i in range(num_over_layers - 1):
        out[("over_arch", "MLP_0", f"Perceptron_{i}", "Dense_0")] = (
            f"over_arch.mlp.layers.{i}.linear"
        )
    out[("over_arch", "Dense_0")] = "over_arch.final"
    return out


def _leaf_paths(
    num_dense_layers: int, num_over_layers: int
) -> List[Tuple[Path, str]]:
    """(flax leaf path, port state-dict key) in ``jax.tree.flatten``
    order of ``{"params": ...}``."""
    pairs = []
    for layer, name in _flax_layer_paths(
        num_dense_layers, num_over_layers
    ).items():
        pairs.append((("params", *layer, "bias"), f"{name}.bias"))
        pairs.append((("params", *layer, "kernel"), f"{name}.weight"))
    return sorted(pairs)


def _layer_counts(state_dict: Mapping[str, Any]) -> Tuple[int, int]:
    n_dense = sum(
        1 for k in state_dict
        if k.startswith("dense_arch.mlp.layers.") and k.endswith(".weight")
    )
    n_over_hidden = sum(
        1 for k in state_dict
        if k.startswith("over_arch.mlp.layers.") and k.endswith(".weight")
    )
    return n_dense, n_over_hidden + 1


def _to_port(key: str, leaf: np.ndarray) -> torch.Tensor:
    arr = np.asarray(leaf, np.float32)
    if key.endswith(".weight"):
        arr = arr.T  # flax kernel [in, out] -> nn.Linear.weight [out, in]
    return torch.from_numpy(np.array(arr, order="C"))  # a contiguous copy


def dlrm_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DLRM dense params (a nested dict of numpy arrays, with or
    without the top ``"params"`` level) -> the port's ``DLRM``
    ``state_dict``."""
    inner = params["params"] if "params" in params else params
    n_dense = len(inner["dense_arch"]["MLP_0"])
    n_over = len(inner["over_arch"].get("MLP_0", {})) + 1
    out: Dict[str, torch.Tensor] = {}
    for path, key in _leaf_paths(n_dense, n_over):
        node: Any = inner
        for p in path[1:]:
            node = node[p]
        out[key] = _to_port(key, node)
    return out


def dense_leaves_to_flax_order(
    state_dict: Mapping[str, torch.Tensor],
) -> List[np.ndarray]:
    """The port's ``DLRM`` state dict -> float32 numpy leaves in the
    ``jax.tree.flatten`` order of the flax params (``dense.npz``)."""
    n_dense, n_over = _layer_counts(state_dict)
    leaves = []
    for _, key in _leaf_paths(n_dense, n_over):
        arr = state_dict[key].detach().cpu().numpy().astype(np.float32)
        leaves.append(np.ascontiguousarray(arr.T if key.endswith(".weight")
                                           else arr))
    return leaves


def dense_leaves_from_flax_order(
    leaves: Sequence[np.ndarray],
    dense_arch_layer_sizes: Sequence[int],
    over_arch_layer_sizes: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """``dense.npz`` leaves (flatten order) -> the port's ``DLRM``
    ``state_dict``."""
    pairs = _leaf_paths(len(dense_arch_layer_sizes), len(over_arch_layer_sizes))
    if len(leaves) != len(pairs):
        raise ValueError(
            f"{len(leaves)} dense leaves for a DLRM with {len(pairs)}"
        )
    return {key: _to_port(key, leaf) for (_, key), leaf in zip(pairs, leaves)}


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


def flax_params_from_dlrm_state_dict(
    state_dict: Mapping[str, torch.Tensor],
) -> Dict[str, Any]:
    """The port's ``DLRM`` parameters -> the flax params tree
    ``{"params": {...}}`` of float32 numpy arrays (inverse of
    :func:`dlrm_state_dict_from_flax`)."""
    n_dense, n_over = _layer_counts(state_dict)
    tree: Dict[str, Any] = {}
    for path, key in _leaf_paths(n_dense, n_over):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        arr = state_dict[key].detach().to(torch.float32).cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(
            arr.T if key.endswith(".weight") else arr)
    return tree


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


def train_state_from_jax(
    state: Mapping[str, Any],
    device=None,
    table_dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """A JAX ``DistributedModelParallel`` train state with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's train state on
    ``device``.  Table stacks keep their dtype (float32, or bfloat16 where
    the JAX stack is bfloat16) unless ``table_dtype`` is given."""

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
        "tables": {g: table(t) for g, t in state["tables"].items()},
        "fused": {g: _fused_from_jax(st, device)
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
