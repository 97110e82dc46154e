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
``nn.Linear.weight`` the transposed flax ``kernel``.  Everything here is
numpy and torch; nothing imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

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
