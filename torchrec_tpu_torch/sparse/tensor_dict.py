"""Dict-of-tensors -> KJT (``torchrec_tpu/sparse/tensor_dict.py``): a
mapping of per-feature ``(values, lengths[, weights])`` entries or
JaggedTensors accepted wherever a KJT is expected."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from torchrec_tpu_torch.sparse.jagged_tensor import (
    JaggedTensor,
    KeyedJaggedTensor,
)

FeatureEntry = Union[JaggedTensor, Tuple]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dict_to_kjt(
    features: Mapping[str, FeatureEntry],
    caps: Optional[Dict[str, int]] = None,
) -> KeyedJaggedTensor:
    """``{feature: JaggedTensor | (values, lengths[, weights])}`` -> a KJT
    built on the host.  All features share one batch size; when any is
    weighted, the others get weight 1."""
    keys = list(features)
    if not keys:
        raise ValueError(
            "dict_to_kjt needs at least one feature: an empty mapping has "
            "no batch size to build a KJT from")
    vals, lens, wts = [], [], []
    for k in keys:
        e = features[k]
        if isinstance(e, JaggedTensor):
            l = _host(e.lengths())
            n = int(l.sum())
            v = _host(e.values())[:n]
            w = e.weights_or_none()
            w = None if w is None else _host(w)[:n]
        else:
            v, l = _host(e[0]), _host(e[1]).astype(np.int32)
            w = _host(e[2]) if len(e) > 2 else None
        vals.append(v)
        lens.append(l)
        wts.append(w)
    sizes = {len(l) for l in lens}
    if len(sizes) != 1:
        raise ValueError(
            "features disagree on batch size: "
            f"{ {k: len(l) for k, l in zip(keys, lens)} }")
    weighted = any(w is not None for w in wts)
    if weighted:
        wts = [np.ones((len(v),), np.float32) if w is None else w
               for w, v in zip(wts, vals)]
    return KeyedJaggedTensor.from_lengths_packed(
        keys, np.concatenate(vals), np.concatenate(lens),
        np.concatenate(wts) if weighted else None,
        caps=[caps[k] for k in keys] if caps else None)


def maybe_dict_to_kjt(
    features: Union[KeyedJaggedTensor, Mapping[str, FeatureEntry]],
    caps: Optional[Dict[str, int]] = None,
) -> KeyedJaggedTensor:
    """A KJT as it is; a mapping through :func:`dict_to_kjt`."""
    if isinstance(features, KeyedJaggedTensor):
        return features
    return dict_to_kjt(features, caps)
