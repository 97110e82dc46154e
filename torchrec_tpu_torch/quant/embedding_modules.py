"""Quantized EmbeddingBagCollection for inference
(``torchrec_tpu/quant/embedding_modules.py``).

An ``nn.Module`` holding, per table, the buffers ``q`` (uint8 codes,
int4/int2 packed), ``scale`` and ``bias`` (float32 per row).  ``forward``
keeps the float collection's KJT -> KeyedTensor contract.  The features
whose tables share a data type, a lookup kernel and a width form a group,
and each group is one grouped lookup through the hand-written CUDA kernels
of ``ops/tbe.py`` on the card (their plain versions on the CPU), written
straight into the KeyedTensor's ``[B, sum D]`` buffer: at the MLPerf
DLRM-v2 configuration one launch per batch, and no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops.quant_ops import (
    LOOKUP_KERNELS,
    quantize_rowwise_int2,
    quantize_rowwise_int4,
    quantize_rowwise_int8,
)
from torchrec_tpu_torch.ops.tbe import (
    MAX_GROUP_FEATURES,
    GroupFeature,
    dedup_quant_pooled_lookup_grouped,
    quant_pooled_lookup_int8_grouped,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, KeyedTensor
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

_QUANTIZERS = {
    DataType.INT8: quantize_rowwise_int8,
    DataType.INT4: quantize_rowwise_int4,
    DataType.INT2: quantize_rowwise_int2,
}
_BITS = {DataType.INT8: 8, DataType.INT4: 4, DataType.INT2: 2}


def _check_data_type(data_type: DataType) -> None:
    if data_type in (DataType.FP16, DataType.BF16):
        raise NotImplementedError(
            f"{data_type.name} serving tables are not ported: the "
            "collection's float path and the artifact's float format are "
            "still to come (the float pooled lookup, B1, exists)"
        )
    if data_type not in _QUANTIZERS:
        raise NotImplementedError(f"no quantized lookup for {data_type}")


def _resolve_kernel(data_type: DataType, lookup_kernel: Optional[str]) -> str:
    """The lookup kernel for one table: ``"tbe"`` (int8 only) or
    ``"dedup"``; by default ``"tbe"`` for int8, ``"dedup"`` otherwise."""
    if lookup_kernel is None:
        return "tbe" if data_type == DataType.INT8 else "dedup"
    if lookup_kernel not in LOOKUP_KERNELS:
        raise ValueError(f"unknown lookup kernel {lookup_kernel!r}")
    if lookup_kernel == "tbe" and data_type != DataType.INT8:
        raise ValueError(
            f"lookup_kernel='tbe' serves int8 tables only, not "
            f"{data_type.name}; use 'dedup'"
        )
    return lookup_kernel


class _QuantTable(nn.Module):
    """One table's quantized rows as buffers."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


class QuantEmbeddingBagCollection(nn.Module):
    """Int8/int4/int2 quantized pooled embedding collection.

    ``params``: per table name, a module with buffers ``q``, ``scale``
    and ``bias``.  ``lookup_kernel`` selects the kernel for every table
    (``"tbe"``: int8 only; ``"dedup"``: any width); ``None`` picks
    ``"tbe"`` for int8 tables and ``"dedup"`` for int4/int2."""

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        params: Mapping[str, Mapping[str, torch.Tensor]],
        lookup_kernel: Optional[str] = None,
    ):
        super().__init__()
        self.tables = tuple(tables)
        self._kernels: Dict[str, str] = {}
        for cfg in self.tables:
            _check_data_type(cfg.data_type)
            self._kernels[cfg.name] = _resolve_kernel(
                cfg.data_type, lookup_kernel
            )
        # (table, feature, first output column, MEAN) per feature, in table
        # order, grouped by (data type, kernel, width), at most
        # MAX_GROUP_FEATURES a group
        self._out_keys, self._out_dims, groups = [], [], {}
        col = 0
        for cfg in self.tables:
            key = (cfg.data_type, self._kernels[cfg.name], cfg.embedding_dim)
            for f in cfg.feature_names:
                groups.setdefault(key, []).append(
                    (cfg.name, f, col, cfg.pooling == PoolingType.MEAN))
                self._out_keys.append(f)
                self._out_dims.append(cfg.embedding_dim)
                col += cfg.embedding_dim
        self._groups = [
            (data_type, kernel, members[i:i + MAX_GROUP_FEATURES])
            for (data_type, kernel, _), members in groups.items()
            for i in range(0, len(members), MAX_GROUP_FEATURES)
        ]
        self.params = nn.ModuleDict({
            cfg.name: _QuantTable(
                params[cfg.name]["q"],
                params[cfg.name]["scale"],
                params[cfg.name]["bias"],
            )
            for cfg in self.tables
        })

    @staticmethod
    def from_float(
        tables: Sequence[EmbeddingBagConfig],
        weights: Mapping[str, np.ndarray],
        data_type: DataType = DataType.INT8,
        lookup_kernel: Optional[str] = None,
    ) -> "QuantEmbeddingBagCollection":
        """Quantize float table weights (numpy or tensors) row-wise; the
        collection is built where the weights lie (numpy: the CPU)."""
        _check_data_type(data_type)
        params = {}
        for cfg in tables:
            w = torch.as_tensor(weights[cfg.name])
            q, scale, bias = _QUANTIZERS[data_type](w)
            params[cfg.name] = {"q": q, "scale": scale, "bias": bias}
        quant_tables = tuple(
            dataclasses.replace(c, data_type=data_type) for c in tables
        )
        return QuantEmbeddingBagCollection(quant_tables, params, lookup_kernel)

    def to(self, device: DeviceLike = None) -> "QuantEmbeddingBagCollection":
        """Move every table to ``device`` (CUDA by default; raises
        ``RuntimeError`` with no card)."""
        return super().to(resolve_device(device))

    @property
    def num_groups(self) -> int:
        """Grouped lookups per batch: one launch of a lookup kernel each."""
        return len(self._groups)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).q.device

    def forward(self, kjt: KeyedJaggedTensor) -> KeyedTensor:
        """KJT -> KeyedTensor of dequantized pooled embeddings [B, sum D]:
        one grouped lookup per group of features."""
        keys = {k: i for i, k in enumerate(kjt.keys())}
        missing = [f for f in self._out_keys if f not in keys]
        if missing:
            raise KeyError(f"features {missing} are not in the batch")
        offsets = kjt.cap_offsets()
        out = torch.empty((kjt.stride(), sum(self._out_dims)),
                          dtype=torch.float32, device=kjt.values().device)
        for data_type, kernel, members in self._groups:
            feats = [
                GroupFeature(self.params[t].q, self.params[t].scale,
                             self.params[t].bias, keys[f], col, mean)
                for t, f, col, mean in members
            ]
            if kernel == "tbe":
                quant_pooled_lookup_int8_grouped(
                    kjt.values(), kjt.lengths(), offsets, feats, out)
            else:
                dedup_quant_pooled_lookup_grouped(
                    kjt.values(), kjt.lengths(), offsets, feats, out,
                    bits=_BITS[data_type])
        return KeyedTensor(self._out_keys, self._out_dims, out)
