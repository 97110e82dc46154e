"""Quantized EmbeddingBagCollection for inference
(``torchrec_tpu/quant/embedding_modules.py``).

An ``nn.Module`` holding, per table, the buffers ``q`` (uint8 codes,
int4/int2 packed, or the float16 / bfloat16 rows of an FP16/BF16 table),
``scale`` and ``bias`` (float32 per row; ones and zeros for a float
table, as in the JAX package).  ``forward`` keeps the float collection's
KJT -> KeyedTensor contract.  The features whose tables share a data
type, a lookup kernel and a width form a group, and each group is one
grouped lookup through the hand-written CUDA kernels of ``ops/tbe.py`` on
the card (their plain versions on the CPU), written straight into the
KeyedTensor's ``[B, sum D]`` float32 buffer, with no host sync:

* int8 (``"tbe"``: B3; ``"dedup"``: B5) and int4/int2 (B5): one launch a
  group, at the MLPerf DLRM-v2 configuration one a batch;
* FP16/BF16 (``"tbe"``: B1; ``"dedup"``: B4): one launch a feature, each
  reading its 16-bit table in place and writing float32 (no float32 copy
  of the table, which at the MLPerf DLRM-v2 row counts would not fit the
  card beside the 16-bit one, and no cast kernel).

The pooled buffer is cast to ``output_dtype`` (float32 by default) last,
as the JAX collection casts each pooled piece.

``forward`` traces under ``torch.export`` with no graph break and no
data-dependent shape (the caps and region offsets are Python ints): on
the card each group is its ``trt::`` operators writing the one buffer
(``ops/custom_ops.py``), on the CPU the plain versions' static-shape
form (``inference/predict_factory.py::export_native``).
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
    resolve_quant_kernel,
)
from torchrec_tpu_torch.ops.tbe import (
    MAX_GROUP_FEATURES,
    FloatFeature,
    GroupFeature,
    dedup_quant_pooled_lookup_grouped,
    float_pooled_lookup_grouped,
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
# the float serving tables: their rows' dtype
FLOAT_TABLE_DTYPES = {DataType.FP16: torch.float16,
                      DataType.BF16: torch.bfloat16}
OUTPUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_data_type(data_type: DataType) -> None:
    if data_type not in _QUANTIZERS and data_type not in FLOAT_TABLE_DTYPES:
        raise NotImplementedError(f"no serving lookup for {data_type}")


def _resolve_kernel(data_type: DataType, lookup_kernel: Optional[str]) -> str:
    """The lookup kernel for one table: ``"tbe"`` (int8, fp16, bf16) or
    ``"dedup"`` (any); None takes the process-wide
    selection (``quant_ops.set_quant_lookup_kernel``), whose default
    ``"xla"`` is ``"dedup"`` for int4/int2 and ``"tbe"`` otherwise."""
    lookup_kernel = resolve_quant_kernel(lookup_kernel)
    if lookup_kernel is None:
        return "dedup" if data_type in (DataType.INT4, DataType.INT2) else (
            "tbe")
    if lookup_kernel not in LOOKUP_KERNELS:
        raise ValueError(f"unknown lookup kernel {lookup_kernel!r}")
    if lookup_kernel == "tbe" and data_type in (DataType.INT4, DataType.INT2):
        raise ValueError(
            f"lookup_kernel='tbe' serves int8, fp16 and bf16 tables, not "
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
    """Int8/int4/int2 quantized and FP16/BF16 pooled embedding collection.

    ``params``: per table name, a mapping with the tensors ``q``
    (uint8; float16 / bfloat16 for an FP16 / BF16 table), ``scale`` and
    ``bias``, registered as buffers (shared, not copied).
    ``lookup_kernel`` selects the kernel for every table (``"tbe"``:
    int8, fp16, bf16; ``"dedup"``: any); ``None`` picks ``"dedup"`` for
    int4/int2 tables and ``"tbe"`` for the others.  ``output_dtype`` is
    the KeyedTensor's dtype (float32, bfloat16 or float16)."""

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        params: Mapping[str, Mapping[str, torch.Tensor]],
        lookup_kernel: Optional[str] = None,
        output_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if output_dtype not in OUTPUT_DTYPES:
            raise TypeError(f"output_dtype must be one of {OUTPUT_DTYPES}, "
                            f"got {output_dtype}")
        self.tables = tuple(tables)
        self.output_dtype = output_dtype
        self.lookup_kernel = lookup_kernel
        self._kernels: Dict[str, str] = {}
        for cfg in self.tables:
            _check_data_type(cfg.data_type)
            want = FLOAT_TABLE_DTYPES.get(cfg.data_type, torch.uint8)
            if params[cfg.name]["q"].dtype != want:
                raise TypeError(f"table {cfg.name!r} ({cfg.data_type.name}): "
                                f"q must be {want}, got "
                                f"{params[cfg.name]['q'].dtype}")
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
        output_dtype: torch.dtype = torch.float32,
    ) -> "QuantEmbeddingBagCollection":
        """Quantize float table weights (numpy or tensors) row-wise, or
        for FP16/BF16 round them to 16 bits (scale ones, bias zeros); the
        collection is built where the weights lie (numpy: the CPU)."""
        _check_data_type(data_type)
        params = {}
        for cfg in tables:
            w = torch.as_tensor(weights[cfg.name]).to(torch.float32)
            if data_type in FLOAT_TABLE_DTYPES:
                R = w.shape[0]
                q = w.to(FLOAT_TABLE_DTYPES[data_type])
                scale = torch.ones((R,), dtype=torch.float32,
                                   device=w.device)
                bias = torch.zeros((R,), dtype=torch.float32,
                                   device=w.device)
            else:
                q, scale, bias = _QUANTIZERS[data_type](w)
            params[cfg.name] = {"q": q, "scale": scale, "bias": bias}
        quant_tables = tuple(
            dataclasses.replace(c, data_type=data_type) for c in tables
        )
        return QuantEmbeddingBagCollection(quant_tables, params, lookup_kernel,
                                           output_dtype)

    def with_kernel(self, lookup_kernel: Optional[str]
                    ) -> "QuantEmbeddingBagCollection":
        """The same tables (their buffers shared, nothing copied) looked up
        with ``lookup_kernel``: how a serving program picks its kernel
        without any process-wide switch."""
        params = {name: {"q": p.q, "scale": p.scale, "bias": p.bias}
                  for name, p in self.params.items()}
        return QuantEmbeddingBagCollection(self.tables, params, lookup_kernel,
                                           self.output_dtype)

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
        """KJT -> KeyedTensor of dequantized pooled embeddings [B, sum D]
        in ``output_dtype``: one grouped lookup per group of features."""
        keys = {k: i for i, k in enumerate(kjt.keys())}
        missing = [f for f in self._out_keys if f not in keys]
        if missing:
            raise KeyError(f"features {missing} are not in the batch")
        offsets = kjt.cap_offsets()
        out = torch.empty((kjt.stride(), sum(self._out_dims)),
                          dtype=torch.float32, device=kjt.values().device)
        for data_type, kernel, members in self._groups:
            if data_type in FLOAT_TABLE_DTYPES:
                float_pooled_lookup_grouped(
                    kjt.values(), kjt.lengths(), offsets,
                    [FloatFeature(self.params[t].q, keys[f], col, mean)
                     for t, f, col, mean in members], out, kernel)
                continue
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
        if self.output_dtype != torch.float32:
            out = out.to(self.output_dtype)
        return KeyedTensor(self._out_keys, self._out_dims, out)
