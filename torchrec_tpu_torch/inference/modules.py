"""Inference conversion and the serving function
(``torchrec_tpu/inference/modules.py``).

``quantize_inference_model`` turns float table weights into a
``QuantEmbeddingBagCollection``; ``build_serving_fn`` binds it to a dense
model as one ``(dense_features, kjt) -> scores`` module on one device.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
)
from torchrec_tpu_torch.quant.embedding_modules import (
    QuantEmbeddingBagCollection,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


def quantize_inference_model(
    tables: Sequence[EmbeddingBagConfig],
    table_weights: Mapping[str, np.ndarray],
    data_type: DataType = DataType.INT8,
    lookup_kernel: Optional[str] = None,
) -> QuantEmbeddingBagCollection:
    """Float table weights -> quantized collection (on the CPU)."""
    return QuantEmbeddingBagCollection.from_float(
        tables, table_weights, data_type, lookup_kernel
    )


class ServingModule(nn.Module):
    """One inference step: dense features ``[B, I]`` + KJT -> scores
    ``[B]``, with every input already on :attr:`device`.

    ``model`` exposes ``forward_from_embeddings(dense, kt)``; with no
    model the score is the sum of the pooled embeddings plus the sum of
    the dense features (the embedding-only artifact)."""

    def __init__(
        self,
        model: Optional[nn.Module],
        quant_ebc: QuantEmbeddingBagCollection,
        apply_sigmoid: bool,
    ):
        super().__init__()
        self.model = model
        self.quant_ebc = quant_ebc
        self.apply_sigmoid = apply_sigmoid

    @property
    def device(self) -> torch.device:
        return self.quant_ebc.device

    def with_lookup_kernel(self, lookup_kernel: Optional[str]
                           ) -> "ServingModule":
        """The same model and tables (shared, nothing copied) with the
        collection's lookups on ``lookup_kernel`` (``"tbe"`` or
        ``"dedup"``): a serving program's kernel choice, with no global
        switch."""
        return ServingModule(self.model,
                             self.quant_ebc.with_kernel(lookup_kernel),
                             self.apply_sigmoid).eval()

    @torch.inference_mode()
    def forward(
        self, dense_features: torch.Tensor, kjt: KeyedJaggedTensor
    ) -> torch.Tensor:
        kt = self.quant_ebc(kjt)
        if self.model is None:
            scores = kt.values().sum(dim=-1) + dense_features.sum(dim=-1)
        else:
            scores = self.model.forward_from_embeddings(
                dense_features, kt
            ).reshape(-1)
        return torch.sigmoid(scores) if self.apply_sigmoid else scores


def build_serving_fn(
    model: Optional[nn.Module],
    quant_ebc: QuantEmbeddingBagCollection,
    apply_sigmoid: bool = True,
    device: DeviceLike = None,
) -> ServingModule:
    """Bind the dense model and the quantized tables into one serving
    module on ``device`` (CUDA by default; ``RuntimeError`` with no
    card)."""
    dev = resolve_device(device)
    return ServingModule(model, quant_ebc, apply_sigmoid).to(dev).eval()
