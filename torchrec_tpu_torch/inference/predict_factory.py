"""Model packaging for serving (``torchrec_tpu/inference/predict_factory.py``).

``package_model`` writes the artifact directory and ``load_packaged_model``
restores a serving module from it, with no trainer code.  The format is
the JAX package's v2, in both directions:

* ``metadata.json`` — format version, quantization, dense width, feature
  caps, tables, batching metadata, the model config; written LAST, so
  its presence marks a complete artifact;
* ``tables.npz`` — per table ``<name>__q`` / ``__scale`` / ``__bias``,
  quantized at package time (fp16 rows as float16, bf16 rows as their
  uint16 bits: ``np.savez`` has no bfloat16);
* ``dense.npz`` + ``dense_treedef.json`` — the DLRM dense weights as
  ``leaf_<i>`` in the flax ``jax.tree.flatten`` order (``convert.py``),
  no table among them.

The loaded DLRM's ``EmbeddingBagCollection`` is built on
``torch.device("meta")``: the quantized collection does the lookup and
the model runs ``forward_from_embeddings``, so its float tables are
never allocated.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.convert import (
    dense_leaves_from_flax_order,
    dense_leaves_to_flax_order,
    quant_params_from_numpy,
)
from torchrec_tpu_torch.inference.modules import ServingModule, build_serving_fn
from torchrec_tpu_torch.models.dlrm import (
    DLRM,
    SPARSE_PREFIX,
    load_dense_state_dict,
)
from torchrec_tpu_torch.models.dlrm import dense_state_dict as dense_params
from torchrec_tpu_torch.modules.embedding_configs import (
    DataType,
    EmbeddingBagConfig,
    PoolingType,
    pooling_type_to_str,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.quant.embedding_modules import (
    QuantEmbeddingBagCollection,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# tables.npz layout: v2 = quantized name__q/__scale/__bias triplets
_FORMAT_VERSION = 2


@dataclasses.dataclass
class BatchingMetadata:
    """How the server batches one input (``type`` "dense" | "sparse")."""

    type: str
    device: str = "cuda"
    pinned: bool = False


class PredictFactory(abc.ABC):
    """What a serving fleet needs to load a model without the trainer:
    the predict module and how its inputs batch."""

    @abc.abstractmethod
    def create_predict_module(self) -> Callable:
        """The serving module ``(dense, kjt) -> scores`` with its weights
        bound."""

    @abc.abstractmethod
    def batching_metadata(self) -> Dict[str, BatchingMetadata]:
        """Input name -> BatchingMetadata (drives server-side batching)."""

    def batching_metadata_json(self) -> str:
        return json.dumps(
            {
                k: dataclasses.asdict(v)
                for k, v in self.batching_metadata().items()
            }
        )

    @abc.abstractmethod
    def result_metadata(self) -> str:
        """Result type tag the response splitter keys on."""

    def model_inputs_data(self) -> Dict[str, Any]:
        """Benchmark input generation hints (optional)."""
        return {}

_QUANT_DTYPES = {
    "int8": DataType.INT8,
    "int4": DataType.INT4,
    "int2": DataType.INT2,
    "fp16": DataType.FP16,
    "bf16": DataType.BF16,
}


def package_model(
    path: str,
    tables: Sequence[EmbeddingBagConfig],
    table_weights: Mapping[str, np.ndarray],
    feature_caps: Mapping[str, int],
    num_dense: int,
    quant_dtype: str = "int8",
    dense_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    model_config: Optional[Dict[str, Any]] = None,
) -> None:
    """Write the serving artifact: metadata + quantized tables (+ the
    DLRM dense weights from the port's ``DLRM.state_dict()``; its tables,
    the keys under ``sparse_arch.``, are left out)."""
    if quant_dtype not in _QUANT_DTYPES:
        raise ValueError(
            f"quant_dtype {quant_dtype!r} not loadable (have "
            f"{tuple(_QUANT_DTYPES)})"
        )
    for c in tables:
        if c.pooling is PoolingType.NONE:
            raise ValueError(
                f"table {c.name!r} has pooling=NONE (sequence table): "
                "package_model serves pooled artifacts only"
            )
    os.makedirs(path, exist_ok=True)
    meta = {
        "format_version": _FORMAT_VERSION,
        "quant_dtype": quant_dtype,
        "num_dense": num_dense,
        "feature_caps": dict(feature_caps),
        "tables": [
            {
                "name": c.name,
                "rows": c.num_embeddings,
                "dim": c.embedding_dim,
                "features": list(c.feature_names),
                "pooling": pooling_type_to_str(c.pooling),
            }
            for c in tables
        ],
        "batching_metadata": {
            "float_features": dataclasses.asdict(
                BatchingMetadata(type="dense")),
            "id_list_features": dataclasses.asdict(
                BatchingMetadata(type="sparse")),
        },
        "result_metadata": "scores",
        "model": model_config,
    }
    qebc = QuantEmbeddingBagCollection.from_float(
        list(tables), table_weights, data_type=_QUANT_DTYPES[quant_dtype]
    )
    arrays = {}
    for name, p in qebc.params.items():
        q = p.q.cpu()
        if q.dtype == torch.bfloat16:  # np.savez has no bfloat16
            q = q.view(torch.int16).numpy().view(np.uint16)
        else:
            q = q.numpy()
        arrays[f"{name}__q"] = q
        arrays[f"{name}__scale"] = p.scale.cpu().numpy()
        arrays[f"{name}__bias"] = p.bias.cpu().numpy()
    np.savez_compressed(os.path.join(path, "tables.npz"), **arrays)
    if dense_state_dict is not None:
        leaves = dense_leaves_to_flax_order(
            {k: v for k, v in dense_state_dict.items()
             if not k.startswith(SPARSE_PREFIX)})
        np.savez_compressed(
            os.path.join(path, "dense.npz"),
            **{f"leaf_{i}": x for i, x in enumerate(leaves)},
        )
        with open(os.path.join(path, "dense_treedef.json"), "w") as f:
            json.dump({"repr": "flax DLRM params, jax.tree.flatten order",
                       "n_leaves": len(leaves)}, f)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_packaged_model(
    path: str,
    device: DeviceLike = None,
    lookup_kernel: Optional[str] = None,
) -> Tuple[ServingModule, Dict[str, Any]]:
    """-> (serving module returning logits, metadata), restored purely
    from the artifact onto ``device`` (CUDA by default; ``RuntimeError``
    with no card).  ``lookup_kernel`` as for
    :class:`QuantEmbeddingBagCollection`."""
    dev = resolve_device(device)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"artifact format_version {meta.get('format_version')} != "
            f"{_FORMAT_VERSION}; re-run package_model to regenerate"
        )
    dt = _QUANT_DTYPES[meta["quant_dtype"]]
    tables = tuple(
        EmbeddingBagConfig(
            num_embeddings=t["rows"],
            embedding_dim=t["dim"],
            name=t["name"],
            data_type=dt,
            feature_names=list(t["features"]),
            pooling=PoolingType(t["pooling"].upper()),
        )
        for t in meta["tables"]
    )
    with np.load(os.path.join(path, "tables.npz")) as blobs:
        params = quant_params_from_numpy({
            t.name: {k: blobs[f"{t.name}__{k}"]
                     for k in ("q", "scale", "bias")}
            for t in tables
        })
    if meta["quant_dtype"] == "bf16":
        for p in params.values():
            p["q"] = p["q"].view(torch.int16).view(torch.bfloat16)
    qebc = QuantEmbeddingBagCollection(tables, params, lookup_kernel)

    mc = meta.get("model")
    dense_path = os.path.join(path, "dense.npz")
    model = None
    if mc and mc.get("arch") == "dlrm" and os.path.exists(dense_path):
        float_tables = [dataclasses.replace(c, data_type=DataType.FP32)
                        for c in tables]
        model = DLRM(
            EmbeddingBagCollection(float_tables, device="meta"),
            dense_in_features=meta["num_dense"],
            dense_arch_layer_sizes=tuple(mc["dense_arch_layer_sizes"]),
            over_arch_layer_sizes=tuple(mc["over_arch_layer_sizes"]),
        )
        with open(os.path.join(path, "dense_treedef.json")) as f:
            n_leaves = json.load(f)["n_leaves"]
        with np.load(dense_path) as blob:
            leaves = [blob[f"leaf_{i}"] for i in range(n_leaves)]
        load_dense_state_dict(model, dense_leaves_from_flax_order(
            leaves, dense_params(model)))
    return build_serving_fn(model, qebc, apply_sigmoid=False, device=dev), meta
