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

``export_native`` writes the artifact's ahead-of-time export for serving
with no Python in the request path (``inference/serving.py::
NativeInferenceServer``): ``torch.export`` of the flat serving function,
and its AOTInductor package for the export's device.
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
import json
import os
import time
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
from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.quant.embedding_modules import (
    QuantEmbeddingBagCollection,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
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
    # stored, not deflated: quantized codes barely compress, and deflating
    # the capped MLPerf DLRM-v2 tables' 3.7 GB takes minutes (np.load
    # reads either)
    np.savez(os.path.join(path, "tables.npz"), **arrays)
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


class FlatServing(torch.nn.Module):
    """A serving module behind the flat signature of an exported
    artifact: ``(dense [B, num_dense] f32, values [sum(caps) * B] i32,
    lengths [F * B] i32) -> scores [B] f32``.  The KeyedJaggedTensor is
    rebuilt inside with its static per-key regions: feature ``f``'s ids
    at ``sum(caps[:f]) * B``, front-packed in example order."""

    def __init__(self, serving: ServingModule, features: Sequence[str],
                 caps: Sequence[int], batch_size: int, num_dense: int):
        super().__init__()
        self.serving = serving
        self.num_dense = int(num_dense)
        self.features = tuple(features)
        self.batch_size = int(batch_size)
        self.batch_caps = tuple(int(c) * self.batch_size for c in caps)

    def forward(self, dense: torch.Tensor, values: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        kjt = KeyedJaggedTensor(self.features, values, lengths,
                                caps=self.batch_caps)
        return self.serving(dense, kjt).reshape(self.batch_size)

    def example_inputs(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Zero inputs at the signature's static shapes."""
        return (torch.zeros((self.batch_size, self.num_dense), dtype=torch.float32,
                            device=device),
                torch.zeros((sum(self.batch_caps),), dtype=torch.int32,
                            device=device),
                torch.zeros((len(self.features) * self.batch_size,),
                            dtype=torch.int32, device=device))


def flat_serving(path: str, device: DeviceLike = None,
                 lookup_kernel: Optional[str] = None,
                 batch_size: int = 16) -> Tuple[FlatServing, Dict[str, Any]]:
    """The artifact's serving module (:func:`load_packaged_model`) behind
    the flat signature at ``batch_size``, and its metadata."""
    serving, meta = load_packaged_model(path, device, lookup_kernel)
    features = [f for t in meta["tables"] for f in t["features"]]
    caps = [int(meta["feature_caps"][f]) for f in features]
    return FlatServing(serving, features, caps, batch_size,
                       meta["num_dense"]), meta


@contextlib.contextmanager
def _tf32_off():
    """float32 GEMMs in full float32, as the eager serving module runs
    them (TF32 would part the scores by more than the serving
    tolerance)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def package_constant_names(package_path: str) -> list:
    """The constants an AOTInductor package lists (the names its loader
    takes): loaded on the package's device; a card's package needs the
    ``trt::`` operators loaded first."""
    from torch._inductor.package import load_package

    return sorted(load_package(package_path).loader.get_constant_fqns())


def export_native(
    path: str,
    batch_size: int = 16,
    formats: Sequence[str] = ("pt2", "aoti"),
    device: DeviceLike = None,
    lookup_kernel: Optional[str] = None,
) -> Dict[str, Any]:
    """Ahead-of-time export of a packaged model for serving with no Python
    in the request path (the JAX package's ``export_native``; the
    reference's ``inference/server.cpp:50`` executes its exported model
    natively).  ``torch.export`` traces the artifact's serving module on
    ``device`` (the card by default; ``"cpu"`` when asked) behind the flat
    signature of :class:`FlatServing` at ``batch_size``; on the card each
    lookup group is its ``trt::`` operators (``ops/custom_ops.py``), on the
    CPU the plain versions, aten ops only.  Writes next to the artifact:

    * ``model.pt2`` — ``torch.export.save`` of that program (the
      counterpart of ``model.jaxexport``); reloads with
      ``torch.export.load``;
    * ``model_aoti.pt2`` — its AOTInductor package for ``device``,
      compiled (with ``ops/_native.py``'s ``CXX``) with
      ``package_constants_in_so=False``: no weight or table
      is inside; the executor hands it the loaded module's tensors as
      user-managed constants (``csrc/host/aoti_executor.cpp``);
    * ``native_manifest.json`` — the JAX manifest's fields (batch size,
      dense width, features, caps, inputs), the device, the lookup kernel,
      the package's constant names and each step's seconds; published
      last and atomically, so a killed export never leaves a manifest of
      half-written files.

    ``lookup_kernel`` as for :func:`load_packaged_model`.  Returns the
    manifest."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from torchrec_tpu_torch.ops import custom_ops

        custom_ops.load_ops()
    flat, meta = flat_serving(path, dev, lookup_kernel, batch_size)
    B, F, num_dense = flat.batch_size, len(flat.features), flat.num_dense
    total_vals = sum(flat.batch_caps)
    manifest: Dict[str, Any] = {
        "batch_size": B,
        "num_dense": num_dense,
        "features": list(flat.features),
        "caps": [c // B for c in flat.batch_caps],
        "inputs": [
            {"name": "dense", "dtype": "f32", "shape": [B, num_dense]},
            {"name": "values", "dtype": "i32", "shape": [total_vals]},
            {"name": "lengths", "dtype": "i32", "shape": [F * B]},
        ],
        "device": str(dev),
        "lookup_kernel": lookup_kernel,
        "formats": [],
        "seconds": {},
    }
    t0 = time.perf_counter()
    with torch.no_grad(), _tf32_off():
        ep = torch.export.export(flat, flat.example_inputs(dev))
    manifest["seconds"]["export"] = time.perf_counter() - t0
    if "pt2" in formats:
        t0 = time.perf_counter()
        torch.export.save(ep, os.path.join(path, "model.pt2"))
        manifest["seconds"]["save"] = time.perf_counter() - t0
        manifest["formats"].append("pt2")
    if "aoti" in formats:
        pkg = os.path.join(path, "model_aoti.pt2")
        t0 = time.perf_counter()
        cfg = {"cpp.cxx": (None, _native.CXX)}
        if dev.type == "cuda":
            # the package's host code is its wrapper alone: no probe of
            # the host's vector ISAs (a compile and a Python start each)
            cfg["cpp.vec_isa_ok"] = False
        with _tf32_off(), torch._inductor.config.patch(cfg):
            torch._inductor.aoti_compile_and_package(
                ep, package_path=pkg,
                inductor_configs={"aot_inductor.package_constants_in_so":
                                  False})
        manifest["seconds"]["aoti_compile"] = time.perf_counter() - t0
        manifest["constants"] = package_constant_names(pkg)
        manifest["formats"].append("aoti")
    mani_path = os.path.join(path, "native_manifest.json")
    with open(mani_path + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mani_path + ".tmp", mani_path)
    return manifest
