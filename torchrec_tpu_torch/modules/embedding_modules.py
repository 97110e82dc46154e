"""EmbeddingBagCollection / EmbeddingCollection, the unsharded authoring
API (``torchrec_tpu/modules/embedding_modules.py``).

Each collection holds one ``nn.Parameter`` per table, named after the
table (``ebc.<table name>``), drawn by the table config's ``init_fn``
from an explicit ``torch.Generator`` and cast to the config's storage
type.  Built on ``torch.device("meta")``, a collection is a placeholder
for a sharded runtime's tables (the DMP and the serving module hold the
tables themselves, as the JAX package's lazy flax init never creates
them): it allocates nothing, and moving or casting its model leaves it
on meta.

The pooled forward (KJT -> KeyedTensor) makes one pooled lookup per
table (:func:`pooled_lookup_for_table`, differentiable): on the card one
launch of the table's kernel, so 26 for the 26 tables of ``bench.py
main()``.  That is the JAX package's design for this path (the sharded
collection is the grouped one), and it is kept.  ``"tbe"`` (B1,
``csrc/tbe_float.cu``) reads the table's keys where the KJT holds them,
as slot regions at its ``cap_offsets()`` (``ops/embedding_ops.py::
pooled_embedding_lookup_regions``: no permute when the keys are adjacent
and in the table's order, no segment ids, no sort); ``"dedup"`` (B4,
``csrc/tbe_dedup.cu``) takes the same regions' segment ids
(``pooled_embedding_lookup``) and sorts in its wrapper.

Half-precision tables: the JAX collection upcasts a bfloat16 or float16
table to float32 before it pools, so its output is float32 and the
pooled sum is never rounded to 16 bits.  The port does the same: a
non-float32 table is cast whole to float32 (one table-sized copy per
forward, its gradient cast back by autograd) and the kernel pools the
float32 copy, returning float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    BaseEmbeddingConfig,
    DataType,
    EmbeddingBagConfig,
    EmbeddingConfig,
    PoolingType,
    data_type_to_dtype,
)
from torchrec_tpu_torch.ops.embedding_ops import (
    SlotRegions,
    mean_pooling_weights,
    pooled_embedding_lookup,
    pooled_embedding_lookup_regions,
    resolve_lookup_kernel,
    sequence_embedding_lookup,
)
from torchrec_tpu_torch.sparse import JaggedTensor, KeyedJaggedTensor, KeyedTensor
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

_FLOAT_TYPES = (DataType.FP32, DataType.FP16, DataType.BF16)


def key_regions(
    kjt: KeyedJaggedTensor, keys: Sequence[int]
) -> Tuple[torch.Tensor, Optional[torch.Tensor], SlotRegions,
           Optional[torch.Tensor]]:
    """The slots of ``keys`` as a pooled lookup reads them in place: (ids,
    per-id weights or None, their regions, the keys' inverse indices or
    None).  Views of the KJT's own buffers when the keys are adjacent and
    in order, else of a permuted copy; example ``e`` of the regions is
    example ``b`` of key ``i`` at ``e = sum(strides[:i]) + b``."""
    idx = [int(k) for k in keys]
    if idx != list(range(idx[0], idx[0] + len(idx))):
        kjt, idx = kjt.permute(idx), list(range(len(idx)))
    a, b = idx[0], idx[-1] + 1
    co, lo = kjt.cap_offsets(), kjt._length_offsets()
    w = kjt.weights_or_none()
    regions = SlotRegions(
        kjt.lengths()[lo[a]:lo[b]], tuple(co[k] - co[a] for k in idx),
        kjt.caps[a:b], kjt.stride_per_key()[a:b])
    inv = kjt.inverse_indices_or_none()
    return (kjt.values()[co[a]:co[b]], None if w is None else w[co[a]:co[b]],
            regions, None if inv is None else inv[a:b])


def pooled_lookup_for_table(
    weight: torch.Tensor,
    kjt: KeyedJaggedTensor,
    feature_indices: Sequence[int],
    pooling: PoolingType,
    is_weighted: bool,
    kernel: str = "tbe",
) -> torch.Tensor:
    """Pool all of one table's features in one lookup: ``[num_features, B,
    D]``.  Each slot of the table's keys, read in place as regions
    (:func:`key_regions`), pools into its example's segment (``"tbe"``:
    the regions themselves; ``"dedup"``: each slot's segment id from
    them); MEAN is a weighted SUM with weights ``1 / length``.
    Under a variable batch each feature's ``[B_f, D]`` block expands to
    the full batch through its inverse indices."""
    nf, D = len(feature_indices), weight.shape[1]
    ids, w, regions, inv = key_regions(kjt, feature_indices)
    weights = w if is_weighted else None
    seg = (regions.segment_ids(ids.shape[0])
           if kernel != "tbe" or pooling == PoolingType.MEAN else None)
    if pooling == PoolingType.MEAN:
        weights = mean_pooling_weights(seg, regions.lengths, weights)
    if kernel == "tbe":
        pooled = pooled_embedding_lookup_regions(weight, ids, regions,
                                                 weights)
    else:
        pooled = pooled_embedding_lookup(weight, ids, seg,
                                         regions.num_segments, weights,
                                         kernel=kernel)
    strides = regions.counts
    if not kjt.variable_stride_per_key:
        return pooled.reshape(nf, kjt.stride(), D)
    if inv is None:
        raise ValueError("a variable-batch KJT needs inverse_indices to "
                         "expand its per-key batches")
    out, lo = [], 0
    for f in range(nf):
        block = pooled[lo: lo + strides[f]]  # [B_f, D]
        idx = inv[f].to(torch.int64).clamp(0, max(block.shape[0] - 1, 0))
        out.append(block[idx])
        lo += strides[f]
    return torch.stack(out)


def _check_tables(configs: Sequence[BaseEmbeddingConfig]) -> None:
    names = [c.name for c in configs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate table names: {names}")
    for c in configs:
        if not c.feature_names:
            raise ValueError(f"table {c.name} has no feature_names")


def _register_tables(module: nn.Module, configs, device: DeviceLike,
                     generator: Optional[torch.Generator]) -> None:
    """One parameter per table, named after it: empty on meta, else drawn
    by ``init_fn`` from ``generator`` and cast to the storage type."""
    dev = resolve_device(device)
    if dev.type != "meta" and generator is None:
        raise ValueError("pass a torch.Generator to draw the tables (or "
                         "build the collection on torch.device('meta'))")
    for c in configs:
        if c.data_type not in _FLOAT_TYPES:
            raise ValueError(
                f"table {c.name}: {c.data_type} is a quantized type; a "
                "quantized table belongs in QuantEmbeddingBagCollection")
        if hasattr(module, c.name):
            raise ValueError(f"table name {c.name!r} is taken by an "
                             f"attribute of {type(module).__name__}")
        dtype = data_type_to_dtype(c.data_type)
        if dev.type == "meta":
            w = torch.empty((c.num_embeddings, c.embedding_dim),
                            dtype=dtype, device=dev)
        else:
            w = c.init_fn(generator).to(device=dev, dtype=dtype)
        module.register_parameter(c.name, nn.Parameter(w))


class _TableCollection(nn.Module):
    """What both collections share: the tables, and staying on meta."""

    tables: Tuple[BaseEmbeddingConfig, ...]

    @property
    def is_meta(self) -> bool:
        return any(p.is_meta for p in self.parameters())

    def _apply(self, fn, recurse=True):
        if self.is_meta:
            return self
        return super()._apply(fn, recurse)


class EmbeddingBagCollection(_TableCollection):
    """Pooled lookup over a collection of tables: ``forward(kjt)`` ->
    KeyedTensor with one key per feature name (tables in order, each
    table's features in its order), each of its table's dim, float32.

    ``kernel``: ``"tbe"`` (B1) or ``"dedup"`` (B4), the same numbers;
    None takes the process-wide selection
    (``embedding_ops.set_pooled_lookup_kernel``) when the collection is
    built.  ``device``: CUDA unless the caller names another (``RuntimeError``
    without a card); ``torch.device("meta")`` for a placeholder.
    ``generator``: draws the tables (required off meta)."""

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        is_weighted: bool = False,
        device: DeviceLike = None,
        kernel: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_tables(tables)
        feats = [f for c in tables for f in c.feature_names]
        if len(set(feats)) != len(feats):
            raise ValueError(f"duplicate features: {feats}")
        kernel = resolve_lookup_kernel(kernel)
        _register_tables(self, tables, device, generator)
        self.tables = tuple(tables)
        self.is_weighted = is_weighted
        self.kernel = kernel

    def forward(self, kjt: KeyedJaggedTensor) -> KeyedTensor:
        keys = kjt.keys()
        out_keys: List[str] = []
        dims: List[int] = []
        pieces: List[torch.Tensor] = []
        for c in self.tables:
            w = getattr(self, c.name)
            pooled = pooled_lookup_for_table(
                w if w.dtype == torch.float32 else w.to(torch.float32),
                kjt, [keys.index(f) for f in c.feature_names], c.pooling,
                self.is_weighted, self.kernel)
            for i, f in enumerate(c.feature_names):
                out_keys.append(f)
                dims.append(c.embedding_dim)
                pieces.append(pooled[i])
        return KeyedTensor(out_keys, dims, torch.cat(pieces, dim=-1))

    def embedding_bag_configs(self) -> Tuple[EmbeddingBagConfig, ...]:
        return self.tables


class EmbeddingCollection(_TableCollection):
    """Sequence (unpooled) lookup: ``forward(kjt)`` -> ``{feature:
    JaggedTensor}`` whose values are the ``[cap, D]`` rows of the
    feature's ids, the padding slots' rows zero (a plain gather, as in the
    JAX package).  ``device`` and ``generator`` as for
    :class:`EmbeddingBagCollection`."""

    def __init__(
        self,
        tables: Sequence[EmbeddingConfig],
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_tables(tables)
        _register_tables(self, tables, device, generator)
        self.tables = tuple(tables)

    def forward(self, kjt: KeyedJaggedTensor) -> Dict[str, JaggedTensor]:
        out: Dict[str, JaggedTensor] = {}
        for c in self.tables:
            w = getattr(self, c.name)
            for f in c.feature_names:
                jt = kjt[f]
                rows = sequence_embedding_lookup(w, jt.values(),
                                                 jt.valid_mask())
                out[f] = JaggedTensor(rows, jt.lengths())
        return out
