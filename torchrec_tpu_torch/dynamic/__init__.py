"""Dynamic embeddings (``torchrec_tpu/dynamic``): the parameter server and
its IO registry (:mod:`~torchrec_tpu_torch.dynamic.kv_store`), the dynamic
vocabularies (:mod:`~torchrec_tpu_torch.dynamic.vocab`) and the TCP
key-value store that the elastic commit barrier speaks
(:mod:`~torchrec_tpu_torch.dynamic.tcp_kv`)."""

from torchrec_tpu_torch.dynamic.kv_store import (
    EmbeddingKVStore,
    IORegistry,
    KVBackedRows,
    ParameterServer,
    io_registry,
)
from torchrec_tpu_torch.dynamic.vocab import (
    BloomWindow,
    CountMinSketch,
    DynamicVocab,
    DynamicVocabCollection,
    VocabIO,
    VocabJournalError,
    VocabView,
)

__all__ = [
    "BloomWindow",
    "CountMinSketch",
    "DynamicVocab",
    "DynamicVocabCollection",
    "EmbeddingKVStore",
    "IORegistry",
    "KVBackedRows",
    "ParameterServer",
    "VocabIO",
    "VocabJournalError",
    "VocabView",
    "io_registry",
]
