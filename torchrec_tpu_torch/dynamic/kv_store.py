"""Parameter-server storage for dynamic embeddings
(``torchrec_tpu/dynamic/kv_store.py``).

The card's table is a normal table of the ``DistributedModelParallel``,
updated by the fused optimizer; the input pipeline owns the id -> slot map
on the host (the managed-collision modules, the dynamic vocabularies), so
parameter-server traffic is host work: evicted rows are PUT to a key-value
backend, newly assigned ids GET from it (a missing key keeps the row's
init).  The durable backend, :class:`EmbeddingKVStore`, is the host
library's append-log store (``csrc/host/kv_store.cpp``), the same file
format as the JAX package's.  :data:`io_registry` resolves a URL to a
backend by its scheme: ``file://`` (that store; a bare path means it too),
``mem://`` (an in-process dict, :class:`_MemKV`) and ``tcp://``
(``dynamic/tcp_kv.py``, which registers itself when first resolved).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from torchrec_tpu_torch.ops._native import load_host_library


class EmbeddingKVStore:
    """Native append-log KV: int64 key -> float32 row[dim].

    Durable across process restarts; last write wins; a torn tail is
    truncated and a log more than half dead compacted on open.  The host
    library is built at first use; a failed build raises."""

    def __init__(self, path: str, dim: int):
        self._lib = load_host_library()
        self._h = self._lib.trt_kv_open(path.encode(), dim)
        if not self._h:
            raise OSError(f"could not open KV store at {path}")
        self.path = path
        self.dim = dim

    def put(self, keys: np.ndarray, rows: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        assert rows.shape == (len(keys), self.dim), rows.shape
        c = ctypes
        self._lib.trt_kv_put(
            self._h,
            keys.ctypes.data_as(c.POINTER(c.c_int64)),
            rows.ctypes.data_as(c.POINTER(c.c_float)),
            len(keys),
        )

    def get(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rows [n, dim] f32 with zeros for misses, found [n] bool)."""
        keys = np.ascontiguousarray(keys, np.int64)
        out = np.zeros((len(keys), self.dim), np.float32)
        found = np.zeros((len(keys),), np.uint8)
        c = ctypes
        self._lib.trt_kv_get(
            self._h,
            keys.ctypes.data_as(c.POINTER(c.c_int64)),
            len(keys),
            out.ctypes.data_as(c.POINTER(c.c_float)),
            found.ctypes.data_as(c.POINTER(c.c_uint8)),
        )
        return out, found.astype(bool)

    def __len__(self) -> int:
        return int(self._lib.trt_kv_size(self._h))

    def keys(self) -> np.ndarray:
        """All live keys (last write wins), unordered."""
        n = len(self)
        while True:
            out = np.empty((max(n, 0),), np.int64)
            if n <= 0:
                return out
            live = int(self._lib.trt_kv_keys(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n))
            if live <= n:
                # a put between len() and keys() can change the live set;
                # the C side reports the count it copied
                return out[:live]
            n = live  # the buffer was too small: retry at that size

    def close(self) -> None:
        if self._h:
            self._lib.trt_kv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _MemKV:
    """In-process dict backend (the ``mem://`` scheme): for tests, and the
    template of a custom registration."""

    _SHARED: Dict[str, Dict[int, np.ndarray]] = {}

    def __init__(self, path: str, dim: int):
        self._d = self._SHARED.setdefault(path, {})
        self.dim = dim

    def put(self, keys, rows):
        for k, r in zip(np.asarray(keys, np.int64), rows):
            self._d[int(k)] = np.asarray(r, np.float32).copy()

    def get(self, keys):
        keys = np.asarray(keys, np.int64)
        out = np.zeros((len(keys), self.dim), np.float32)
        found = np.zeros((len(keys),), bool)
        for i, k in enumerate(keys):
            r = self._d.get(int(k))
            if r is not None:
                out[i] = r
                found[i] = True
        return out, found

    def __len__(self):
        return len(self._d)

    def keys(self):
        return np.asarray(sorted(self._d), np.int64)

    def close(self):
        pass


class IORegistry:
    """Scheme -> backend factory: register named IO providers, resolve a
    URL (``scheme://rest``; a bare path is ``file``)."""

    def __init__(self):
        self._factories: Dict[str, Callable[[str, int], object]] = {}

    def register(self, scheme: str, factory: Callable[[str, int], object]):
        self._factories[scheme] = factory

    def resolve(self, url: str, dim: int):
        scheme, _, rest = url.partition("://")
        if not rest:
            scheme, rest = "file", url
        if scheme not in self._factories and scheme in _LAZY_PROVIDERS:
            # the repo's own providers register themselves on import
            import importlib

            importlib.import_module(_LAZY_PROVIDERS[scheme])
        try:
            factory = self._factories[scheme]
        except KeyError:
            raise ValueError(
                f"no KV backend registered for scheme '{scheme}' "
                f"(have {sorted(self._factories)})") from None
        return factory(rest, dim)


# schemes resolved on demand, without an import by the caller
_LAZY_PROVIDERS = {"tcp": "torchrec_tpu_torch.dynamic.tcp_kv"}

io_registry = IORegistry()
io_registry.register("file", EmbeddingKVStore)
io_registry.register("mem", _MemKV)


class KVBackedRows:
    """Array-like adapter: ``rows[logical_ids]`` reads through the KV
    (missing ids -> ``init_fn``, else a deterministic per-id init),
    ``rows[logical_ids] = values`` writes through."""

    def __init__(
        self,
        url: str,
        num_embeddings: int,
        dim: int,
        init_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        seed: int = 0,
    ):
        self.kv = io_registry.resolve(url, dim)
        self.shape = (num_embeddings, dim)
        self.dim = dim
        self._seed = seed
        self._init_fn = init_fn

    def _init_rows(self, ids: np.ndarray) -> np.ndarray:
        if self._init_fn is not None:
            return np.asarray(self._init_fn(ids), np.float32)
        # deterministic per-id init (stable across restarts and order)
        scale = 1.0 / np.sqrt(self.shape[0])
        out = np.empty((len(ids), self.dim), np.float32)
        for i, g in enumerate(ids):
            out[i] = np.random.RandomState(
                (self._seed * 1_000_003 + int(g)) & 0x7FFFFFFF
            ).uniform(-scale, scale, size=(self.dim,))
        return out

    def __getitem__(self, ids) -> np.ndarray:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        rows, found = self.kv.get(ids)
        if not found.all():
            rows[~found] = self._init_rows(ids[~found])
        return rows

    def __setitem__(self, ids, values) -> None:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        values = np.asarray(values, np.float32).reshape(len(ids), self.dim)
        self.kv.put(ids, values)

    def flush(self) -> None:
        pass  # every put is durable (append + fflush)


class ParameterServer:
    """Eviction / fetch coordinator of managed-collision tables.

    When managed collision EVICTS ids, their trained rows are persisted
    (:meth:`flush_evictions`) before the caller resets the rows; when an
    evicted id reappears on a fresh slot, :meth:`restore_assigned` writes
    its stored row back instead of a fresh init.  ``stores`` maps a table
    to its KV backend."""

    def __init__(self, stores: Dict[str, object]):
        self.stores = dict(stores)

    @staticmethod
    def from_urls(urls: Dict[str, str], dims: Dict[str, int]):
        return ParameterServer(
            {t: io_registry.resolve(u, dims[t]) for t, u in urls.items()})

    def flush_evictions(self, dmp, state, table: str, eviction) -> None:
        """Persist the evicted ids' trained rows.  The rows are read with
        ``dmp.gather_row_state`` on the current stream, after every update
        queued on it, and copied to the host before the put (each row from
        the rank that holds it: a collective at more than one rank, so
        every rank flushes every eviction)."""
        slots = np.asarray(eviction.slots, np.int64)
        if slots.size == 0:
            return
        trained = dmp.gather_row_state(state, table, slots)
        self.stores[table].put(
            np.asarray(eviction.global_ids, np.int64), trained)

    def restore_assigned(self, dmp, state, table: str,
                         global_ids: np.ndarray, slots: np.ndarray):
        """Write the stored rows of newly assigned ids into their rows of
        the live state (``dmp.set_table_rows``, in place); ids never stored
        keep their rows.  Returns the state."""
        global_ids = np.asarray(global_ids, np.int64)
        if global_ids.size == 0:
            return state
        rows, found = self.stores[table].get(global_ids)
        if not found.any():
            return state
        return dmp.set_table_rows(
            state, table, np.asarray(slots, np.int64)[found], rows[found])
