"""Dynamic streaming vocabulary: frequency-gated admission, TTL/LFU
eviction and a crash-safe id -> slot remap (``torchrec_tpu/dynamic/
vocab.py``, its host arithmetic and its on-disk formats kept byte for byte,
so either package reopens the other's journals and snapshots).

A fixed table's only answer to new users and items is to null-route
every unseen id forever.  :class:`DynamicVocab` owns the id -> slot remap
as the single source of truth shared by the training lookup, tiered
caches (gate mode) and serving replicas (:class:`VocabView`, fed by
``DeltaPublisher`` manifests):

* **Frequency-gated admission**: an unseen id earns a row only after
  ``admit_threshold`` sightings, estimated by a count-min sketch with a
  per-window Bloom filter deduplicating sightings inside a window.
  Pre-admission ids route to the reserved null slot 0 with an admitted
  mask of False, and the caller zeroes their pooling weights: the
  sanitize tier's semantics (``robustness/sanitize.py``), so un-admitted
  traffic changes nothing.  The sketch's and the Bloom filter's hashes
  are unsigned 64-bit numpy arithmetic, as in the JAX package: the same
  ids take the same buckets, and so the same admissions and slots.
* **TTL + LFU eviction**: rows idle past ``ttl_steps`` (swept at window
  rollover) or cold under the aged-LFU score ``count / max(1, step -
  last_seen) ** decay`` are written back through the KV backend
  (``dynamic/kv_store.py``) and their slots reclaimed to a sorted free
  list.  ``capacity`` is a hard bound: with nothing evictable (every
  resident in the current batch) admission defers.
* **Crash-safe growth**: an append-only admission/eviction journal with
  generation snapshots (tmp + fsync + atomic rename + dir fsync).  For
  base path P:

    ``P.g{N}``  immutable JSON snapshot of the full remap state
    ``P.j{N}``  append-only journal of the records since snapshot N, one
                CRC32-prefixed JSON line per committed record

  Reopening loads the newest snapshot and replays its journal,
  truncating a torn tail in place.  Admission records are journaled and
  fsynced before their slots reach the caller, and eviction write-backs
  are durable in the KV before the record frees the slot, so a kill at
  any instant leaves no orphaned or doubly assigned slot
  (:meth:`DynamicVocab.verify_consistency`).  The sketch and Bloom state
  is advisory and not journaled: a crash can only delay an admission.

The rows themselves live where the caller keeps them (the card's table
of a ``DistributedModelParallel``): :meth:`DynamicVocab.lookup` reads
the trained rows of the slots it evicts through the caller's
``row_reader`` and hands back the rows of the ids it admits
(:class:`VocabIO`), KV-restored or freshly initialized.  The default
init seeds one ``RandomState`` per admitted id, as the JAX package
does; ``init_fn`` replaces it with the caller's per-id init.

Threading: :meth:`DynamicVocab.lookup` (and every other mutator) is
called in stream order from one thread.  The internal lock only lets
concurrent readers (``scalar_metrics``, ``drain_events``) see
consistent state.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import os
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from torchrec_tpu_torch.dynamic.kv_store import io_registry
from torchrec_tpu_torch.utils.profiling import counter_key

_GEN_SEP = ".g"
_JRN_SEP = ".j"

#: the reserved null row every pre-admission (or invalid) id routes to
NULL_SLOT = 0


class VocabJournalError(RuntimeError):
    """The journal/snapshot state on disk is internally inconsistent
    (a record admits an occupied slot, evicts an unassigned id, ...).
    Torn TAILS are expected and truncated silently; a corrupt record
    BODY that still passes CRC framing means the writer was broken,
    and resuming from it would fork the remap."""


# ---------------------------------------------------------------------------
# sighting estimators (advisory — never journaled, see module docstring)
# ---------------------------------------------------------------------------


class CountMinSketch:
    """Conservative frequency estimator: ``depth`` rows of ``width``
    counters under independent multiply-shift hashes; an id's estimate
    is the MIN over its rows, so collisions only over-count (an id can
    be admitted early by a collision, never blocked late)."""

    def __init__(self, width: int = 1 << 14, depth: int = 4, seed: int = 7):
        if width < 1 or depth < 1:
            raise ValueError("sketch width/depth must be >= 1")
        self.width, self.depth = int(width), int(depth)
        rs = np.random.RandomState(seed)
        # odd multipliers decorrelate rows; uint64 arithmetic wraps
        self._a = (
            rs.randint(1, 1 << 31, size=self.depth).astype(np.uint64) * 2 + 1
        )
        self._b = rs.randint(0, 1 << 31, size=self.depth).astype(np.uint64)
        self.table = np.zeros((self.depth, self.width), np.uint32)

    def _buckets(self, ids: np.ndarray) -> np.ndarray:
        u = np.asarray(ids, np.int64).astype(np.uint64)
        h = u[None, :] * self._a[:, None] + self._b[:, None]
        return ((h >> np.uint64(17)) % np.uint64(self.width)).astype(
            np.int64
        )

    def add(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        pos = self._buckets(ids)
        for d in range(self.depth):
            np.add.at(self.table[d], pos[d], 1)

    def estimate(self, ids: np.ndarray) -> np.ndarray:
        if len(ids) == 0:
            return np.zeros((0,), np.int64)
        pos = self._buckets(ids)
        est = self.table[0, pos[0]].astype(np.int64)
        for d in range(1, self.depth):
            est = np.minimum(est, self.table[d, pos[d]].astype(np.int64))
        return est


class BloomWindow:
    """Per-window Bloom filter deduplicating sightings: an id repeated
    inside one window counts ONCE toward its sketch estimate, so a
    single hot batch cannot buy admission by itself.  ``reset()`` at
    window rollover opens the next counting window.

    ``bits``/``hashes`` size the filter (false-positive rate only —
    a collision can at worst DELAY a sighting, never corrupt state);
    ``seed`` derives the hash multipliers."""

    def __init__(self, bits: int = 1 << 16, hashes: int = 4, seed: int = 7):
        if bits < 8 or hashes < 1:
            raise ValueError("bloom bits must be >= 8, hashes >= 1")
        self.bits, self.hashes = int(bits), int(hashes)
        rs = np.random.RandomState(seed + 101)
        self._a = (
            rs.randint(1, 1 << 31, size=self.hashes).astype(np.uint64) * 2
            + 1
        )
        self._b = rs.randint(0, 1 << 31, size=self.hashes).astype(np.uint64)
        self._v = np.zeros((self.bits,), bool)

    def test_and_set(self, ids: np.ndarray) -> np.ndarray:
        """-> seen[n]: True where the id was (probably) already sighted
        this window; every id's bits are set afterwards."""
        if len(ids) == 0:
            return np.zeros((0,), bool)
        u = np.asarray(ids, np.int64).astype(np.uint64)
        h = u[None, :] * self._a[:, None] + self._b[:, None]
        pos = ((h >> np.uint64(13)) % np.uint64(self.bits)).astype(np.int64)
        seen = self._v[pos].all(axis=0)
        self._v[pos] = True
        return seen

    def reset(self) -> None:
        self._v[:] = False


# ---------------------------------------------------------------------------
# journal framing
# ---------------------------------------------------------------------------


def _encode_record(rec: dict) -> bytes:
    """One committed record = ``crc32:08x SP json NL`` where the CRC
    covers the json bytes — a torn/garbled line fails the CRC and marks
    the end of the committed prefix."""
    body = json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()
    return ("%08x " % (zlib.crc32(body) & 0xFFFFFFFF)).encode() + body + b"\n"


def _decode_record(line: bytes) -> Optional[dict]:
    """Record for a well-framed line, None for a torn/corrupt one."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    body = line[9:]
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        return None
    try:
        rec = json.loads(body.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


# ---------------------------------------------------------------------------
# the per-lookup IO plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VocabIO:
    """Row maintenance owed by the caller after one :meth:`lookup`:
    write ``fetch_rows`` into the table at ``admitted_slots`` (KV-
    restored trained values for readmitted ids, deterministic init for
    brand-new ones), and optionally clear ``evicted_slots`` (their
    trained rows are already durable in the KV when a ``row_reader``
    was supplied)."""

    admitted_ids: np.ndarray
    admitted_slots: np.ndarray
    fetch_rows: Optional[np.ndarray]
    evicted_ids: np.ndarray
    evicted_slots: np.ndarray


@dataclasses.dataclass
class _Plan:
    """One lookup's state delta, computed before any I/O so the journal
    can commit it before the in-memory remap exposes it."""

    step: int
    admit_ids: np.ndarray
    admit_slots: np.ndarray
    admit_counts: np.ndarray
    admit_first_seen: np.ndarray
    evict_ids: np.ndarray
    evict_slots: np.ndarray
    records: List[dict]
    deferred: int
    n_ttl: int
    n_lfu: int


_E64 = np.zeros((0,), np.int64)


# ---------------------------------------------------------------------------
# DynamicVocab
# ---------------------------------------------------------------------------


class DynamicVocab:
    """A bounded, journaled id->slot remap (see module docstring).

    ``capacity`` counts slots INCLUDING the reserved null slot 0, so at
    most ``capacity - 1`` ids are resident at once.  ``kv_url`` names
    the ``io_registry`` backend evicted rows write back through (None =
    gate mode: the caller owns row storage — e.g. a TieredTable host
    tier — and the vocab only gates/journals the id set).
    ``window_steps`` sizes the Bloom dedup window; a ``ttl_steps`` of 0
    disables TTL (LFU pressure alone reclaims slots).

    ``name`` labels metrics/journal records; ``dim`` is the row width
    written back through the KV; ``journal_path`` is the snapshot +
    journal file prefix (``P.gN`` / ``P.jN``); ``admit_threshold`` is K
    distinct-window sightings before a row is earned; ``decay`` ages
    the LFU score (count / idle**decay); ``sketch_width`` /
    ``sketch_depth`` size the count-min sketch and ``bloom_bits`` /
    ``bloom_hashes`` the per-window Bloom (both advisory: collisions
    can only delay admission); ``seed`` fixes hashes + row init;
    ``keep_generations`` bounds retained snapshot/journal generations
    (and therefore how far back a checkpoint pin can reach);
    ``init_fn`` overrides the deterministic per-id row init for
    brand-new admissions; ``max_tracked_candidates`` bounds the
    first-seen latency-tracking map (advisory, default 4*capacity).
    """

    def __init__(  # graft-check: disable=ctor-too-wide
        self,
        name: str,
        capacity: int,
        dim: int,
        journal_path: str,
        admit_threshold: int = 2,
        ttl_steps: int = 0,
        window_steps: int = 64,
        decay: float = 1.0,
        kv_url: Optional[str] = None,
        sketch_width: int = 1 << 14,
        sketch_depth: int = 4,
        bloom_bits: int = 1 << 16,
        bloom_hashes: int = 4,
        seed: int = 7,
        keep_generations: int = 2,
        init_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        max_tracked_candidates: Optional[int] = None,
    ):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (slot 0 is the null row)")
        if admit_threshold < 1:
            raise ValueError("admit_threshold must be >= 1")
        if window_steps < 1:
            raise ValueError("window_steps must be >= 1")
        if keep_generations < 1:
            raise ValueError("keep_generations must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.path = journal_path
        self.admit_threshold = int(admit_threshold)
        self.ttl_steps = int(ttl_steps)
        self.window_steps = int(window_steps)
        self.decay = float(decay)
        self.keep_generations = int(keep_generations)
        self._seed = int(seed)
        self._init_fn = init_fn
        self._max_tracked = (
            int(max_tracked_candidates)
            if max_tracked_candidates is not None
            else 4 * self.capacity + 1024
        )
        self.kv = io_registry.resolve(kv_url, dim) if kv_url else None
        self.sketch = CountMinSketch(sketch_width, sketch_depth, seed)
        self.bloom = BloomWindow(bloom_bits, bloom_hashes, seed)
        self._lock = threading.RLock()
        # remap state — exactly what snapshots persist + journals replay
        self._assigned: Dict[int, int] = {}
        self._free: List[int] = list(range(1, self.capacity))  # sorted
        self._count: Dict[int, int] = {}
        self._last_seen: Dict[int, int] = {}
        self._step = -1
        self._window = -1
        # advisory state (admission-latency tracking, delta-stream feed)
        self._first_seen: Dict[int, int] = {}
        self._lat_sum = 0.0
        self._lat_n = 0
        self._events: List[dict] = []
        self._stats = {
            "lookup_count": 0,
            "hit_count": 0,
            "insert_count": 0,
            "eviction_count": 0,
            "evicted_ttl": 0,
            "evicted_lfu": 0,
            "null_routed": 0,
            "deferred": 0,
        }
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._jf = None
        self._sweep_tmp()
        gens = self._generations()
        if gens:
            self._load_state(self._read_snapshot(gens[-1]))
            self.generation = gens[-1]
            self._replay_journal(self._jrn_path(self.generation))
            self._jf = open(self._jrn_path(self.generation), "ab")
        else:
            # publish generation 1 immediately (the DiskStore
            # discipline): a kill before the first explicit snapshot
            # reopens to a consistent (empty) remap
            self.generation = 0
            self._snapshot()

    # -- snapshot/journal paths ---------------------------------------------

    def _gen_path(self, n: int) -> str:
        return f"{self.path}{_GEN_SEP}{n}"

    def _jrn_path(self, n: int) -> str:
        return f"{self.path}{_JRN_SEP}{n}"

    def _generations(self) -> Tuple[int, ...]:
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + _GEN_SEP
        out = []
        if not os.path.isdir(d):
            return ()
        for fname in os.listdir(d):
            if fname.startswith(base) and not fname.endswith(".tmp"):
                try:
                    out.append(int(fname[len(base):]))
                except ValueError:
                    continue
        return tuple(sorted(out))

    def _sweep_tmp(self) -> None:
        """Torn snapshot attempts (crash mid-publish) are never
        readable — remove them so they cannot accumulate."""
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + _GEN_SEP
        if not os.path.isdir(d):
            return
        for fname in os.listdir(d):
            if fname.startswith(base) and fname.endswith(".tmp"):
                try:
                    os.remove(os.path.join(d, fname))
                except OSError:
                    pass

    def _fsync_dir(self) -> None:
        d = os.path.dirname(self.path) or "."
        try:
            fd = os.open(d, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _prune(self) -> None:
        gens = self._generations()
        for g in gens[: -self.keep_generations]:
            for p in (self._gen_path(g), self._jrn_path(g)):
                try:
                    os.remove(p)
                except OSError:
                    pass

    # -- snapshot state -----------------------------------------------------

    def _state_dict(self) -> dict:
        rows = sorted(
            (
                int(g),
                int(s),
                int(self._count.get(g, 0)),
                int(self._last_seen.get(g, 0)),
            )
            for g, s in self._assigned.items()
        )
        return {
            "version": 1,
            "capacity": self.capacity,
            "dim": self.dim,
            "step": self._step,
            "window": self._window,
            "rows": rows,
            "free": list(self._free),
            "stats": dict(self._stats),
            "lat_sum": self._lat_sum,
            "lat_n": self._lat_n,
        }

    def _load_state(self, st: dict) -> None:
        if int(st.get("capacity", self.capacity)) != self.capacity:
            raise ValueError(
                f"vocab snapshot capacity {st.get('capacity')} does not "
                f"match configured capacity {self.capacity} — config "
                "changed?"
            )
        self._assigned = {}
        self._count = {}
        self._last_seen = {}
        for g, s, c, ls in st.get("rows", []):
            self._assigned[int(g)] = int(s)
            self._count[int(g)] = int(c)
            self._last_seen[int(g)] = int(ls)
        self._free = sorted(int(s) for s in st.get("free", []))
        self._step = int(st.get("step", -1))
        self._window = int(st.get("window", -1))
        self._stats.update(st.get("stats", {}))
        self._lat_sum = float(st.get("lat_sum", 0.0))
        self._lat_n = int(st.get("lat_n", 0))
        # advisory state does not survive a reload — see module docstring
        self._first_seen = {}
        self._events = []
        self.bloom.reset()

    def _read_snapshot(self, n: int) -> dict:
        with open(self._gen_path(n), "rb") as f:
            return json.loads(f.read().decode())

    def _snapshot(self) -> int:
        """Publish the current remap as the next immutable generation
        and start its (empty) journal; returns the generation number.
        Crash-safe at every point: the snapshot only becomes visible at
        the atomic rename, and the new journal is truncate-created
        BEFORE the rename so a stale journal can never be replayed
        against a snapshot it does not belong to."""
        with self._lock:
            blob = (
                json.dumps(self._state_dict(), sort_keys=True) + "\n"
            ).encode()
            nxt = self.generation + 1
        tmp = self._gen_path(nxt) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        with open(self._jrn_path(nxt), "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._gen_path(nxt))
        self._fsync_dir()
        old = None
        with self._lock:
            old, self._jf = self._jf, None
            self.generation = nxt
        if old is not None:
            old.close()
        jf = open(self._jrn_path(nxt), "ab")
        with self._lock:
            self._jf = jf
        self._prune()
        return nxt

    # -- journal ------------------------------------------------------------

    def _append_records(self, records: List[dict]) -> None:
        """Group-commit the records: one write + one fsync per lookup.
        A record is COMMITTED once this returns — a kill before the
        fsync loses the whole tail (the in-memory claims die with the
        process), never a torn prefix.  Separate method so the chaos
        matrix can kill inside the flush window."""
        if not records:
            return
        buf = b"".join(_encode_record(r) for r in records)
        self._jf.write(buf)
        self._jf.flush()
        os.fsync(self._jf.fileno())

    def _apply_record(self, rec: dict) -> None:
        try:
            op = rec["op"]
            gid = int(rec["id"])
            slot = int(rec["slot"])
        except (KeyError, TypeError, ValueError):
            raise VocabJournalError(f"malformed journal record {rec!r}")
        if not (0 < slot < self.capacity):
            raise VocabJournalError(
                f"journal record {rec!r}: slot outside (0, {self.capacity})"
            )
        if op == "admit":
            if gid in self._assigned:
                raise VocabJournalError(
                    f"journal admits already-resident id {gid}"
                )
            i = bisect.bisect_left(self._free, slot)
            if i >= len(self._free) or self._free[i] != slot:
                raise VocabJournalError(
                    f"journal admits id {gid} to occupied slot {slot}"
                )
            self._free.pop(i)
            self._assigned[gid] = slot
            self._count[gid] = int(rec.get("count", self.admit_threshold))
            self._last_seen[gid] = int(rec.get("step", 0))
        elif op == "evict":
            if self._assigned.get(gid) != slot:
                raise VocabJournalError(
                    f"journal evicts id {gid} from slot {slot} it does "
                    "not hold"
                )
            del self._assigned[gid]
            self._count.pop(gid, None)
            self._last_seen.pop(gid, None)
            bisect.insort(self._free, slot)
        else:
            raise VocabJournalError(f"unknown journal op {op!r}")
        self._step = max(self._step, int(rec.get("step", self._step)))

    def _replay_journal(self, path: str) -> None:
        """Apply the committed prefix of a journal; the torn tail (a
        kill mid-flush) is truncated IN PLACE so later appends keep the
        file parseable."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        good = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break
            rec = _decode_record(data[pos:nl])
            if rec is None:
                break
            self._apply_record(rec)
            pos = nl + 1
            good = pos
        if good < len(data):
            with open(path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
        self._window = (
            self._step // self.window_steps if self._step >= 0 else -1
        )

    # -- KV row traffic -----------------------------------------------------

    def _init_rows(self, ids: np.ndarray) -> np.ndarray:
        """Deterministic per-GLOBAL-id init (the ``KVBackedRows`` idiom):
        stable across restarts, admission order, and slot placement —
        the property the oracle bit-exactness proof rests on."""
        if self._init_fn is not None:
            return np.asarray(self._init_fn(ids), np.float32)
        scale = 1.0 / np.sqrt(self.capacity)
        out = np.empty((len(ids), self.dim), np.float32)
        for i, g in enumerate(ids):
            out[i] = np.random.RandomState(
                (self._seed * 1_000_003 + int(g)) & 0x7FFFFFFF
            ).uniform(-scale, scale, size=(self.dim,))
        return out

    def _fetch_rows(self, ids: np.ndarray) -> np.ndarray:
        """Rows for freshly admitted ids: KV-stored trained values for
        readmitted ids, deterministic init for brand-new ones."""
        ids = np.asarray(ids, np.int64)
        if self.kv is not None:
            rows, found = self.kv.get(ids)
            if not found.all():
                rows[~found] = self._init_rows(ids[~found])
            return rows
        return self._init_rows(ids)

    def _kv_writeback(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Persist evicted rows — durable BEFORE the eviction records
        free their slots in the journal, so no committed eviction can
        lose a trained row.  Separate method so the chaos matrix can
        kill inside the write-back window."""
        if self.kv is None or rows is None:
            return
        self.kv.put(np.asarray(ids, np.int64), np.asarray(rows, np.float32))

    # -- the lookup ---------------------------------------------------------

    def lookup(
        self,
        ids: np.ndarray,
        step: Optional[int] = None,
        row_reader: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, VocabIO]:
        """Remap one batch of raw ids -> (slots, admitted, io).

        ``slots[i]`` is the id's resident slot, or ``NULL_SLOT`` with
        ``admitted[i] == False`` for pre-admission / negative ids (the
        caller must zero their pooling weights — sanitize semantics).
        ``step`` advances the internal clock when given (must be
        monotonic); None auto-increments.  ``row_reader(slots) ->
        rows [k, dim]`` supplies the CURRENT trained rows of slots
        about to be evicted for the KV write-back; without it (or
        without a KV) evictions journal but persist nothing.

        MUST be called in stream order from one thread (see module
        docstring); the journal fsync and KV round-trips run outside
        the metrics lock."""
        ids = np.atleast_1d(np.asarray(ids, np.int64)).ravel()
        with self._lock:
            plan, uids, inverse = self._plan(ids, step)
        if plan.evict_ids.size and self.kv is not None and (
            row_reader is not None
        ):
            rows = np.asarray(
                row_reader(plan.evict_slots), np.float32
            ).reshape(len(plan.evict_slots), self.dim)
            self._kv_writeback(plan.evict_ids, rows)
        # fetch BEFORE the journal commit: a KV failure here must leave
        # nothing journaled (the plan's advisory sketch updates are the
        # only trace, and those can at most delay a future admission)
        fetch = (
            self._fetch_rows(plan.admit_ids) if plan.admit_ids.size else None
        )
        try:
            self._append_records(plan.records)
        except Exception:
            # the bytes may have reached the disk before the failure
            # (e.g. the fsync raised): commit in-memory anyway so this
            # process can never journal records that contradict a
            # possibly-durable prefix, then surface the I/O error
            with self._lock:
                self._commit(plan, ids, uids, inverse)
            raise
        with self._lock:
            slots, admitted = self._commit(plan, ids, uids, inverse)
        io = VocabIO(
            admitted_ids=plan.admit_ids,
            admitted_slots=plan.admit_slots,
            fetch_rows=fetch,
            evicted_ids=plan.evict_ids,
            evicted_slots=plan.evict_slots,
        )
        return slots, admitted, io

    def admit_filter(
        self, ids: np.ndarray, step: Optional[int] = None
    ) -> np.ndarray:
        """Gate mode (TieredCollection): advance the admission state
        and return only the admitted mask — the caller owns slots and
        rows; the vocab owns WHICH ids exist."""
        _slots, admitted, _io = self.lookup(ids, step=step)
        return admitted

    def _plan(
        self, ids: np.ndarray, step: Optional[int]
    ) -> Tuple[_Plan, np.ndarray, np.ndarray]:
        if step is None:
            self._step += 1
        else:
            s = int(step)
            if s < self._step:
                raise ValueError(
                    f"vocab step {s} moved backwards (at {self._step}) — "
                    "lookups must run in stream order"
                )
            self._step = s
        now = self._step
        uids, inverse = np.unique(ids, return_inverse=True)
        valid = uids >= 0
        batch_set = set(int(g) for g in uids[valid])
        # sightings for resident ids (count once per lookup per id)
        resident = np.array(
            [bool(v) and int(g) in self._assigned
             for g, v in zip(uids, valid)],
            bool,
        )
        for g in uids[resident]:
            gi = int(g)
            self._count[gi] = self._count.get(gi, 0) + 1
            self._last_seen[gi] = now
        # window rollover: reset the Bloom dedup, sweep TTL-idle rows
        # (current-batch residents just refreshed last_seen, so the
        # sweep can never evict an id the same lookup returns)
        ttl_pairs: List[Tuple[int, int]] = []
        w = now // self.window_steps
        if w != self._window:
            self._window = w
            self.bloom.reset()
            if self.ttl_steps > 0:
                for gi in sorted(self._assigned):
                    if now - self._last_seen.get(gi, now) > self.ttl_steps:
                        ttl_pairs.append((gi, self._assigned[gi]))
        # candidate sightings: Bloom-deduped within the window, then
        # count-min estimated against the admission threshold
        cand = uids[valid & ~resident]
        admissible: List[int] = []
        if cand.size:
            fresh = ~self.bloom.test_and_set(cand)
            self.sketch.add(cand[fresh])
            est = self.sketch.estimate(cand)
            for g, e in zip(cand, est):
                gi = int(g)
                if gi not in self._first_seen and (
                    len(self._first_seen) < self._max_tracked
                ):
                    self._first_seen[gi] = now
                if e >= self.admit_threshold:
                    admissible.append(gi)
        admissible.sort()
        admit_counts = {
            gi: int(e)
            for gi, e in zip(
                (int(g) for g in cand),
                self.sketch.estimate(cand) if cand.size else (),
            )
        }
        # capacity: free slots + TTL-freed slots, then LFU pressure on
        # residents OUTSIDE the current batch; with nothing evictable
        # the admission tail defers (deterministic: ascending id order)
        avail = len(self._free) + len(ttl_pairs)
        lfu_pairs: List[Tuple[int, int]] = []
        need = len(admissible) - avail
        if need > 0:
            ttl_ids = set(g for g, _ in ttl_pairs)
            scored = []
            for gi, slot in self._assigned.items():
                if gi in batch_set or gi in ttl_ids:
                    continue
                age = max(1, now - self._last_seen.get(gi, 0))
                score = self._count.get(gi, 0) / (age ** self.decay)
                scored.append((score, self._last_seen.get(gi, 0), gi, slot))
            scored.sort()
            lfu_pairs = [(gi, slot) for _, _, gi, slot in scored[:need]]
        deferred = max(
            0, len(admissible) - (avail + len(lfu_pairs))
        )
        if deferred:
            admissible = admissible[: len(admissible) - deferred]
        pool = sorted(
            self._free
            + [s for _, s in ttl_pairs]
            + [s for _, s in lfu_pairs]
        )
        admit_slots = pool[: len(admissible)]
        records: List[dict] = []
        for reason, pairs in (("ttl", ttl_pairs), ("lfu", lfu_pairs)):
            for gi, slot in pairs:
                records.append(
                    {
                        "op": "evict",
                        "id": gi,
                        "slot": slot,
                        "step": now,
                        "reason": reason,
                        "count": int(self._count.get(gi, 0)),
                        "last_seen": int(self._last_seen.get(gi, 0)),
                    }
                )
        first_seen = [self._first_seen.get(gi, now) for gi in admissible]
        for gi, slot, fs in zip(admissible, admit_slots, first_seen):
            records.append(
                {
                    "op": "admit",
                    "id": gi,
                    "slot": slot,
                    "step": now,
                    "count": admit_counts.get(gi, self.admit_threshold),
                    "first_seen": fs,
                }
            )
        evict_pairs = ttl_pairs + lfu_pairs
        plan = _Plan(
            step=now,
            admit_ids=np.asarray(admissible, np.int64),
            admit_slots=np.asarray(admit_slots, np.int64),
            admit_counts=np.asarray(
                [admit_counts.get(gi, self.admit_threshold)
                 for gi in admissible],
                np.int64,
            ),
            admit_first_seen=np.asarray(first_seen, np.int64),
            evict_ids=(
                np.asarray([g for g, _ in evict_pairs], np.int64)
                if evict_pairs
                else _E64
            ),
            evict_slots=(
                np.asarray([s for _, s in evict_pairs], np.int64)
                if evict_pairs
                else _E64
            ),
            records=records,
            deferred=deferred,
            n_ttl=len(ttl_pairs),
            n_lfu=len(lfu_pairs),
        )
        return plan, uids, inverse

    def _commit(
        self,
        plan: _Plan,
        ids: np.ndarray,
        uids: np.ndarray,
        inverse: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        for gi in plan.evict_ids.tolist():
            del self._assigned[gi]
            self._count.pop(gi, None)
            self._last_seen.pop(gi, None)
        # the evicted slots join the sorted free list, and the admissions
        # take its head: the plan gave them the lowest slots of that pool
        # (the JAX package's per-slot insort and pops, as one merge and
        # one slice: the same list)
        if plan.evict_slots.size:
            self._free = list(heapq.merge(
                self._free, sorted(plan.evict_slots.tolist())))
        k = len(plan.admit_slots)
        assert self._free[:k] == plan.admit_slots.tolist(), (
            plan.admit_slots[:8])
        del self._free[:k]
        for gi, slot, c, fs in zip(
            plan.admit_ids,
            plan.admit_slots,
            plan.admit_counts,
            plan.admit_first_seen,
        ):
            gi, slot = int(gi), int(slot)
            self._assigned[gi] = slot
            self._count[gi] = int(c)
            self._last_seen[gi] = plan.step
            self._first_seen.pop(gi, None)
            self._lat_sum += float(plan.step - int(fs))
            self._lat_n += 1
        self._events.extend(plan.records)
        uslots = np.zeros((len(uids),), np.int64)
        uadm = np.zeros((len(uids),), bool)
        for i, g in enumerate(uids):
            s = self._assigned.get(int(g))
            if s is not None:
                uslots[i] = s
                uadm[i] = True
        slots = uslots[inverse]
        admitted = uadm[inverse]
        st = self._stats
        st["lookup_count"] += len(ids)
        st["hit_count"] += int(admitted.sum()) - int(
            np.isin(ids, plan.admit_ids).sum() if plan.admit_ids.size else 0
        )
        st["insert_count"] += len(plan.admit_ids)
        st["eviction_count"] += len(plan.evict_ids)
        st["evicted_ttl"] += plan.n_ttl
        st["evicted_lfu"] += plan.n_lfu
        st["null_routed"] += int((~admitted).sum())
        st["deferred"] += plan.deferred
        return slots, admitted

    # -- checkpoint/restore -------------------------------------------------

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        """Pin the remap for a checkpoint payload: publish a fresh
        snapshot and return its generation (the ``TieredTable``
        contract — ``keep_generations`` must cover the checkpoint
        retention window)."""
        return {"generation": np.int64(self._snapshot())}

    def restore_checkpoint_state(self, st: Dict[str, np.ndarray]) -> None:
        self.load_generation(int(st["generation"]))

    def load_generation(self, n: int) -> None:
        """Restore the remap to snapshot ``n`` EXACTLY — no journal
        replay: the checkpoint pinned this state, and records journaled
        after it belong to a future the rollback is abandoning.  The
        restored state is immediately republished as a NEW generation
        (past the newest on disk) with a fresh journal, so the rollback
        itself is crash-safe and never overwrites a snapshot another
        checkpoint may pin."""
        src = self._gen_path(int(n))
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"vocab generation {n} at {src} is missing — pruned by a "
                f"later snapshot?  Raise keep_generations (now "
                f"{self.keep_generations}) to cover the checkpoint "
                "retention window."
            )
        st = self._read_snapshot(int(n))
        with self._lock:
            self._load_state(st)
            gens = self._generations()
            self.generation = max(gens) if gens else int(n)
        self._snapshot()

    # -- consistency / introspection ----------------------------------------

    def verify_consistency(self) -> None:
        """Machine-checkable crash-consistency statement: every slot is
        either the null row, exactly one id's, or free — no orphans, no
        double assignment.  Raises ``VocabJournalError`` on violation
        (the chaos matrix calls this after every kill+reopen)."""
        with self._lock:
            slots = list(self._assigned.values())
            sset = set(slots)
            if len(slots) != len(sset):
                raise VocabJournalError("a slot is assigned to two ids")
            if NULL_SLOT in sset:
                raise VocabJournalError("the null slot is assigned")
            fset = set(self._free)
            if len(fset) != len(self._free):
                raise VocabJournalError("duplicate slot in the free list")
            if sset & fset:
                raise VocabJournalError(
                    f"slots {sorted(sset & fset)} both free and assigned"
                )
            universe = set(range(1, self.capacity))
            orphans = universe - sset - fset
            if orphans or (sset | fset) - universe:
                raise VocabJournalError(
                    f"orphaned slots {sorted(orphans)} / out-of-range "
                    f"slots {sorted((sset | fset) - universe)}"
                )

    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._assigned)

    def assigned_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, slots) of every resident id, ascending by id."""
        with self._lock:
            items = sorted(self._assigned.items())
        ids = np.asarray([g for g, _ in items], np.int64)
        slots = np.asarray([s for _, s in items], np.int64)
        return ids, slots

    def drain_events(self) -> List[dict]:
        """Admission/eviction records accumulated since the last drain
        (the ``DeltaPublisher`` feed — replicas advance their
        :class:`VocabView` by exactly these)."""
        with self._lock:
            ev, self._events = self._events, []
        return ev

    def scalar_metrics(self, prefix: str = "vocab") -> Dict[str, float]:
        """Flat per-table counters in the unified
        ``<prefix>/<table>/<counter>`` namespace; the counter names the
        MPZCH modules export (lookup/hit/insert/eviction/occupancy) are
        reused so the health monitor's churn signal reads both families
        through one code path."""
        with self._lock:
            st = dict(self._stats)
            occ = len(self._assigned)
            free = len(self._free)
            lat = self._lat_sum / self._lat_n if self._lat_n else 0.0
            gen = self.generation
        t = self.name
        out = {
            counter_key(prefix, t, "lookup_count"): float(
                st["lookup_count"]
            ),
            counter_key(prefix, t, "hit_count"): float(st["hit_count"]),
            counter_key(prefix, t, "insert_count"): float(
                st["insert_count"]
            ),
            counter_key(prefix, t, "eviction_count"): float(
                st["eviction_count"]
            ),
            counter_key(prefix, t, "occupancy"): float(occ),
            counter_key(prefix, t, "occupancy_rate"): float(occ) / max(
                1, self.capacity - 1
            ),
            counter_key(prefix, t, "free_slots"): float(free),
            counter_key(prefix, t, "evicted_ttl_total"): float(
                st["evicted_ttl"]
            ),
            counter_key(prefix, t, "evicted_lfu_total"): float(
                st["evicted_lfu"]
            ),
            counter_key(prefix, t, "null_routed_total"): float(
                st["null_routed"]
            ),
            counter_key(prefix, t, "admission_deferred_total"): float(
                st["deferred"]
            ),
            counter_key(prefix, t, "admission_latency_steps"): float(lat),
            counter_key(prefix, t, "generation"): float(gen),
        }
        if st["lookup_count"]:
            out[counter_key(prefix, t, "hit_rate")] = (
                st["hit_count"] / st["lookup_count"]
            )
        return out

    def close(self) -> None:
        with self._lock:
            jf, self._jf = self._jf, None
        if jf is not None:
            jf.close()
        if self.kv is not None:
            try:
                self.kv.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# replica-side mirror
# ---------------------------------------------------------------------------


class VocabView:
    """Serving-replica mirror of a :class:`DynamicVocab` remap,
    advanced by the admission/eviction records a ``DeltaPublisher``
    manifest carries — replicas learn new ids without a republish.

    :meth:`apply_events` is all-or-nothing: the whole batch validates
    on a copy (range, double-assignment, evict-of-unheld) before the
    swap, and returns the pre-image for the subscriber's bit-exact
    rollback (:meth:`restore`).  Views must descend from the same
    checkpoint lineage as the publisher (a late joiner bootstraps from
    a checkpoint, exactly like delta rows).  ``capacity`` must match
    the publisher-side vocab (slot 0 stays the null row)."""

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.capacity = int(capacity)
        self._assigned: Dict[int, int] = {}

    def apply_events(self, events: List[dict]) -> Dict[int, int]:
        new = dict(self._assigned)
        rev = {s: g for g, s in new.items()}
        for rec in events:
            if not isinstance(rec, dict):
                raise ValueError(f"malformed vocab event {rec!r}")
            op = rec.get("op")
            try:
                gid = int(rec["id"])
                slot = int(rec["slot"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"malformed vocab event {rec!r}")
            if not (0 < slot < self.capacity):
                raise ValueError(
                    f"vocab event slot {slot} outside (0, {self.capacity})"
                )
            if op == "admit":
                if rev.get(slot, gid) != gid:
                    raise ValueError(
                        f"event admits id {gid} to occupied slot {slot}"
                    )
                if new.get(gid, slot) != slot:
                    raise ValueError(
                        f"event admits resident id {gid} to a second slot"
                    )
                new[gid] = slot
                rev[slot] = gid
            elif op == "evict":
                if new.get(gid) != slot:
                    raise ValueError(
                        f"event evicts id {gid} from slot {slot} it does "
                        "not hold"
                    )
                del new[gid]
                del rev[slot]
            else:
                raise ValueError(f"unknown vocab event op {op!r}")
        prev, self._assigned = self._assigned, new
        return prev

    def restore(self, token: Dict[int, int]) -> None:
        self._assigned = dict(token)

    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.atleast_1d(np.asarray(ids, np.int64)).ravel()
        slots = np.zeros((len(ids),), np.int64)
        admitted = np.zeros((len(ids),), bool)
        for i, g in enumerate(ids):
            s = self._assigned.get(int(g))
            if s is not None:
                slots[i] = s
                admitted[i] = True
        return slots, admitted

    @property
    def occupancy(self) -> int:
        return len(self._assigned)


# ---------------------------------------------------------------------------
# the collection
# ---------------------------------------------------------------------------


class DynamicVocabCollection:
    """Per-table :class:`DynamicVocab` set with the collection-level
    surfaces the rest of the stack expects: ``checkpoint_payload`` /
    ``checkpoint_restore`` (checkpoint.py ``vocab=`` wiring),
    ``drain_events`` (the train loop's delta-publisher feed), and
    ``scalar_metrics`` (telemetry).  ``vocabs`` maps table name ->
    :class:`DynamicVocab`; ``feature_to_table`` optionally records the
    feature routing for callers that resolve vocabs by feature."""

    def __init__(
        self,
        vocabs: Dict[str, DynamicVocab],
        feature_to_table: Optional[Dict[str, str]] = None,
    ):
        self.tables = dict(vocabs)
        self.feature_to_table = dict(feature_to_table or {})

    def checkpoint_payload(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {t: v.checkpoint_state() for t, v in self.tables.items()}

    def checkpoint_restore(
        self, payload: Optional[Dict[str, Dict[str, np.ndarray]]]
    ) -> None:
        if payload is None:
            raise ValueError(
                "checkpoint has no vocab payload — it was saved without "
                "the vocab collection wired into the Checkpointer "
                "(vocab=...)"
            )
        missing = set(self.tables) - set(payload)
        if missing:
            raise ValueError(
                f"checkpoint is missing vocab tables {sorted(missing)}"
            )
        for t, v in self.tables.items():
            v.restore_checkpoint_state(payload[t])

    def drain_events(self) -> Dict[str, List[dict]]:
        out = {}
        for t, v in self.tables.items():
            ev = v.drain_events()
            if ev:
                out[t] = ev
        return out

    def scalar_metrics(self, prefix: str = "vocab") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for v in self.tables.values():
            out.update(v.scalar_metrics(prefix))
        return out

    def verify_consistency(self) -> None:
        for v in self.tables.values():
            v.verify_consistency()

    def close(self) -> None:
        for v in self.tables.values():
            v.close()
