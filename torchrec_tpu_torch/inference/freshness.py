"""Crash-safe train -> serve embedding-delta stream
(``torchrec_tpu/inference/freshness.py``, its on-disk format byte for
byte, so each package adopts the other's generations).

Embeddings go stale in hours; a replica that learns new rows only on a
restart serves yesterday's model.  This module streams changed rows from
the trainer to live replicas with the checkpoint's torn-write discipline
(tmp file, fsync, atomic ``os.replace``, directory fsync): a publisher
killed at any point leaves the previous generation serving bit-exactly.

Layout under the delta directory (every write an atomic publish):

  ``delta.g{N}.{table}.chunk`` : one table's changed rows of generation N,
                                 a binary frame (magic, header json, ids
                                 int64, rows f32) whose byte count and
                                 CRC32 the manifest records;
  ``manifest.g{N}.json``       : generation N's table of contents (step,
                                 each table's chunk name, bytes, crc32
                                 and shape, and the vocabularies'
                                 admission/eviction events), written
                                 after the chunks;
  ``CURRENT``                  : one json line naming the newest
                                 adoptable generation; subscribers read
                                 only this pointer.

Publish (:class:`DeltaPublisher`): chunks -> manifest -> CURRENT, each tmp
+ rename; a crash before the manifest leaves invisible chunks, a crash
before CURRENT a generation nobody adopts until the next publish.

Adopt (:class:`DeltaSubscriber`): read CURRENT; for a new generation,
verify every chunk (size, CRC32, frame, id range, row shape) into memory
first, and only then apply: the host tier through
``TieredTable.write_weight_rows`` (weights only; packed optimizer slots
survive), then ``HotRowServingCache.refresh_rows``, so the resident
copies on the card agree without a restart.  Any failure rolls the whole
generation back (``freshness/<table>/rollback_count``) and the old rows
keep serving bit-exactly.  ``freshness/<table>/staleness_steps`` is the
published step minus the applied one.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.utils.profiling import counter_key

__all__ = [
    "DeltaPublisher",
    "DeltaSubscriber",
    "CURRENT_NAME",
]

CURRENT_NAME = "CURRENT"
_MAGIC = b"TRDELTA1"


class _DeltaVerifyError(ValueError):
    """One table's chunk failed integrity verification; carries the
    TABLE NAME as data so rollback attribution never depends on
    parsing the human-readable message."""

    def __init__(self, table: str, msg: str):
        super().__init__(msg)
        self.table = table


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_bytes(path: str, payload: bytes) -> None:
    """tmp + fsync + os.replace + dir fsync — the repo-wide atomic
    publish recipe (DiskStore.flush / Checkpointer._commit)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _encode_chunk(
    table: str, gen: int, step: int, ids: np.ndarray, rows: np.ndarray
) -> bytes:
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    rows = np.ascontiguousarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[0] != len(ids):
        raise ValueError(
            f"delta for table {table}: rows shape {rows.shape} does not "
            f"match {len(ids)} ids"
        )
    header = json.dumps(
        {
            "table": table,
            "generation": int(gen),
            "step": int(step),
            "rows": int(len(ids)),
            "dim": int(rows.shape[1]),
        }
    ).encode()
    return b"".join(
        [
            _MAGIC,
            np.uint32(len(header)).tobytes(),
            header,
            ids.tobytes(),
            rows.tobytes(),
        ]
    )


def _decode_chunk(payload: bytes) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Parse one chunk frame; raises ValueError on any structural
    problem (the subscriber converts that into a rollback)."""
    if payload[: len(_MAGIC)] != _MAGIC:
        raise ValueError("bad delta chunk magic")
    off = len(_MAGIC)
    (hlen,) = np.frombuffer(payload[off : off + 4], np.uint32)
    off += 4
    header = json.loads(payload[off : off + int(hlen)].decode())
    off += int(hlen)
    k, d = int(header["rows"]), int(header["dim"])
    need = off + k * 8 + k * d * 4
    if len(payload) != need:
        raise ValueError(
            f"delta chunk truncated: {len(payload)} bytes, header "
            f"promises {need}"
        )
    ids = np.frombuffer(payload[off : off + k * 8], np.int64)
    off += k * 8
    rows = np.frombuffer(payload[off:], np.float32).reshape(k, d)
    return header, ids, rows


class DeltaPublisher:
    """Trainer-side publisher of embedding-row deltas (see the module
    docstring for the chunks → manifest → CURRENT protocol).

    ``directory`` is the delta stream's home (created if absent);
    ``keep_generations`` bounds on-disk history — a subscriber lagging
    further than that re-syncs from a full snapshot path (checkpoint),
    exactly like ``DiskStore`` generation retention."""

    def __init__(self, directory: str, keep_generations: int = 2):
        if keep_generations < 1:
            raise ValueError("keep_generations must be >= 1")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_generations = int(keep_generations)
        self._sweep_tmp()
        self.generation = self._published_generation()

    # -- discovery -----------------------------------------------------------

    def _current_path(self) -> str:
        return os.path.join(self.directory, CURRENT_NAME)

    def _manifest_path(self, gen: int) -> str:
        return os.path.join(self.directory, f"manifest.g{gen}.json")

    def _chunk_name(self, gen: int, table: str) -> str:
        return f"delta.g{gen}.{table}.chunk"

    def _published_generation(self) -> int:
        """The newest ADOPTABLE generation (what CURRENT names); a
        fresh/never-published directory is generation 0.  Numbering
        continues past any orphaned manifest a crashed publisher left,
        so a republish can never collide with torn wreckage."""
        gen = 0
        try:
            with open(self._current_path(), encoding="utf-8") as f:
                gen = int(json.load(f)["generation"])
        except (OSError, ValueError, KeyError):
            gen = 0
        for name in os.listdir(self.directory):
            if name.startswith("manifest.g") and name.endswith(".json"):
                try:
                    gen = max(gen, int(name[len("manifest.g"):-len(".json")]))
                except ValueError:
                    continue
        return gen

    def _sweep_tmp(self) -> None:
        """Torn tmp files from a crashed publish are never readable —
        remove them so they cannot accumulate."""
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    # -- publish -------------------------------------------------------------

    def publish(
        self,
        step: int,
        deltas: Mapping[str, Tuple[np.ndarray, np.ndarray]],
        vocab_events: Optional[Mapping[str, list]] = None,
    ) -> int:
        """Publish one generation of changed rows: ``deltas`` maps
        table name -> ``(ids [k], weight rows [k, D])``.  Returns the
        new generation number.  Crash-safe at every point: only the
        final CURRENT rename makes the generation adoptable.

        ``vocab_events`` optionally maps table name -> the dynamic-
        vocab admission/eviction records drained since the last publish
        (``DynamicVocabCollection.drain_events``); they ride in the
        manifest itself (small, ordered, CRC-guarded) so replicas learn
        new ids without a republish."""
        gen = self.generation + 1
        entries: Dict[str, dict] = {}
        for table in sorted(deltas):
            ids, rows = deltas[table]
            payload = _encode_chunk(table, gen, step, ids, rows)
            name = self._chunk_name(gen, table)
            self._write_chunk(os.path.join(self.directory, name), payload)
            entries[table] = {
                "file": name,
                "rows": int(np.asarray(ids).size),
                "dim": int(np.asarray(rows).shape[1]),
                "bytes": len(payload),
                "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
            }
        manifest = {"generation": gen, "step": int(step), "tables": entries}
        vocab_entries: Dict[str, dict] = {}
        for table in sorted(vocab_events or {}):
            events = list((vocab_events or {})[table])
            if not events:
                continue
            body = json.dumps(events, sort_keys=True, separators=(",", ":"))
            vocab_entries[table] = {
                "events": events,
                "count": len(events),
                "crc32": zlib.crc32(body.encode()) & 0xFFFFFFFF,
            }
        if vocab_entries:
            manifest["vocab"] = vocab_entries
        self._write_manifest(gen, manifest)
        self._publish_current(gen, int(step))
        self.generation = gen
        self._prune()
        return gen

    # the three protocol stages are separate methods so the fault
    # injectors (reliability/fault_injection.py CrashMidPublish*) can
    # kill the publisher inside any single crash window

    def _write_chunk(self, path: str, payload: bytes) -> None:
        _atomic_write_bytes(path, payload)

    def _write_manifest(self, gen: int, manifest: dict) -> None:
        _atomic_write_bytes(
            self._manifest_path(gen),
            (json.dumps(manifest) + "\n").encode(),
        )

    def _publish_current(self, gen: int, step: int) -> None:
        _atomic_write_bytes(
            self._current_path(),
            (json.dumps({"generation": gen, "step": step}) + "\n").encode(),
        )

    def _prune(self) -> None:
        """Drop chunk+manifest files of generations older than the
        retention window (the adopted generation itself always stays)."""
        floor = self.generation - self.keep_generations + 1
        for name in os.listdir(self.directory):
            for prefix in ("manifest.g", "delta.g"):
                if not name.startswith(prefix):
                    continue
                tail = name[len(prefix):].split(".")[0]
                try:
                    g = int(tail)
                except ValueError:
                    continue
                if g < floor:
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except OSError:
                        pass


class DeltaSubscriber:
    """Replica-side adopter of published delta generations (see the
    module docstring for the verify-all-then-apply contract).

    ``directory`` is the publisher's delta dir (typically a shared
    filesystem); ``tables`` maps table name -> the replica's
    :class:`~torchrec_tpu_torch.tiered.storage.TieredTable` (its host tier
    receives the rows); ``hot_rows`` is the replica's
    ``HotRowServingCache`` whose resident HBM copies are refreshed
    after each apply (None for replicas without one); ``metrics`` is
    the registry the ``freshness/*`` gauges/counters land in;
    ``vocabs`` maps table name -> the replica's
    :class:`~torchrec_tpu_torch.dynamic.vocab.VocabView` mirror, advanced by
    the manifest's admission/eviction records under the same verify-
    then-apply + bit-exact-rollback contract as the rows."""

    def __init__(
        self,
        directory: str,
        tables: Mapping[str, object],
        hot_rows=None,
        metrics: Optional[MetricsRegistry] = None,
        vocabs: Optional[Mapping[str, object]] = None,
    ):
        self.directory = os.path.abspath(directory)
        self.tables = dict(tables)
        self.hot_rows = hot_rows
        self.vocabs = dict(vocabs or {})
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.generation = 0
        self.applied_step: Optional[int] = None
        self._lock = threading.Lock()

    # -- reads ---------------------------------------------------------------

    def _read_current(self) -> Optional[dict]:
        try:
            with open(
                os.path.join(self.directory, CURRENT_NAME), encoding="utf-8"
            ) as f:
                cur = json.load(f)
            int(cur["generation"])
            return cur
        except (OSError, ValueError, KeyError):
            return None

    def _read_manifest(self, gen: int) -> Optional[dict]:
        try:
            with open(
                os.path.join(self.directory, f"manifest.g{gen}.json"),
                encoding="utf-8",
            ) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _verify_generation(
        self, manifest: dict
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Read + verify EVERY chunk of a generation into memory;
        raises :class:`_DeltaVerifyError` (carrying the table name) on
        the first integrity failure (size, CRC32, frame structure, id
        range, row shape).  Nothing is applied until this whole pass
        succeeds — the atomic-adoption half of the protocol."""
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for table, ent in manifest.get("tables", {}).items():
            tbl = self.tables.get(table)
            if tbl is None:
                # a table this replica does not serve rides past
                continue
            path = os.path.join(self.directory, ent["file"])
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError as e:
                raise _DeltaVerifyError(
                    table,
                    f"table {table}: delta chunk {ent['file']} missing "
                    f"({e}) — partial publish",
                )
            if len(payload) != int(ent["bytes"]):
                raise _DeltaVerifyError(
                    table,
                    f"table {table}: delta chunk {ent['file']} is "
                    f"{len(payload)} bytes, manifest says {ent['bytes']}",
                )
            if (zlib.crc32(payload) & 0xFFFFFFFF) != int(ent["crc32"]):
                raise _DeltaVerifyError(
                    table,
                    f"table {table}: delta chunk {ent['file']} CRC32 "
                    "mismatch — corrupt publish",
                )
            try:
                header, ids, rows = _decode_chunk(payload)
            except ValueError as e:
                raise _DeltaVerifyError(
                    table, f"table {table}: {e}"
                )
            if header.get("table") != table or rows.shape[1] != int(
                getattr(tbl, "embedding_dim", rows.shape[1])
            ):
                raise _DeltaVerifyError(
                    table,
                    f"table {table}: delta chunk header/shape disagrees "
                    f"with the manifest ({header})",
                )
            rmax = int(getattr(tbl, "num_embeddings", 0))
            if rmax and len(ids) and (
                ids.min() < 0 or ids.max() >= rmax
            ):
                raise _DeltaVerifyError(
                    table,
                    f"table {table}: delta ids out of range [0, {rmax})",
                )
            out[table] = (ids, rows)
        return out

    def _apply_vocab(self, manifest: dict) -> Dict[str, Dict[int, int]]:
        """Verify + apply the manifest's vocab admission/eviction
        records into this replica's :class:`VocabView` mirrors; returns
        per-table pre-image tokens for rollback.  All-or-nothing across
        tables: any CRC mismatch or inconsistent event sequence (the
        view validates range / double-assignment / evict-of-unheld)
        restores the views already advanced, then raises
        :class:`_DeltaVerifyError` so the whole generation is refused."""
        undo: Dict[str, Dict[int, int]] = {}
        for table, ent in (manifest.get("vocab") or {}).items():
            view = self.vocabs.get(table)
            if view is None:
                # a vocab this replica does not mirror rides past,
                # same as an unserved table's row chunk
                continue
            try:
                events = ent["events"]
                body = json.dumps(
                    events, sort_keys=True, separators=(",", ":")
                )
                if (zlib.crc32(body.encode()) & 0xFFFFFFFF) != int(
                    ent["crc32"]
                ):
                    raise ValueError(
                        "vocab events CRC32 mismatch — corrupt publish"
                    )
                undo[table] = view.apply_events(events)
            except (ValueError, KeyError, TypeError) as e:
                for t2, token in undo.items():
                    self.vocabs[t2].restore(token)
                raise _DeltaVerifyError(table, f"table {table}: {e}")
        return undo

    # -- staleness -----------------------------------------------------------

    def _export_staleness(self, published_step: Optional[int]) -> None:
        """``freshness/<table>/staleness_steps`` = newest published
        step minus the step this replica has applied (0 while fresh —
        including before anything was ever published)."""
        base = self.applied_step or 0
        gap = 0.0
        if published_step is not None:
            gap = float(max(0, int(published_step) - base))
        for table in self.tables:
            self.metrics.gauge(
                counter_key("freshness", table, "staleness_steps"), gap
            )
        self.metrics.gauge("freshness/generation", float(self.generation))
        self.metrics.gauge(
            "freshness/applied_step", float(self.applied_step or 0)
        )

    # -- the poll ------------------------------------------------------------

    def poll(self) -> bool:
        """One adoption attempt: returns True when a NEW generation
        verified and applied; False when nothing new, the publish is
        torn/invisible, or verification rolled it back (counted in
        ``freshness/<table>/rollback_count``; the old generation keeps
        serving untouched)."""
        with self._lock:
            cur = self._read_current()
            if cur is None:
                self._export_staleness(None)
                return False
            gen = int(cur["generation"])
            pub_step = cur.get("step")
            if gen <= self.generation:
                self._export_staleness(pub_step)
                return False
            manifest = self._read_manifest(gen)
            if manifest is None:
                # CURRENT points at a manifest that is not there: a
                # torn publish (or a lagging shared filesystem) —
                # old generation stays in charge
                self.metrics.counter("freshness/torn_publish_count")
                self._export_staleness(pub_step)
                return False
            try:
                verified = self._verify_generation(manifest)
            except _DeltaVerifyError as e:
                self._note_rollback(e.table, gen)
                self._export_staleness(pub_step)
                return False
            # vocab records apply before rows: an admitted id's row may
            # ride in this same generation, and serving it requires the
            # remap entry.  The undo tokens keep the apply atomic with
            # the rows below.
            try:
                vocab_undo = self._apply_vocab(manifest)
            except _DeltaVerifyError as e:
                self._note_rollback(e.table, gen)
                self._export_staleness(pub_step)
                return False
            # verification passed in full: apply (host tier first, then
            # the resident HBM copies) and adopt.  Pre-images make the
            # apply itself all-or-nothing: a mid-apply storage failure
            # (disk full, NFS hiccup) undoes the tables already written
            # so the replica never serves a cross-table mix of
            # generations.
            pre: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            refreshed: Dict[str, int] = {}
            try:
                for table, (ids, rows) in verified.items():
                    tbl = self.tables[table]
                    pre[table] = (ids, tbl.read_weight_rows(ids).copy())
                    tbl.write_weight_rows(ids, rows)
                    refreshed[table] = (
                        self.hot_rows.refresh_rows(table, ids)
                        if self.hot_rows is not None
                        else 0
                    )
            except Exception:
                # best-effort per-table undo: the table whose write
                # just failed may refuse its undo too — that must not
                # abort undoing its healthy siblings or crash the
                # polling loop (undo_error_count makes it visible)
                for table, (ids, old_rows) in pre.items():
                    try:
                        self.tables[table].write_weight_rows(
                            ids, old_rows
                        )
                        if self.hot_rows is not None:
                            self.hot_rows.refresh_rows(table, ids)
                    except Exception:
                        self.metrics.counter(
                            "freshness/undo_error_count"
                        )
                for t2, token in vocab_undo.items():
                    self.vocabs[t2].restore(token)
                self.metrics.counter("freshness/apply_error_count")
                self._note_rollback(None, gen)
                self._export_staleness(pub_step)
                return False
            for table, (ids, _) in verified.items():
                self.metrics.counter(
                    counter_key("freshness", table, "applied_rows"),
                    float(len(ids)),
                )
                self.metrics.counter(
                    counter_key("freshness", table, "refreshed_slots"),
                    float(refreshed[table]),
                )
            for table in vocab_undo:
                applied = manifest["vocab"][table].get("count", 0)
                self.metrics.counter(
                    counter_key("freshness", table, "vocab_applied_events"),
                    float(applied),
                )
            self.generation = gen
            self.applied_step = int(manifest.get("step", 0))
            self.metrics.counter("freshness/applied_generation_count")
            self._export_staleness(pub_step)
            return True

    def _note_rollback(self, table: Optional[str], gen: int) -> None:
        """Book one refused generation (``table`` None = apply-phase
        failure not attributable to a single table)."""
        self.metrics.counter("freshness/rollback_count")
        if table is not None and table in self.tables:
            self.metrics.counter(
                counter_key("freshness", table, "rollback_count")
            )
        self.metrics.gauge("freshness/last_rollback_gen", float(gen))
