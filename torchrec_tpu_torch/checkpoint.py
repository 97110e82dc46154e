"""Checkpoint and resume with plan-independent table weights
(``torchrec_tpu/checkpoint.py``, its protocol kept).

The payload has the JAX package's logical keys:

  tables/{table}             : full ``[R, D]`` weights, each in its own
                               dtype (plan-INDEPENDENT: a restore under
                               another plan reshards them on load)
  dense                      : the model's dense parameters, by name
  dense_opt_leaves           : the dense optimizer state's leaves,
                               index-keyed (``"00000"``, ...) in the state
                               dict's own order
  fused/{group}/{slot}       : the fused optimizer's state in the global
                               group layout (every rank's rows; plan-
                               DEPENDENT: a restore checks the shapes and
                               fails loudly on a plan change)
  fused_tables/{table}/{slot}: the same slots as plan-INDEPENDENT
                               per-table arrays (``parallel/
                               dynamic_sharding.py``), from which
                               ``restore_elastic`` rebuilds the optimizer
                               state under another plan or world size;
                               the scalar counters under ``__scalars__``
  step                       : an int
  tiered/{table}             : with ``Checkpointer(tiered=collection)``,
                               each tiered table's host tier: its rows
                               (``host_rows``, a RAM tier) or the disk
                               generation its flush published
                               (``generation``)

The on-disk format is the port's own: a step's ``payload/`` directory
holds ``manifest.json``, which lists every leaf by its key path with its
dtype and shape and the name of its file, one raw little-endian file a
tensor (``00000.bin``, ...; bfloat16 stored as its 16-bit words), and
the value itself for an int or a float.  It is read and written with
numpy on any machine, the CPU and the card alike; a restore reads the
files into host tensors and moves each rank's share to its device.

Crash safety is the JAX package's: each step is written into a hidden
``.tmp_step_*`` directory, a ``COMMIT`` marker is written inside it, and
the directory is renamed to ``step_{N}`` in one atomic rename; a step
directory without the marker is torn and ``latest_step()``/``steps()``
skip it.  Re-saving a committed step sets the old copy aside
(``step_{N}.replaced``) until the new one has landed.  ``keep_last_n``
removes old committed steps after each save; write failures retry with
exponential backoff; ``async_save=True`` writes on a background thread
(``wait()``/``close()`` join it and raise its error).  Every save
records a ``checksums.json`` sidecar (version 1: each table's CRC32,
shape and dtype) that a restore verifies, raising
``CheckpointCorruption`` naming every damaged table.

Under a process group ``save`` is a collective: every rank gathers the
stacks and the slots (``DistributedModelParallel.gather_group_state``),
and only rank 0 touches the disk, alone (the default) or behind the two-phase ``commit_barrier``, which
renames the step into place only after every rank acked it.  ``restore``
is per rank: each rank reads the shared directory and keeps its share.

``save`` copies the whole payload to host memory on the caller's thread
before it returns, also with ``async_save``: the next train step writes
the same device memory in place.

With ``tiered=`` (a ``tiered.TieredCollection``) a save first syncs
every cache-resident row, weights and optimizer slots, to the host tier
and publishes disk tiers (``TieredCollection.checkpoint_payload``, which
refuses a save while remapped batches are queued: drain the pipeline
first), all before the atomic commit; a restore reloads the host tiers
and resets the caches cold before it hands the state back.

Left out: the dynamic-vocabulary collection (``vocab=``), which raises
``NotImplementedError`` until ROADMAP A10's second part ports it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.obs.spans import span as obs_span
from torchrec_tpu_torch.parallel.multiprocess import process_index

COMMIT_MARKER = "COMMIT"
_TMP_PREFIX = ".tmp_step_"
# age past which a distributed-save tmp dir (.tmp_step_N.d{token}.{seq},
# whose writer lives in another process) counts as crash wreckage
_DIST_TMP_TTL_S = 15 * 60.0
MANIFEST = "manifest.json"
FORMAT = "torchrec_tpu_torch.checkpoint/1"
# numpy stand-ins of the tensor dtypes without a numpy dtype: the raw
# words are written, the dtype is named in the manifest
_WORDS = {torch.bfloat16: np.int16}


class CheckpointCorruption(ValueError):
    """``restore`` found that a checkpoint's bytes on disk no longer match
    the per-table checksums recorded at save time (bit rot, a torn copy,
    a bad disk), and names the damaged tables.  Recovery: restore an
    older committed step, or copy this checkpoint again from a healthy
    replica."""


class CheckpointPlanMismatch(ValueError):
    """``restore`` found up front that the checkpoint was written for
    another model, plan or topology than the restoring DMP's, and names
    the tables or groups and the ways out (``dmp.load_table_weights``
    for the plan-independent weights, ``parallel.dynamic_sharding.
    reshard`` for a live state)."""


# ---------------------------------------------------------------------------
# the payload on disk
# ---------------------------------------------------------------------------


def _leaves(tree: Any, path: Tuple[str, ...] = ()):
    """(key path, leaf) of a nested dict, in its own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _to_host(x: Any) -> Any:
    """A leaf as the payload holds it: a tensor copied to host memory
    (its own dtype), a number as an int or a float."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, (bool, int, np.integer)):
        return int(x)
    return float(x)


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {str(k): _host_tree(v) for k, v in tree.items()}
    return _to_host(tree)


def _numpy_words(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype in _WORDS:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def write_payload(directory: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (nested dicts of host tensors and numbers) into
    ``directory`` in the format of the module docstring."""
    os.makedirs(directory, exist_ok=True)
    entries = []
    for i, (path, leaf) in enumerate(_leaves(payload)):
        if isinstance(leaf, torch.Tensor):
            name = f"{i:05d}.bin"
            _numpy_words(leaf).tofile(os.path.join(directory, name))
            entries.append({"path": list(path), "file": name,
                            "dtype": _dtype_name(leaf.dtype),
                            "shape": list(leaf.shape)})
        else:
            entries.append({"path": list(path), "value": leaf})
    with open(os.path.join(directory, MANIFEST), "w", encoding="utf-8") as f:
        json.dump({"format": FORMAT, "leaves": entries}, f)


def read_payload(directory: str) -> Dict[str, Any]:
    """Inverse of :func:`write_payload`: the payload as nested dicts of
    host tensors and numbers."""
    with open(os.path.join(directory, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{directory}: not a {FORMAT} payload")
    out: Dict[str, Any] = {}
    for e in manifest["leaves"]:
        node = out
        for k in e["path"][:-1]:
            node = node.setdefault(k, {})
        if "file" in e:
            dtype = getattr(torch, e["dtype"])
            np_dtype = _WORDS.get(dtype) or torch.empty(
                0, dtype=dtype).numpy().dtype
            arr = np.fromfile(os.path.join(directory, e["file"]), np_dtype)
            t = torch.from_numpy(arr.reshape(e["shape"]))
            value = t.view(dtype) if dtype in _WORDS else t
        else:
            value = e["value"]
        node[e["path"][-1]] = value
    return out


def _flatten(tree: Any) -> List[Any]:
    return [leaf for _, leaf in _leaves(tree)]


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves taken in order from
    ``leaves`` (each tensor in its template's dtype and device)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        leaf = next(it)
        if isinstance(node, torch.Tensor):
            return torch.as_tensor(leaf).to(node.device, node.dtype,
                                            copy=True)
        return type(node)(leaf)

    return build(template)


class Checkpointer:
    """Save and restore a ``DistributedModelParallel`` train state under
    ``directory`` (one committed ``step_{N}`` directory a step).

    keep_last_n: keep only the newest N committed steps (None: all).
    async_save: write to disk on a background thread; ``save`` returns
        once the state is copied to host memory, and ``wait()`` joins the
        write (raising its error, if any).
    save_retries / retry_backoff_s: a failed write is retried with
        exponential backoff (backoff * 2**attempt) before it raises.
    commit_barrier: the two-phase distributed commit
        (``reliability.TcpKVCommitBarrier`` or anything with its
        methods): every rank takes the collective snapshot, rank 0 writes
        it to the tmp directory, every rank posts a PREPARED ack, and rank
        0 renames the step into place only after every ack arrived, so a
        crash between any rank's snapshot and the COMMIT leaves the step
        uncommitted.  Excludes ``async_save`` (the acks run on the thread
        that took the collective snapshot).
    single_writer: accepted for the JAX package's signature and ignored:
        without a ``commit_barrier`` every save under a process group is
        already single-writer (every rank takes the collective snapshot,
        rank 0 alone writes, and a non-zero rank returns the would-be
        path and never sweeps the directory).
    tiered: a ``tiered.TieredCollection`` whose host tiers the
        checkpoint carries and restores with the device caches (module
        docstring).  A crash between the tiers' flush and the commit is
        safe: the older committed checkpoint pins an older disk
        generation, which ``keep_generations`` keeps.
    vocab: not ported yet (ROADMAP A10's second part); raises
        ``NotImplementedError``.
    """

    CHECKSUM_SIDECAR = "checksums.json"

    def __init__(
        self,
        directory: str,
        keep_last_n: Optional[int] = None,
        async_save: bool = False,
        save_retries: int = 2,
        retry_backoff_s: float = 0.05,
        tiered=None,
        commit_barrier=None,
        single_writer: bool = False,
        vocab=None,
    ):
        if vocab is not None:
            raise NotImplementedError(
                "Checkpointer(vocab=...): the dynamic-vocabulary collection "
                "is not ported yet (ROADMAP A10)")
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
        if commit_barrier is not None and async_save:
            raise ValueError(
                "commit_barrier and async_save are mutually exclusive: the "
                "all-rank ack must run on the thread that took the "
                "collective state snapshot")
        del single_writer  # the default already (see above)
        self.tiered = tiered
        self.commit_barrier = commit_barrier
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.save_retries = save_retries
        self.retry_backoff_s = retry_backoff_s
        self._dist_save_seq = 0
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        # a fresh Checkpointer is a (re)started process: clear torn tmp
        # dirs a crash mid-save left behind (the writer alone: a non-zero
        # rank must not sweep under a live writer)
        if process_index() == 0:
            self._sweep_stale_tmp()

    # -- layout ------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _aside_path(self, step: int) -> str:
        # the previously committed copy while a same-step re-save swaps
        # in; steps() skips it (non-integer suffix), _sweep_stale_tmp
        # restores or discards it on restart
        return os.path.join(self.directory, f"step_{step}.replaced")

    def _is_committed(self, path: str) -> bool:
        """The COMMIT marker is present (an atomic-rename save never
        leaves a step directory without it)."""
        return os.path.isfile(os.path.join(path, COMMIT_MARKER))

    def steps(self) -> List[int]:
        """Every COMMITTED step, ascending; torn directories (no
        ``COMMIT`` marker) are skipped."""
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_"):
                continue
            try:
                step = int(name[5:])
            except ValueError:
                continue
            if self._is_committed(os.path.join(self.directory, name)):
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step, or None."""
        steps = self.steps()
        return steps[-1] if steps else None

    def _tmp_owner_alive(self, name: str) -> bool:
        """Whether a tmp dir may still have a live writer.
        ``.tmp_step_{step}.{pid}.{attempt}`` (a local save): its pid is a
        live process other than this one.  ``.tmp_step_{step}.d{token}.
        {seq}`` (a two-phase save): younger than ``_DIST_TMP_TTL_S``."""
        tail = name[len(_TMP_PREFIX):].split(".")
        if len(tail) >= 2 and tail[1].startswith("d"):
            try:
                age = time.time() - os.stat(
                    os.path.join(self.directory, name)).st_mtime
            except OSError:
                return False
            return age < _DIST_TMP_TTL_S
        try:
            pid = int(tail[1])
        except (IndexError, ValueError):
            return False  # unparseable: dead wreckage
        if pid == os.getpid():
            return False  # our own past self cannot be mid-write now
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, owned by someone else

    def _sweep_stale_tmp(self) -> None:
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith(_TMP_PREFIX):
                if not self._tmp_owner_alive(name):
                    shutil.rmtree(full, ignore_errors=True)
            elif name.startswith("step_") and name.endswith(".replaced"):
                # a crash during a same-step re-save: if the new copy
                # never landed, the set-aside committed copy is the truth
                final = full[: -len(".replaced")]
                if os.path.exists(final):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    try:
                        os.replace(full, final)
                    except OSError:
                        # a peer's concurrent sweep may have won the race:
                        # benign only if the copy is back in place
                        if not os.path.exists(final):
                            raise

    # -- save --------------------------------------------------------------

    def _build_payload(self, dmp, state: Dict[str, Any]) -> Dict[str, Any]:
        """The train state as a host payload (a collective under a
        process group).  Runs on the caller's thread, also in async mode,
        so a later in-place step cannot change what is written."""
        from torchrec_tpu_torch.parallel.dynamic_sharding import (
            _slots_to_tables,
        )

        tables, fused = dmp.gather_group_state(state, replica_mean=True)
        weights = dmp.sharded_ebc.tables_to_weights(tables)
        payload = {
            "tables": _host_tree(weights),
            "dense": _host_tree(state["dense"]),
            "dense_opt_leaves": {
                f"{i:05d}": _to_host(x)
                for i, x in enumerate(_flatten(state["dense_opt"]))},
            "fused": _host_tree(fused),
            # plan-INDEPENDENT optimizer slots, so an elastic resume under
            # another plan or world size restores them (restore_elastic)
            "fused_tables": _host_tree(_slots_to_tables(dmp, fused)),
            "step": int(state["step"]),
        }
        if self.tiered is not None:
            # sync the cache to the host tier and publish disk tiers now,
            # on the caller's thread, before any async write and before
            # the commit, so that the payload pins durable rows
            payload["tiered"] = _host_tree(
                self.tiered.checkpoint_payload(dmp, state))
        return payload

    def save(self, dmp, state: Dict[str, Any],
             step: Optional[int] = None) -> str:
        """Crash-safe save; returns the committed step's path.  In async
        mode the write runs on a background thread: ``wait()`` before
        relying on it.  A collective under a process group."""
        if step is None:
            step = int(state["step"])
        payload = self._build_payload(dmp, state)
        if self.commit_barrier is not None:
            return self._write_two_phase(payload, step)
        if process_index() != 0:
            # the snapshot was taken with everyone else; the shared
            # directory's write is rank 0's alone
            return self._path(step)
        return self._write_payload_async(payload, step)

    def save_payload(self, payload: Dict[str, Any], step: int) -> str:
        """Crash-safe save of a payload built elsewhere (e.g. a JAX
        checkpoint carried across with ``convert.
        checkpoint_payload_from_jax``); honours ``async_save``."""
        return self._write_payload_async(_host_tree(payload), step)

    def _write_payload_async(self, payload: Dict[str, Any], step: int) -> str:
        if self.async_save:
            # one write at a time: join the previous one first (raising its
            # error), then hand this payload to a fresh thread
            self.wait()
            t = threading.Thread(target=self._write_guarded,
                                 args=(payload, step), daemon=True)
            self._save_thread = t
            t.start()
        else:
            self._write(payload, step)
        return self._path(step)

    def _write_guarded(self, payload: Dict[str, Any], step: int) -> None:
        try:
            self._write(payload, step)
        except BaseException as e:  # incl. non-Exception crashes: wait()
            self._save_error = e  # must never report a dead write as ok

    def _write(self, payload: Dict[str, Any], step: int) -> str:
        final = self._path(step)
        last_exc: Optional[Exception] = None
        for attempt in range(self.save_retries + 1):
            tmp = os.path.join(self.directory,
                               f"{_TMP_PREFIX}{step}.{os.getpid()}.{attempt}")
            try:
                self._write_payload(tmp, payload)
                self._write_checksums(tmp, payload)
                self._commit(tmp, final, step)
                self._gc()
                return final
            except Exception as e:
                # a torn attempt must never be mistaken for a checkpoint
                shutil.rmtree(tmp, ignore_errors=True)
                last_exc = e
                if attempt < self.save_retries:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        assert last_exc is not None
        raise last_exc

    def _write_two_phase(self, payload: Dict[str, Any], step: int) -> str:
        """The two-phase commit (``commit_barrier`` set).  PREPARE: rank 0
        writes the payload and its sidecar into a tmp directory whose name
        every rank agrees on (``.tmp_step_{N}.d{token}.{seq}``: the
        barrier's ``save_token`` and a per-process save counter, equal on
        every rank because saves run in lockstep), then every rank posts
        its PREPARED ack.  COMMIT: rank 0 waits for every ack, renames the
        step into place and publishes the COMMIT record the other ranks
        wait on.  A rank that dies before its ack starves the wait, and
        the save raises ``BarrierTimeout`` with the step uncommitted.  No
        retry: a timeout means a peer is gone, which only a relaunch
        mends."""
        barrier = self.commit_barrier
        final = self._path(step)
        seq = self._dist_save_seq
        self._dist_save_seq += 1
        token = getattr(barrier, "save_token", None) or "ist"
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}.d{token}.{seq}")
        try:
            if barrier.rank == 0:
                self._write_payload(tmp, payload)
                self._write_checksums(tmp, payload)
            barrier.prepare(step)
            if barrier.rank == 0:
                barrier.wait_all_prepared(step)
                self._commit(tmp, final, step)
                self._gc()
                barrier.commit(step)
            else:
                barrier.wait_committed(step)
        except BaseException:
            if barrier.rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final

    def _write_payload(self, tmp: str, payload: Dict[str, Any]) -> None:
        """Write the payload under ``tmp`` (the fault-injection harness
        overrides this)."""
        write_payload(os.path.join(tmp, "payload"), payload)

    @staticmethod
    def _table_checksums(payload: Dict[str, Any]) -> Dict[str, Any]:
        """Each table's CRC32, shape and dtype: the integrity manifest a
        restore verifies.  The tables' CRCs run on a thread pool, straight
        over their host buffers (``zlib`` releases the GIL on them)."""
        tables = payload.get("tables", {})

        def crc(t):
            return zlib.crc32(_numpy_words(t)) & 0xFFFFFFFF

        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            crcs = dict(zip(tables, pool.map(crc, tables.values())))
        return {name: {"crc32": crcs[name], "shape": list(t.shape),
                       "dtype": _dtype_name(t.dtype)}
                for name, t in tables.items()}

    def _write_checksums(self, tmp: str, payload: Dict[str, Any]) -> None:
        """The integrity sidecar, inside the tmp dir so it rides the same
        atomic rename as the payload."""
        sidecar = {"version": 1, "tables": self._table_checksums(payload)}
        with open(os.path.join(tmp, self.CHECKSUM_SIDECAR), "w",
                  encoding="utf-8") as f:
            json.dump(sidecar, f)

    def _verify_checksums(self, path: str, payload: Dict[str, Any]) -> None:
        """Hold the read tables to the sidecar; raise
        ``CheckpointCorruption`` naming every damaged table (a table the
        sidecar lists and the payload lost counts).  No sidecar: no
        check."""
        sidecar_path = os.path.join(path, self.CHECKSUM_SIDECAR)
        if not os.path.isfile(sidecar_path):
            return
        with open(sidecar_path, encoding="utf-8") as f:
            expected = json.load(f).get("tables", {})
        got = self._table_checksums(payload)
        bad = sorted(
            name for name, ent in expected.items()
            if name not in got
            or int(got[name]["crc32"]) != int(ent["crc32"])
            or got[name]["shape"] != list(ent["shape"])
            or got[name]["dtype"] != ent["dtype"])
        if bad:
            raise CheckpointCorruption(
                f"checkpoint at {path} failed integrity verification: "
                f"table(s) {bad} do not match the per-array checksums "
                "recorded at save time (bit rot or a torn copy).  Restore "
                "an older committed step (steps()) or copy this checkpoint "
                "again from a healthy replica.")

    def _commit(self, tmp: str, final: str, step: int) -> None:
        """The atomic commit: the marker inside tmp, then one rename.  A
        same-step re-save sets the old copy aside (a rename, not a
        delete) until the new one has landed."""
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        aside = None
        if os.path.exists(final):
            aside = self._aside_path(step)
            shutil.rmtree(aside, ignore_errors=True)
            os.replace(final, aside)
        os.replace(tmp, final)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)

    def _gc(self) -> None:
        if self.keep_last_n is None:
            return
        for s in self.steps()[: -self.keep_last_n]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def wait(self) -> None:
        """Join the in-flight async save (no-op in sync mode) and raise
        its error, once."""
        t = self._save_thread
        if t is not None:
            t.join()
            self._save_thread = None
        if self._save_error is not None:
            e, self._save_error = self._save_error, None
            raise e

    def close(self) -> None:
        """Drain pending async work; the checkpointer stays usable."""
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- restore -----------------------------------------------------------

    def _check_compatible(self, dmp, payload: Dict[str, Any], step: int,
                          check_fused: bool = True) -> None:
        """Raise ``CheckpointPlanMismatch`` before anything is placed when
        the checkpoint disagrees with ``dmp``: the table set or shapes
        (the model changed) or, with ``check_fused``, the fused groups'
        slot shapes (the plan or the topology changed)."""
        expect_tables = {c.name: (c.num_embeddings, c.embedding_dim)
                         for c in dmp.tables}
        got_tables = {k: tuple(int(d) for d in v.shape)
                      for k, v in payload["tables"].items()}
        problems = []
        for name in sorted(set(expect_tables) - set(got_tables)):
            problems.append(f"table {name} is missing from the checkpoint")
        for name in sorted(set(got_tables) - set(expect_tables)):
            problems.append(f"checkpoint table {name} does not exist in "
                            "this model")
        for name in sorted(set(expect_tables) & set(got_tables)):
            if got_tables[name] != expect_tables[name]:
                problems.append(
                    f"table {name}: checkpoint shape {got_tables[name]} != "
                    f"configured {expect_tables[name]} "
                    "(num_embeddings/embedding_dim changed)")
        if problems:
            raise CheckpointPlanMismatch(
                f"checkpoint step {step} was written for a different "
                "model: " + "; ".join(problems) + ".  Table weights are "
                "plan-independent: load the overlapping tables with "
                "dmp.load_table_weights, or migrate a live state with "
                "parallel.dynamic_sharding.reshard.")
        if not check_fused:
            return
        expect = dmp._fused_struct()
        got = {g: {k: (tuple(v.shape) if isinstance(v, torch.Tensor)
                       else ()) for k, v in st.items()}
               for g, st in payload["fused"].items()}
        if expect != got:
            bad = sorted(n for n in set(expect) | set(got)
                         if expect.get(n) != got.get(n))
            raise CheckpointPlanMismatch(
                f"checkpoint step {step} was written under a different "
                "sharding plan/topology: fused-optimizer group layouts "
                f"disagree for groups {bad} (checkpoint "
                f"{ {n: got.get(n) for n in bad} } vs current plan "
                f"{ {n: expect.get(n) for n in bad} }).  Restore the "
                "plan-independent table weights with "
                "dmp.load_table_weights (optimizer slots restart), or "
                "migrate the live state between plans with "
                "parallel.dynamic_sharding.reshard.")

    def _read_payload(self, step: int) -> Dict[str, Any]:
        """A COMMITTED step's payload (host tensors), verified against its
        sidecar; a torn or missing step raises ``FileNotFoundError``."""
        path = self._path(step)
        if not self._is_committed(path):
            raise FileNotFoundError(
                f"checkpoint step {step} at {path} is missing or was never "
                "committed (torn save?): see latest_step() for committed "
                "steps")
        payload = read_payload(os.path.join(path, "payload"))
        self._verify_checksums(path, payload)
        return payload

    def _place_state(self, dmp, payload: Dict[str, Any], tables,
                     fused) -> Dict[str, Any]:
        """The restored train state on ``dmp``'s device: ``tables`` and
        ``fused`` already this process's share; the dense parameters and
        their optimizer state from the payload."""
        dense = {k: torch.as_tensor(v).to(dmp.device, copy=True)
                 for k, v in payload["dense"].items()}
        template = dmp.dense_tx.init(dense)
        flat = payload["dense_opt_leaves"]
        if len(_flatten(template)) != len(flat):
            raise CheckpointPlanMismatch(
                "the checkpoint's dense optimizer state has "
                f"{len(flat)} leaves, the configured optimizer "
                f"{len(_flatten(template))}")
        return {
            "dense": dense,
            "dense_opt": _unflatten(template, [flat[k] for k in sorted(flat)]),
            "tables": tables,
            "fused": fused,
            "step": int(payload["step"]),
        }

    def restore(self, dmp, step: int) -> Dict[str, Any]:
        """This process's share of the train state of a committed step,
        on ``dmp``'s device; the table weights reshard under ``dmp``'s
        (possibly different) plan, while the fused slots must match it
        (``CheckpointPlanMismatch`` otherwise; ``restore_elastic``
        rebuilds them under any plan)."""
        return self._restore_exact(dmp, self._read_payload(step), step)

    def _rehydrate_tiered(self, payload: Dict[str, Any], step: int) -> None:
        """Reload the host tiers the payload carries (after the
        compatibility checks) and reset the caches cold, before the state
        is handed back: a batch remapped against stale host rows would
        fork the run."""
        tiered = payload.get("tiered")
        if tiered is not None and self.tiered is None:
            raise CheckpointPlanMismatch(
                f"checkpoint step {step} carries tiered-storage state but "
                "this Checkpointer has no tiered collection: construct it "
                "with Checkpointer(..., tiered=collection) so that the host "
                "tiers restore with the device caches")
        if self.tiered is not None:
            self.tiered.checkpoint_restore(tiered)

    def _restore_exact(self, dmp, payload: Dict[str, Any],
                       step: int) -> Dict[str, Any]:
        self._check_compatible(dmp, payload, step)
        self._rehydrate_tiered(payload, step)
        ebc = dmp.sharded_ebc
        tables = dmp._local_share(ebc.params_from_tables(
            payload["tables"], dmp.table_dtype, dmp.device,
            rank=dmp.env.rank))
        fused = dmp.local_fused_state(payload["fused"])
        return self._place_state(dmp, payload, tables, fused)

    def restore_elastic(self, dmp, step: int) -> Dict[str, Any]:
        """The plan-independent restore of an elastic resume: a train
        state for ``dmp``'s (possibly different) plan and world size.  The
        weights reshard as in ``restore``; the fused slots are rebuilt
        from the per-table ``fused_tables`` entry through the scatter of
        ``dynamic_sharding`` (``reshard``'s), so momentum and step
        counters survive a change of world size."""
        from torchrec_tpu_torch.parallel.dynamic_sharding import (
            scatter_slots,
        )

        with obs_span("reliability/elastic_restore", step=step):
            payload = self._read_payload(step)
            self._check_compatible(dmp, payload, step, check_fused=False)
            if "fused_tables" not in payload:
                # a payload without the per-table slots (e.g. carried from
                # an older JAX checkpoint): only a plan-exact restore keeps
                # them, and it raises the descriptive mismatch otherwise
                return self._restore_exact(dmp, payload, step)
            ebc = dmp.sharded_ebc
            tables = dmp._local_share(ebc.params_from_tables(
                payload["tables"], dmp.table_dtype, dmp.device,
                rank=dmp.env.rank))
            fused = dmp._local_share(ebc.init_fused_state(
                dmp.fused_config, dmp.device))
            fused = scatter_slots(dmp, fused, payload["fused_tables"])
            self._rehydrate_tiered(payload, step)
            return self._place_state(dmp, payload, tables, fused)
