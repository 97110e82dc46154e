"""TieredTrainPipeline: tiered storage in the bucketed train pipeline
(``torchrec_tpu/tiered/pipeline.py``).

While step ``i`` runs on the card, the pipeline thread pulls a later
batch, remaps its tiered features to cache slots
(``TieredCollection.process_group``: stateful, in stream order), hands
the remap's fetch plan to the ``TieredPrefetcher`` (whose worker reads
the rows from the host tier into pinned memory and copies them to the
card on a side stream), buckets the batch and copies it to the card.
``progress`` then lands the cache's write-backs and the staged fills
(``TieredCollection.apply_io``, on the step's stream) and dispatches the
step.  The synchronous path (``modules/host_offload.py``) does all of
that in front of every step.

The port's steps update the state in place, and the fault-tolerant
loop undoes a bad step with its undo log (``reliability/train_loop.py``
``StepUndoLog``), which records each fused update's rows after this
step's fills landed: its restore keeps the fills and drops only the
step's update, which is what the JAX package's revert (the state before
the step, then the fills again) gives.  :meth:`revert_last_step` is that
JAX form: a saved state put back and filled again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.obs.spans import span as obs_span
from torchrec_tpu_torch.parallel.train_pipeline import (
    BucketedTrainPipeline,
    BucketingConfig,
    TrainPipelineBase,
    TrainPipelineSemiSync,
)
from torchrec_tpu_torch.tiered.collection import TieredCollection
from torchrec_tpu_torch.tiered.prefetch import TieredPrefetcher


def _write_tree(live: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """Copy ``saved`` into ``live``, tensors in place."""
    for k, v in saved.items():
        if isinstance(v, dict):
            _write_tree(live[k], v)
        elif hasattr(v, "copy_") and hasattr(live.get(k), "copy_"):
            live[k].copy_(v)
        else:
            live[k] = v


class TieredTrainPipeline(BucketedTrainPipeline):
    """The bucketed train pipeline with tiered-storage cache management
    and asynchronous prefetch: ``dmp``, ``state`` and ``bucketing`` go to
    :class:`BucketedTrainPipeline` (no ``bucketing``: one full-capacity
    step), ``collection`` is the :class:`TieredCollection` whose remap
    runs in ``_preprocess_locals``, and ``prefetch=False`` reads the host
    tier synchronously in ``apply_io`` instead.

    Not for the semi-sync pipeline: a fill must land before its batch's
    embedding, which semi-sync computes a step early against the tables
    before the fill.

    With the fault-tolerant loop: the loop's undo log reverts a NaN
    step (:meth:`revert_last_step` is the JAX package's form); a
    rollback or resume restores the host tier with the device state
    (``Checkpointer(tiered=...)``), then
    :meth:`invalidate_prefetch` drops the queued entries, whose KJTs
    carry slot ids of the remap the restore erased; checkpoints
    :meth:`drain` first."""

    def __init__(
        self,
        dmp,
        state,
        collection: TieredCollection,
        bucketing: Optional[BucketingConfig] = None,
        prefetch: bool = True,
    ):
        if isinstance(self, TrainPipelineSemiSync):
            raise TypeError(
                "tiered tables cannot run semi-sync: the split pipeline "
                "computes batch i+1's embedding forward against the tables "
                "as of step i-1, but batch i+1's cache fill must land before "
                "its forward; the stale read would miss the fill and train "
                "on a recycled slot's contents")
        super().__init__(dmp, state,
                         bucketing or BucketingConfig(max_programs=1))
        self._dmp = dmp
        self._coll = collection
        self._prefetcher = (TieredPrefetcher(collection, device=dmp.device)
                            if prefetch else None)
        # the last executed step's applied plans: what a revert to a saved
        # state fills again
        self._last_ios: Optional[List[Dict[str, Any]]] = None

    # -- hooks (run while the dispatched step executes) ----------------------

    def _preprocess_locals(self, locals_: List[Batch]
                           ) -> Tuple[List[Batch], Any]:
        # ONE group remap (the recycled-slot guard spans the step's locals;
        # one merged plan a table) and one staged prefetch a group
        with obs_span("tiered/cache_remap"):
            kjts, ios = self._coll.process_group(
                [b.sparse_features for b in locals_])
        processed = [dataclasses.replace(b, sparse_features=k)
                     for b, k in zip(locals_, kjts)]
        staged = self._prefetcher.submit(ios) if self._prefetcher else None
        return processed, [(ios, staged)]

    def _apply_aux(self, state, aux):
        self._last_ios = [ios for ios, _ in aux]
        with obs_span("tiered/apply_io"):
            for ios, staged in aux:
                state = self._coll.apply_io(self._dmp, state, ios,
                                            staged=staged)
                if self._prefetcher is not None:
                    self._prefetcher.mark_applied(ios)
        return state

    # -- recovery: the JAX-named revert, the loop's rollback hook -------------

    def revert_last_step(self, prev) -> None:
        """Discard the last executed step's update and keep the cache
        consistent (the JAX package's API): ``prev``, the state saved
        before the step, is put back, and then the step's fills are
        applied again from the host tier (their write-backs already
        persisted there): the saved state alone would undo the fills but
        not the host maps' claims.  The fault-tolerant loop needs none of
        this: its undo log recorded the rows after the fills."""
        if isinstance(prev, dict) and isinstance(self.state, dict) and (
                prev is not self.state):
            _write_tree(self.state, prev)
        else:
            self.state = prev
        if self._last_ios:
            self.state = self._coll.reapply_fetches(self._dmp, self.state,
                                                    self._last_ios)

    def invalidate_prefetch(self) -> None:
        """Drop the queued entries after the state was replaced out of
        band (a rollback or a resume): their KJTs carry slot ids of the
        remap that the tiered restore reset.  Raises if the cache maps
        still hold claims of unapplied remaps (the host tier was not
        restored with the state, and no drain ran)."""
        if self._coll.pending_io_groups:
            raise RuntimeError(
                "invalidate_prefetch on a tiered pipeline whose cache maps "
                "still carry claims from queued (unapplied) remaps: restore "
                "the tiered checkpoint (Checkpointer(tiered=...)), which "
                "resets the maps, or drain() first")
        self._queue.clear()
        # the dropped entries consumed stream items, and a resume hands
        # over a fresh iterator: the exhaustion flag is void
        self._exhausted = False
        self._last_ios = None
        if self._prefetcher is not None:
            self._prefetcher.invalidate()

    def drain(self) -> List[Any]:
        """Run every QUEUED step to its end (in stream order, without
        refilling) and return their metrics.  Required before a
        checkpoint: queued batches have claimed slots in the host maps,
        so the resident map runs ahead of the device until their IO and
        steps land; each entry's IO and step run as ``progress`` would
        run them, so drain + checkpoint + resume is bit-exact with the
        uninterrupted run.  Afterwards ``self.state`` is the state to
        save."""
        out = []
        while self._queue:
            batch, sig, aux = self._queue.popleft()
            if aux is not None:
                self.state = self._apply_aux(self.state, aux)
            self._cache.stats.record_dispatch(sig)
            step = self._cache.train_program(sig)
            with obs_span("pipeline/step_dispatch", signature=list(sig)), \
                    self._cache.accounting(sig, "train"):
                self.state, metrics = step(self.state, batch)
            self._record_step(batch, metrics)
            out.append(metrics)
        return out

    # -- observability ------------------------------------------------------

    @property
    def collection(self) -> TieredCollection:
        return self._coll

    def scalar_metrics(self, prefix: str = "tiered") -> Dict[str, float]:
        """The cache, IO and prefetch counters
        (``<prefix>/<table>/<counter>``), the bucketing padding counters
        and the last step's guardrail scalars."""
        out = self._coll.scalar_metrics(prefix)
        out.update(self._cache.stats.scalar_metrics(f"{prefix}/bucketing"))
        out.update(TrainPipelineBase.scalar_metrics(self, prefix))
        return out

    def settle(self) -> None:
        """Block until the prefetch worker has finished every stage
        submitted so far (the queued entries' reads; a no-op without
        prefetch)."""
        if self._prefetcher is not None:
            self._prefetcher.settle()

    def close(self) -> None:
        """Stop the prefetch worker (idempotent)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
