"""The host guardrail tier (``torchrec_tpu/robustness/policy.py``): schema
validation of a batch and the policy that acts on it, before the batch
reaches the card.

Three policies over one diagnosis:

* ``STRICT`` raises :class:`InputGuardrailError` naming the offending key
  (development and CI: corrupt data is a bug);
* ``SANITIZE`` repairs the batch on the host (non-finite dense features,
  labels and weights to 0, negative lengths to 0, over-capacity lengths
  truncated, invalid ids to the null row) and counts it;
* ``QUARANTINE`` writes the batch and its diagnosis to a
  :class:`~torchrec_tpu_torch.robustness.quarantine.QuarantineStore`,
  skips it and goes on.

:class:`InputGuardrails` is the engine, :class:`GuardedIterator` applies
it to a batch stream, and :class:`GuardrailsConfig` is the one knob
surface, which ``DistributedModelParallel(guardrails=...)`` also reads
(``traced_sanitize`` turns on the traced tier,
``robustness/sanitize.py``).  The checks read the batch's tensors on the
host (numpy), as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.robustness.quarantine import QuarantineStore
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor
from torchrec_tpu_torch.sparse.validator import (
    KjtValidationError,
    validate_keyed_jagged_tensor,
)
from torchrec_tpu_torch.utils.profiling import counter_key


class GuardrailPolicy(enum.Enum):
    """What to do with a batch that fails validation."""

    STRICT = "strict"
    SANITIZE = "sanitize"
    QUARANTINE = "quarantine"


@dataclasses.dataclass(frozen=True)
class GuardrailsConfig:
    """The guardrail knobs: ``policy`` the host tier's, ``traced_sanitize``
    the traced tier on the DMP, ``quarantine_dir`` where QUARANTINE
    writes (required for it), ``max_quarantined`` the store's bound,
    ``check_dense`` / ``check_labels`` the finiteness checks."""

    policy: GuardrailPolicy = GuardrailPolicy.SANITIZE
    traced_sanitize: bool = True
    quarantine_dir: Optional[str] = None
    max_quarantined: int = 100
    check_dense: bool = True
    check_labels: bool = True


class InputGuardrailError(ValueError):
    """A STRICT rejection; the message is the diagnosis."""


@dataclasses.dataclass
class Diagnosis:
    """One validation failure: its ``kind``, the offending ``key`` where
    one is, its ``count`` and a human-readable ``message``."""

    kind: str
    message: str
    key: Optional[str] = None
    count: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


def _finite_violations(arr: np.ndarray) -> int:
    if arr.dtype.kind not in "fc":
        return 0
    return int((~np.isfinite(arr)).sum())


class InputGuardrails:
    """The policy engine: :meth:`diagnose` a host batch, then enforce
    (:meth:`apply`).

    ``feature_rows``: feature name -> the table's ``num_embeddings`` (keys
    absent get the negativity check only); ``quarantine``: a store, by
    default one in ``config.quarantine_dir`` when the policy needs it.
    Host counters (:meth:`scalar_metrics`): batches checked, sanitized and
    quarantined, and the violations by kind."""

    def __init__(
        self,
        config: GuardrailsConfig,
        feature_rows: Optional[Mapping[str, int]] = None,
        quarantine: Optional[QuarantineStore] = None,
    ):
        self.config = config
        self.feature_rows = dict(feature_rows or {})
        self.quarantine = quarantine
        if (self.quarantine is None
                and config.policy == GuardrailPolicy.QUARANTINE):
            if not config.quarantine_dir:
                raise ValueError("QUARANTINE policy needs quarantine_dir (or "
                                 "a QuarantineStore)")
            self.quarantine = QuarantineStore(config.quarantine_dir,
                                              config.max_quarantined)
        self.batches_checked = 0
        self.sanitized_batches = 0
        self.quarantined_batches = 0
        self.violations_by_kind: Dict[str, int] = {}

    def diagnose(self, batch: Batch) -> Optional[Diagnosis]:
        """The first violated invariant, or None for a clean batch.  In
        order: the KJT's schema (``sparse/validator.py``), the id dtype,
        each key's ids against its table's rows, then the finiteness of
        the dense features, the labels and the per-example weights."""
        kjt = batch.sparse_features
        try:
            validate_keyed_jagged_tensor(kjt)
        except KjtValidationError as e:
            return Diagnosis(kind="schema", message=str(e))
        values = _np(kjt.values())
        if values.dtype.kind not in "iu":
            return Diagnosis(
                kind="dtype",
                message=(f"id values must be integer, got {values.dtype}: "
                         "the lookup would truncate them"))
        lengths = _np(kjt.lengths())
        lo, co = kjt._length_offsets(), kjt.cap_offsets()
        for f, k in enumerate(kjt.keys()):
            occ = int(lengths[lo[f]:lo[f + 1]].sum())
            real = values[co[f]:co[f] + occ]
            if real.size == 0:
                continue
            neg = int((real < 0).sum())
            if neg:
                return Diagnosis(
                    kind="negative_ids", key=k, count=neg,
                    message=(f"key {k}: {neg} negative ids (min "
                             f"{int(real.min())})"))
            rows = self.feature_rows.get(k)
            if rows is not None:
                oob = int((real >= rows).sum())
                if oob:
                    return Diagnosis(
                        kind="oob_ids", key=k, count=oob,
                        message=(f"key {k}: {oob} ids >= num_embeddings "
                                 f"{rows} (max {int(real.max())})"))
        if self.config.check_dense:
            n = _finite_violations(_np(batch.dense_features))
            if n:
                return Diagnosis(
                    kind="nonfinite_dense", count=n,
                    message=(f"{n} non-finite dense feature values: one NaN "
                             "poisons the whole step's gradients"))
        if self.config.check_labels:
            n = _finite_violations(_np(batch.labels))
            if n:
                return Diagnosis(kind="nonfinite_labels", count=n,
                                 message=f"{n} non-finite label values")
        if batch.weights is not None:
            n = _finite_violations(_np(batch.weights))
            if n:
                return Diagnosis(kind="nonfinite_weights", count=n,
                                 message=f"{n} non-finite per-example weights")
        return None

    def sanitize(self, batch: Batch) -> Batch:
        """The host repair, mirroring the traced tier: non-finite floats
        to 0, negative lengths to 0, over-capacity lengths truncated,
        invalid ids nulled.  A weighted batch's invalid slots become the
        traced tier's null sentinel (id 0, weight 0); an unweighted
        batch's invalid ids are compacted out of their bags (a removed id
        adds exactly +0.0 too), so a repaired batch keeps the structure of
        its clean neighbours.  Float ids that are integral and finite cast
        exactly; any other becomes an invalid id.  A key whose lengths
        claim more ids than its region holds is nulled entirely (weights
        zeroed, or every bag emptied): past that lie nothing in its region
        can be trusted, and truncation would promote padding into real
        id-0 lookups.  The tensors come back on the batch's device."""
        kjt = batch.sparse_features
        dev = kjt.values().device
        lengths = np.maximum(_np(kjt.lengths()).copy(), 0)
        values = _np(kjt.values())
        if values.dtype.kind in "iu":
            values = values.copy()
        elif values.dtype.kind == "f":
            exact = (np.isfinite(values) & (np.floor(values) == values)
                     & (np.abs(values) < float(1 << 62)))
            values = np.where(exact, values, -1.0).astype(np.int64)
        else:
            values = np.full(values.shape, -1, np.int64)
        w = kjt.weights_or_none()
        weights = None if w is None else _np(w).astype(np.float32).copy()
        lo, co, caps = kjt._length_offsets(), kjt.cap_offsets(), kjt.caps
        for f, k in enumerate(kjt.keys()):
            lens = lengths[lo[f]:lo[f + 1]]
            start = np.cumsum(lens) - lens
            lied = int(lens.sum()) > caps[f]
            lens[:] = np.clip(
                np.minimum(lens, caps[f] - np.minimum(start, caps[f])), 0,
                None)
            occ = int(lens.sum())
            if lied:
                values[co[f]:co[f] + occ] = 0
                if weights is not None:
                    weights[co[f]:co[f] + occ] = 0.0
                else:
                    lens[:] = 0  # every bag empties: pools exactly +0.0
                continue
            real = values[co[f]:co[f] + occ]
            rows = self.feature_rows.get(k, 1 << 31)
            bad = (real < 0) | (real >= rows)
            if weights is not None:
                real[bad] = 0
                weights[co[f]:co[f] + occ][bad] = 0.0
            elif bad.any():
                bag = np.repeat(np.arange(lens.size), lens)
                survivors = real[~bad]
                lens[:] = np.bincount(bag[~bad], minlength=lens.size
                                      ).astype(lens.dtype)
                region = np.zeros(occ, dtype=values.dtype)
                region[:survivors.size] = survivors
                values[co[f]:co[f] + occ] = region

        def fix(t):
            a = _np(t)
            if a.dtype.kind in "fc":
                a = np.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
            return torch.from_numpy(np.ascontiguousarray(a)).to(t.device)

        new_kjt = KeyedJaggedTensor(
            kjt.keys(), torch.from_numpy(values).to(dev),
            torch.from_numpy(lengths).to(dev),
            None if weights is None else torch.from_numpy(weights).to(dev),
            stride=kjt.stride(), caps=caps,
            stride_per_key=(kjt.stride_per_key()
                            if kjt.variable_stride_per_key else None),
            inverse_indices=kjt.inverse_indices_or_none())
        return dataclasses.replace(
            batch, dense_features=fix(batch.dense_features),
            sparse_features=new_kjt, labels=fix(batch.labels),
            weights=None if batch.weights is None else fix(batch.weights))

    def apply(self, batch: Batch) -> Optional[Batch]:
        """Enforce the policy on one batch: the batch (repaired under
        SANITIZE) to train on, or None when it was quarantined; STRICT
        raises :class:`InputGuardrailError`."""
        self.batches_checked += 1
        d = self.diagnose(batch)
        if d is None:
            return batch
        self.violations_by_kind[d.kind] = (
            self.violations_by_kind.get(d.kind, 0) + d.count)
        if self.config.policy == GuardrailPolicy.STRICT:
            raise InputGuardrailError(d.message)
        if self.config.policy == GuardrailPolicy.SANITIZE:
            self.sanitized_batches += 1
            return self.sanitize(batch)
        self.quarantined_batches += 1
        if self.quarantine is not None:
            self.quarantine.put(batch, d.to_dict())
        return None

    @staticmethod
    def step_violations(metrics: Any) -> Optional[int]:
        """A step's ``id_violations`` total (reads the device), or None
        when its metrics carry none."""
        if not isinstance(metrics, dict):
            return None
        v = metrics.get("id_violations")
        if v is None:
            return None
        return int(_np(v).sum())

    def attribute_bad_step(self, metrics: Any, baseline: int = 0) -> bool:
        """Whether a non-finite step is the data's fault: its traced
        ``id_violations`` exceed ``baseline``, the stream's routine level
        over recent finite steps (ids the sanitizer nulled routinely
        cannot have caused the blow-up)."""
        v = self.step_violations(metrics)
        return v is not None and v > baseline

    def scalar_metrics(self, prefix: str = "guardrails") -> Dict[str, float]:
        """The host counters, flat."""
        out = {
            f"{prefix}/batches_checked": float(self.batches_checked),
            f"{prefix}/sanitized_batches": float(self.sanitized_batches),
            f"{prefix}/quarantined_batches": float(self.quarantined_batches),
        }
        for kind, n in self.violations_by_kind.items():
            out[counter_key(prefix, "violations", kind)] = float(n)
        return out


class GuardedIterator:
    """A batch stream through an :class:`InputGuardrails` engine: yields
    the batches that passed or were repaired, skips quarantined ones, and
    lets STRICT's error through."""

    def __init__(self, it: Iterator[Batch], guardrails: InputGuardrails):
        self._it = iter(it)
        self._g = guardrails

    def __iter__(self) -> "GuardedIterator":
        return self

    def __next__(self) -> Batch:
        while True:
            batch = next(self._it)  # StopIteration ends the stream
            with span("guardrails/validate"):
                out = self._g.apply(batch)
            if out is not None:
                return out
