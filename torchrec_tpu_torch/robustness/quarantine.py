"""Quarantine store (``torchrec_tpu/robustness/quarantine.py``): crash-safe
persistence of rejected batches.

Under the ``QUARANTINE`` guardrail policy a batch that fails validation
is neither trained on nor silently dropped: it is written here (its
arrays and a machine-readable diagnosis) for an operator to triage and
replay.  An entry is ``q_{seq}.npz`` (the arrays) and ``q_{seq}.json``
(keys, caps, stride and the diagnosis), each written to a temporary file
and renamed into place, the report last: an entry without its report is
torn and invisible.  The store keeps at most ``max_entries``, dropping
the oldest first.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class QuarantineStore:
    """Bounded on-disk store of quarantined batches in ``directory``
    (created if missing)."""

    def __init__(self, directory: str, max_entries: int = 100):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_entries = max_entries
        self._seq = self._next_seq()

    def _next_seq(self) -> int:
        seqs = [int(n[2:8]) for n in os.listdir(self.directory)
                if n.startswith("q_") and n.endswith(".json")
                and n[2:8].isdigit()]
        return max(seqs, default=-1) + 1

    def entries(self) -> List[str]:
        """Committed entry names (``q_NNNNNN``), oldest first."""
        return sorted(n[:-5] for n in os.listdir(self.directory)
                      if n.startswith("q_") and n.endswith(".json"))

    def __len__(self) -> int:
        return len(self.entries())

    def put(self, batch: Batch, diagnosis: Dict[str, Any]) -> str:
        """Write one batch and its diagnosis; returns the entry name."""
        name = f"q_{self._seq:06d}"
        self._seq += 1
        kjt = batch.sparse_features
        arrays: Dict[str, np.ndarray] = {
            "dense_features": _host(batch.dense_features),
            "labels": _host(batch.labels),
            "kjt_values": _host(kjt.values()),
            "kjt_lengths": _host(kjt.lengths()),
        }
        if batch.weights is not None:
            arrays["weights"] = _host(batch.weights)
        if kjt.weights_or_none() is not None:
            arrays["kjt_weights"] = _host(kjt.weights_or_none())
        inv = kjt.inverse_indices_or_none()
        if inv is not None:
            arrays["kjt_inverse_indices"] = _host(inv)
        npz = os.path.join(self.directory, f"{name}.npz")
        with open(npz + ".tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(npz + ".tmp", npz)
        report = {
            "name": name, "time": time.time(), "diagnosis": diagnosis,
            "keys": list(kjt.keys()), "caps": list(kjt.caps),
            "stride": kjt.stride(),
            # the variable-batch structure, without which a load would
            # rebuild a uniform-stride batch
            "stride_per_key": (list(kjt.stride_per_key())
                               if kjt.variable_stride_per_key else None),
        }
        rpt = os.path.join(self.directory, f"{name}.json")
        with open(rpt + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(rpt + ".tmp", rpt)
        self._gc()
        return name

    def load(self, name: str) -> Tuple[Batch, Dict[str, Any]]:
        """A quarantined batch (on the CPU, still corrupt) and its
        report."""
        with open(os.path.join(self.directory, f"{name}.json")) as f:
            report = json.load(f)
        with np.load(os.path.join(self.directory, f"{name}.npz")) as z:
            a = {k: torch.from_numpy(z[k]) for k in z.files}
        kjt = KeyedJaggedTensor(
            report["keys"], a["kjt_values"], a["kjt_lengths"],
            a.get("kjt_weights"), stride=report["stride"],
            caps=report["caps"], stride_per_key=report.get("stride_per_key"),
            inverse_indices=a.get("kjt_inverse_indices"))
        return Batch(a["dense_features"], kjt, a["labels"],
                     a.get("weights")), report

    def _gc(self) -> None:
        names = self.entries()
        for name in names[:max(0, len(names) - self.max_entries)]:
            for ext in (".json", ".npz"):
                try:
                    os.remove(os.path.join(self.directory, name + ext))
                except OSError:
                    pass
