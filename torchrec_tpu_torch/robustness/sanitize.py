"""The traced guardrail tier (``torchrec_tpu/robustness/sanitize.py``):
null-row id remapping on the device, inside the step.

A corrupt upstream id (vocabulary drift past ``num_embeddings``, a sign
bug) must not train some other row.  :func:`sanitize_kjt` applies
``ops/embedding_ops.py::sanitize_ids`` per key region of a
``KeyedJaggedTensor``: invalid ids among the real (non-padding) slots
become id 0 with weight 0, the functional null row whose pooled
contribution is exactly ``+0.0`` and which takes no gradient (every
backward multiplies by the slot's weight, and the dedup'd row-wise dist
drops such slots before the wire).  The per-key counts come back as a
``[F]`` int32 tensor on the device, which the train step reports as its
``id_violations`` metric; nothing is read on the host.

The remap happens on the KJT before any input dist, so it composes with
every lookup path unchanged.  On clean input the sanitized KJT holds the
input's bits; unit weights are synthesised where the input had none, so
an unweighted batch reaches the weighted kernel instantiations, whose
product with 1.0 is exact.
"""

from __future__ import annotations

import functools
from typing import Mapping, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor

# keys with no registered table bound get the negativity check only
_NO_BOUND = (1 << 31) - 1


def _slot_constants(caps, rows) -> Tuple[np.ndarray, np.ndarray]:
    """Per slot of a KJT buffer with per-key capacities ``caps``: (its
    key's id bound from ``rows``, its key index), host int32 arrays."""
    if not caps:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    bounds = np.concatenate([np.full(cap, r, np.int32)
                             for r, cap in zip(rows, caps)])
    key_of = np.concatenate([np.full(cap, f, np.int32)
                             for f, cap in enumerate(caps)])
    return bounds, key_of


@functools.lru_cache(maxsize=64)
def _device_constants(caps, rows, device) -> Tuple[torch.Tensor, ...]:
    """On ``device``, once per layout (a bucketed pipeline has a few), so a
    step copies nothing to the card: each slot's bound, key and position
    in its key's region, and the regions' offsets."""
    bounds, key_of = _slot_constants(caps, rows)
    pos = np.concatenate([np.arange(cap) for cap in caps])
    offsets = np.concatenate([[0], np.cumsum(caps)])
    return tuple(torch.from_numpy(a).to(device, dtype)
                 for a, dtype in ((bounds, torch.int32),
                                  (key_of, torch.int64),
                                  (pos, torch.int64),
                                  (offsets, torch.int64)))


def sanitize_kjt(
    kjt: KeyedJaggedTensor,
    rows_per_key: Mapping[str, int],
) -> Tuple[KeyedJaggedTensor, torch.Tensor]:
    """Remap invalid ids to the null row (id 0, weight 0) and count them.

    ``rows_per_key``: feature name -> the table's ``num_embeddings``;
    keys absent from it get the negativity check only.  Returns
    ``(sanitized KJT, violations)``: ``violations`` is the ``[F]`` int32
    count of invalid ids per key among the real slots (a key's real ids
    are the front of its region, as many as its lengths sum to; padding
    is neither touched nor counted).  The sanitized KJT always carries
    float32 weights.  No host sync, no atomics: the counts are
    differences of one running sum at the regions' ends."""
    values = kjt.values()
    dev = values.device
    F = kjt.num_keys
    if F == 0:
        return kjt, torch.zeros((0,), dtype=torch.int32, device=dev)
    bounds, key_of, pos, offsets = _device_constants(
        tuple(kjt.caps),
        tuple(int(rows_per_key.get(k, _NO_BOUND)) for k in kjt.keys()), dev)
    # the vector-bound form of sanitize_ids: each slot against its own
    # key's rows, and only the real slots
    real = pos < kjt.length_per_key().to(torch.int64)[key_of]
    bad = ((values < 0) | (values >= bounds)) & real
    ends = torch.cat([bad.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(bad, 0)])
    violations = (ends[offsets[1:]] - ends[offsets[:-1]]).to(torch.int32)
    w = kjt.weights_or_none()
    if w is None:
        w = torch.ones(values.shape, dtype=torch.float32, device=dev)
    return (kjt.with_values(torch.where(bad, torch.zeros_like(values),
                                        values),
                            torch.where(bad, torch.zeros_like(w), w)),
            violations)
