"""KJT validation (``torchrec_tpu/sparse/validator.py``): host-side checks
of a batch's invariants with a precise message, run in the input
pipeline before a batch reaches the card (each check reads the buffers
on the host)."""

from __future__ import annotations

from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor


class KjtValidationError(ValueError):
    """A KJT invariant that does not hold."""


def validate_keyed_jagged_tensor(kjt: KeyedJaggedTensor) -> None:
    """Raise :class:`KjtValidationError` on the first violated invariant
    (unique keys, 1-D non-negative lengths covering the per-key strides,
    weights aligned with values, caps covering values, no key over its
    capacity, inverse indices in range); pass silently otherwise."""
    keys = kjt.keys()
    if len(set(keys)) != len(keys):
        raise KjtValidationError(f"duplicate keys: {list(keys)}")
    lengths = kjt.lengths().cpu().numpy()
    if lengths.ndim != 1:
        raise KjtValidationError(
            f"lengths must be 1-D, got shape {lengths.shape}")
    if (lengths < 0).any():
        bad = int((lengths < 0).argmax())
        raise KjtValidationError(
            f"negative length {lengths[bad]} at position {bad}")
    spk = kjt.stride_per_key()
    if lengths.shape[0] != sum(spk):
        raise KjtValidationError(
            f"lengths size {lengths.shape[0]} != sum of per-key strides "
            f"{sum(spk)} ({spk})")
    values = kjt.values()
    weights = kjt.weights_or_none()
    if weights is not None and weights.shape[0] != values.shape[0]:
        raise KjtValidationError(
            f"weights buffer {tuple(weights.shape)} misaligned with values "
            f"{tuple(values.shape)}")
    caps = kjt.caps
    if sum(caps) != values.shape[0]:
        raise KjtValidationError(
            f"caps {caps} do not cover the values buffer "
            f"({values.shape[0]} slots)")
    lo = kjt._length_offsets()
    for f, k in enumerate(keys):
        occ = int(lengths[lo[f]: lo[f + 1]].sum())
        if occ > caps[f]:
            raise KjtValidationError(
                f"key {k}: {occ} ids exceed capacity {caps[f]}")
    inv = kjt.inverse_indices_or_none()
    if inv is not None:
        inv = inv.cpu().numpy()
        if inv.shape[0] != len(keys):
            raise KjtValidationError(
                f"inverse_indices rows {inv.shape[0]} != {len(keys)} keys")
        for f, k in enumerate(keys):
            row = inv[f]
            if row.size and ((row < 0).any() or (row >= max(spk[f], 1)).any()):
                raise KjtValidationError(
                    f"key {k}: inverse_indices out of range [0, {spk[f]}) "
                    f"(got min {row.min()}, max {row.max()})")
