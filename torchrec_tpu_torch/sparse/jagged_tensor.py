"""Ragged sparse data structures (a subset of
``torchrec_tpu/sparse/jagged_tensor.py``: what serving, the train step and
the bucketed train pipeline use).

The layout is the JAX package's static per-key-capacity layout, kept
exactly so that a batch converts element for element between the two
packages: key ``f`` owns ``values[cap_offset[f] : cap_offset[f] +
caps[f]]``, its ids front-packed in example order and the tail padded
with zeros; ``lengths`` is key-major ``[F * B]`` int32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Caps = Union[int, Sequence[int]]


# ---------------------------------------------------------------------------
# capacity bucketing: each key's observed id count rounds up to a rung of a
# small geometric ladder, so padding is bounded by the growth factor while
# the number of distinct capacity signatures stays small
# (``parallel/train_pipeline.py::BucketedStepCache`` keeps one train step
# per signature)
# ---------------------------------------------------------------------------


def bucket_ladder(
    cap: int, floor: int = 8, growth: float = 2.0
) -> Tuple[int, ...]:
    """Capacity rungs for one key: ``floor``, then geometric steps by
    ``growth``, each clipped to the static worst-case ``cap`` (always the
    last rung)."""
    cap = int(cap)
    if cap <= 0:
        return (0,)
    growth = float(growth)
    if growth <= 1.0:
        raise ValueError(f"ladder growth must exceed 1.0, got {growth}")
    rungs = [max(1, min(int(floor), cap))]
    while rungs[-1] < cap:
        rungs.append(min(cap, max(rungs[-1] + 1,
                                  int(np.ceil(rungs[-1] * growth)))))
    return tuple(rungs)


def bucketed_cap(
    occupancy: int, cap: int, floor: int = 8, growth: float = 2.0
) -> int:
    """Round one key's observed id count up to the nearest ladder rung
    (never above the static ``cap``)."""
    occupancy = int(occupancy)
    for r in bucket_ladder(cap, floor, growth):
        if r >= occupancy:
            return r
    return int(cap)


def regroup_request_major(ids: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reorder a request-major flat id buffer into feature-major order.

    ``ids`` is the concatenation of per-(request, feature) id segments in
    request-major order (req0-f0, req0-f1, ..., req1-f0, ...), the
    batching queue's wire layout; ``lengths`` is the ``[n, F]``
    per-request per-feature segment lengths.  Returns the same ids
    grouped feature-major (all of f0's ids in request order, then f1's,
    ...), the :meth:`KeyedJaggedTensor.from_lengths_packed` packing whose
    lengths are ``lengths.T.reshape(-1)``.  Host-side and vectorized:
    one cumsum per layout plus one scatter."""
    lengths = np.asarray(lengths, np.int64)
    n, F = lengths.shape
    seg_req = lengths.reshape(-1)
    V = int(seg_req.sum())
    ids = np.asarray(ids)
    if V == 0:
        return np.zeros((0,), ids.dtype)
    # destination start of segment (i, f) inside the feature-major layout
    dst_start = (
        np.concatenate([[0], np.cumsum(lengths.T.reshape(-1))[:-1]])
        .reshape(F, n)
        .T.reshape(-1)
    )
    src_start = np.concatenate([[0], np.cumsum(seg_req)[:-1]])
    reps = np.repeat(np.arange(n * F), seg_req)
    within = np.arange(V) - src_start[reps]
    out = np.empty((V,), ids.dtype)
    out[dst_start[reps] + within] = ids[:V]
    return out


def _normalize_caps(caps: Caps, num_keys: int) -> Tuple[int, ...]:
    if isinstance(caps, (int, np.integer)):
        return (int(caps),) * num_keys
    caps = tuple(int(c) for c in caps)
    if len(caps) != num_keys:
        raise ValueError(f"{len(caps)} caps for {num_keys} keys")
    return caps


class JaggedTensor:
    """A batch of variable-length sequences: ``values`` ``[cap]``
    front-packed and tail-padded to the static capacity, ``lengths``
    ``[B]`` the true length of each example, optional ``weights``
    aligned with ``values``."""

    __slots__ = ("_values", "_lengths", "_weights")

    def __init__(
        self,
        values: torch.Tensor,
        lengths: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
    ):
        self._values = values
        self._lengths = lengths
        self._weights = weights

    def values(self) -> torch.Tensor:
        return self._values

    def lengths(self) -> torch.Tensor:
        return self._lengths

    def weights_or_none(self) -> Optional[torch.Tensor]:
        return self._weights

    @property
    def capacity(self) -> int:
        return self._values.shape[0]

    def __repr__(self) -> str:
        return (
            f"JaggedTensor(cap={self.capacity}, B={self._lengths.shape[0]}, "
            f"weighted={self._weights is not None})"
        )


class KeyedJaggedTensor:
    """Multi-feature jagged batch with static per-key regions.

    values  : ``[sum(caps)]``; key ``f``'s ids occupy
              ``values[cap_offset[f] : cap_offset[f] + caps[f]]``.
    lengths : ``[F * B]`` int32, key-major (``lengths[f * B + b]``).
    weights : optional, aligned with values.
    """

    __slots__ = ("_keys", "_values", "_lengths", "_weights", "_stride",
                 "_caps")

    def __init__(
        self,
        keys: Sequence[str],
        values: torch.Tensor,
        lengths: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        stride: Optional[int] = None,
        caps: Optional[Caps] = None,
    ):
        self._keys = tuple(keys)
        self._values = values
        self._lengths = lengths
        self._weights = weights
        F = len(self._keys)
        if stride is None:
            if F == 0 or lengths.shape[0] % F:
                raise ValueError(
                    f"{lengths.shape[0]} lengths do not split over {F} keys"
                )
            stride = lengths.shape[0] // F
        self._stride = int(stride)
        if caps is None:
            if F == 0 or values.shape[0] % F:
                raise ValueError(
                    f"{values.shape[0]} values do not split over {F} keys"
                )
            caps = values.shape[0] // F
        self._caps = _normalize_caps(caps, F)
        if sum(self._caps) != values.shape[0]:
            raise ValueError(
                f"caps {self._caps} don't cover values buffer "
                f"{tuple(values.shape)}"
            )

    @staticmethod
    def from_lengths_packed(
        keys: Sequence[str],
        values: np.ndarray,
        lengths: np.ndarray,
        weights: Optional[np.ndarray] = None,
        caps: Optional[Caps] = None,
    ) -> "KeyedJaggedTensor":
        """Host-side: build from the tight packing (one concatenated
        buffer, no padding), repacked into per-key regions on the CPU."""
        keys = tuple(keys)
        F = len(keys)
        values = np.asarray(values)
        lengths = np.asarray(lengths, dtype=np.int32)
        if F == 0 or lengths.shape[0] % F:
            raise ValueError(
                f"{lengths.shape[0]} lengths do not split over {F} keys"
            )
        B = lengths.shape[0] // F
        per_key_tot = lengths.reshape(F, B).sum(axis=1)
        if caps is None:
            caps_t = (int(per_key_tot.max()),) * F
        else:
            caps_t = _normalize_caps(caps, F)
        for f in range(F):
            if per_key_tot[f] > caps_t[f]:
                raise ValueError(
                    f"key {keys[f]}: {per_key_tot[f]} ids exceed capacity "
                    f"{caps_t[f]}"
                )
        out = np.zeros((sum(caps_t),) + values.shape[1:], dtype=values.dtype)
        w_out = None
        if weights is not None:
            weights = np.asarray(weights)
            w_out = np.zeros((sum(caps_t),) + weights.shape[1:],
                             weights.dtype)
        src = dst = 0
        for f in range(F):
            n = int(per_key_tot[f])
            out[dst : dst + n] = values[src : src + n]
            if w_out is not None:
                w_out[dst : dst + n] = weights[src : src + n]
            src += n
            dst += caps_t[f]
        return KeyedJaggedTensor(
            keys,
            torch.from_numpy(out),
            torch.from_numpy(lengths),
            torch.from_numpy(w_out) if w_out is not None else None,
            stride=B,
            caps=caps_t,
        )

    def to(self, device: Union[str, torch.device],
           non_blocking: bool = False) -> "KeyedJaggedTensor":
        """The same batch with every buffer on ``device``."""
        return KeyedJaggedTensor(
            self._keys,
            self._values.to(device, non_blocking=non_blocking),
            self._lengths.to(device, non_blocking=non_blocking),
            None
            if self._weights is None
            else self._weights.to(device, non_blocking=non_blocking),
            stride=self._stride,
            caps=self._caps,
        )

    def keys(self) -> Tuple[str, ...]:
        return self._keys

    def values(self) -> torch.Tensor:
        return self._values

    def lengths(self) -> torch.Tensor:
        return self._lengths

    def weights_or_none(self) -> Optional[torch.Tensor]:
        return self._weights

    def stride(self) -> int:
        return self._stride

    @property
    def caps(self) -> Tuple[int, ...]:
        return self._caps

    def cap_offsets(self) -> Tuple[int, ...]:
        out = [0]
        for c in self._caps:
            out.append(out[-1] + c)
        return tuple(out)

    def length_per_key(self) -> torch.Tensor:
        """``[F]`` total real ids per key."""
        return self._lengths.reshape(len(self._keys), self._stride).sum(dim=1)

    def occupancy_per_key(self) -> Tuple[int, ...]:
        """Real (non-padding) ids per key, as host ints (reads the lengths
        on the host)."""
        return tuple(int(n) for n in self.length_per_key().tolist())

    def bucketed_caps(
        self, floor: int = 8, growth: float = 2.0
    ) -> Tuple[int, ...]:
        """Per-key capacities with each key's occupancy rounded up the
        ladder (:func:`bucketed_cap`) instead of the static worst case."""
        return tuple(
            bucketed_cap(occ, cap, floor, growth)
            for occ, cap in zip(self.occupancy_per_key(), self._caps)
        )

    def repad(self, caps: Caps) -> "KeyedJaggedTensor":
        """The same ids and lengths under other per-key capacities.
        Growing a capacity pads with zeros; shrinking one truncates the
        key's region, and raises if that would drop a real id."""
        new_caps = _normalize_caps(caps, len(self._keys))
        for k, occ, nc in zip(self._keys, self.occupancy_per_key(),
                              new_caps):
            if occ > nc:
                raise ValueError(f"repad would drop data for key {k}: "
                                 f"occupancy {occ} > new cap {nc}")

        def relayout(buf: torch.Tensor) -> torch.Tensor:
            out = buf.new_zeros((sum(new_caps),) + tuple(buf.shape[1:]))
            src, dst = self.cap_offsets(), 0
            for f, nc in enumerate(new_caps):
                n = min(nc, self._caps[f])
                out[dst: dst + n] = buf[src[f]: src[f] + n]
                dst += nc
            return out

        return KeyedJaggedTensor(
            self._keys, relayout(self._values), self._lengths,
            None if self._weights is None else relayout(self._weights),
            stride=self._stride, caps=new_caps,
        )

    def to_dict(self) -> Dict[str, JaggedTensor]:
        """key -> that key's :class:`JaggedTensor`."""
        return {k: self[k] for k in self._keys}

    def __getitem__(self, key: str) -> JaggedTensor:
        f = self._keys.index(key)
        offs = self.cap_offsets()
        s, e = offs[f], offs[f + 1]
        B = self._stride
        w = None if self._weights is None else self._weights[s:e]
        return JaggedTensor(
            self._values[s:e], self._lengths[f * B : (f + 1) * B], w
        )

    def __repr__(self) -> str:
        return (
            f"KeyedJaggedTensor(keys={list(self._keys)}, B={self._stride}, "
            f"caps={self._caps}, weighted={self._weights is not None})"
        )


class KeyedTensor:
    """Dense ``[B, sum(dims)]`` concat of per-key embeddings with a static
    key -> column-range map."""

    __slots__ = ("_keys", "_length_per_key", "_values")

    def __init__(
        self,
        keys: Sequence[str],
        length_per_key: Sequence[int],
        values: torch.Tensor,
    ):
        self._keys = tuple(keys)
        self._length_per_key = tuple(int(d) for d in length_per_key)
        self._values = values
        if values.shape[-1] != sum(self._length_per_key):
            raise ValueError(
                f"values {tuple(values.shape)} vs dims {self._length_per_key}"
            )

    def keys(self) -> Tuple[str, ...]:
        return self._keys

    def values(self) -> torch.Tensor:
        return self._values

    def length_per_key(self) -> Tuple[int, ...]:
        return self._length_per_key

    def offset_per_key(self) -> Tuple[int, ...]:
        """Column offsets of the keys: ``(0, d0, d0 + d1, ...)``."""
        out = [0]
        for d in self._length_per_key:
            out.append(out[-1] + d)
        return tuple(out)

    def __repr__(self) -> str:
        return f"KeyedTensor(keys={list(self._keys)}, dims={self._length_per_key})"
