"""Ragged sparse data structures (``torchrec_tpu/sparse/jagged_tensor.py``).

The layout is the JAX package's static per-key-capacity layout, kept
exactly so that a batch converts element for element between the two
packages: key ``f`` owns ``values[cap_offset[f] : cap_offset[f] +
caps[f]]``, its ids front-packed in example order and the tail padded
with zeros; ``lengths`` is key-major ``[F * B]`` int32 (with per-key
strides under a variable batch).  Left out: ``JaggedTensor``'s dense
constructors and host converters (``from_dense``, ``to_dense``, ...), the
KJT's reference-name aliases (``from_lengths_sync``, ``sync``,
``offset_per_key``, ...) and the pytree registration.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

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


def _cumsum0(t: torch.Tensor) -> torch.Tensor:
    """Offsets with a leading zero, in ``t``'s dtype: ``[0, t0, t0 + t1,
    ...]``."""
    return torch.cat([t.new_zeros((1,)), torch.cumsum(t, 0, dtype=t.dtype)])


class JaggedTensor:
    """A batch of variable-length sequences: ``values`` ``[cap]`` (or
    ``[cap, D]``) front-packed and tail-padded to the static capacity,
    ``lengths`` ``[B]`` the true length of each example, optional
    ``weights`` aligned with ``values``."""

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

    def offsets(self) -> torch.Tensor:
        """``[B + 1]`` start of each example in ``values``."""
        return _cumsum0(self._lengths)

    def total(self) -> torch.Tensor:
        """The number of real (non-padding) elements, a 0-d tensor."""
        return self._lengths.sum()

    def valid_mask(self) -> torch.Tensor:
        """``[cap]`` bool: True where the buffer holds a real element."""
        pos = torch.arange(self.capacity, device=self._values.device)
        return pos < self.total()

    def to_padded_dense(
        self,
        desired_length: Optional[int] = None,
        padding_value: float = 0.0,
    ) -> torch.Tensor:
        """``[B, L(, D)]`` with each row's tail padded by
        ``padding_value``; ``L`` defaults to the capacity, and a row
        longer than ``L`` is cut."""
        B = self._lengths.shape[0]
        L = self.capacity if desired_length is None else int(desired_length)
        tail = tuple(self._values.shape[1:])
        if self.capacity == 0 or L == 0:
            return torch.full((B, L) + tail, padding_value,
                              dtype=self._values.dtype,
                              device=self._values.device)
        j = torch.arange(L, device=self._values.device)
        idx = (self.offsets()[:B, None] + j[None, :]).clamp(
            0, self.capacity - 1)
        valid = j[None, :] < self._lengths[:, None]
        gathered = self._values[idx]
        if gathered.dim() == 3:
            valid = valid[:, :, None]
        return torch.where(
            valid, gathered,
            torch.tensor(padding_value, dtype=self._values.dtype,
                         device=self._values.device))

    def __repr__(self) -> str:
        return (
            f"JaggedTensor(cap={self.capacity}, B={self._lengths.shape[0]}, "
            f"weighted={self._weights is not None})"
        )


class KeyedJaggedTensor:
    """Multi-feature jagged batch with static per-key regions.

    values  : ``[sum(caps)]``; key ``f``'s ids occupy
              ``values[cap_offset[f] : cap_offset[f] + caps[f]]``.
    lengths : ``[sum(stride_per_key)]`` int32, key-major; with a uniform
              stride ``B`` that is ``[F * B]`` (``lengths[f * B + b]``).
    weights : optional, aligned with values.

    A variable-batch (VBE) KJT gives each key its own stride
    (``stride_per_key``) and may carry ``inverse_indices`` ``[F, B]``:
    for each example of the full batch, its row in the key's reduced
    batch."""

    __slots__ = ("_keys", "_values", "_lengths", "_weights", "_stride",
                 "_caps", "_stride_per_key", "_inverse_indices")

    def __init__(
        self,
        keys: Sequence[str],
        values: torch.Tensor,
        lengths: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        stride: Optional[int] = None,
        caps: Optional[Caps] = None,
        stride_per_key: Optional[Sequence[int]] = None,
        inverse_indices: Optional[torch.Tensor] = None,
    ):
        self._keys = tuple(keys)
        self._values = values
        self._lengths = lengths
        self._weights = weights
        F = len(self._keys)
        if stride_per_key is not None:
            spk = tuple(int(s) for s in stride_per_key)
            if len(spk) != F or sum(spk) != lengths.shape[0]:
                raise ValueError(f"lengths {tuple(lengths.shape)} vs per-key "
                                 f"strides {spk} of {F} keys")
            self._stride_per_key = spk
            # the full batch: explicit, else the inverse indices' width,
            # else the largest key stride
            if stride is None:
                stride = (inverse_indices.shape[1]
                          if inverse_indices is not None
                          else max(spk, default=0))
        else:
            self._stride_per_key = None
            if stride is None:
                if F == 0 or lengths.shape[0] % F:
                    raise ValueError(
                        f"{lengths.shape[0]} lengths do not split over {F} "
                        "keys"
                    )
                stride = lengths.shape[0] // F
        self._stride = int(stride)
        self._inverse_indices = inverse_indices
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

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_lengths_packed(
        keys: Sequence[str],
        values: np.ndarray,
        lengths: np.ndarray,
        weights: Optional[np.ndarray] = None,
        caps: Optional[Caps] = None,
        stride_per_key: Optional[Sequence[int]] = None,
        inverse_indices: Optional[np.ndarray] = None,
    ) -> "KeyedJaggedTensor":
        """Host-side: build from the tight packing (one concatenated
        buffer, no padding), repacked into per-key regions on the CPU.
        ``stride_per_key`` (and optionally ``inverse_indices`` ``[F,
        B]``) make a variable-batch KJT."""
        keys = tuple(keys)
        F = len(keys)
        values = np.asarray(values)
        lengths = np.asarray(lengths, dtype=np.int32)
        if stride_per_key is not None:
            spk = [int(s) for s in stride_per_key]
            if len(spk) != F or sum(spk) != lengths.shape[0]:
                raise ValueError(f"{lengths.shape[0]} lengths vs per-key "
                                 f"strides {spk}")
            lo = np.cumsum([0] + spk)
            per_key_tot = np.asarray(
                [lengths[lo[f]: lo[f + 1]].sum() for f in range(F)])
            B = (int(np.asarray(inverse_indices).shape[1])
                 if inverse_indices is not None else max(spk, default=0))
        else:
            spk = None
            if F == 0 or lengths.shape[0] % F:
                raise ValueError(
                    f"{lengths.shape[0]} lengths do not split over {F} keys"
                )
            B = lengths.shape[0] // F
            per_key_tot = lengths.reshape(F, B).sum(axis=1)
        if caps is None:
            caps_t = (int(per_key_tot.max()) if F else 0,) * F
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
            stride_per_key=spk,
            inverse_indices=(
                None if inverse_indices is None
                else torch.from_numpy(np.asarray(inverse_indices, np.int32))
            ),
        )

    @staticmethod
    def from_offsets_packed(
        keys: Sequence[str],
        values: np.ndarray,
        offsets: np.ndarray,
        weights: Optional[np.ndarray] = None,
        caps: Optional[Caps] = None,
    ) -> "KeyedJaggedTensor":
        """:meth:`from_lengths_packed` from ``[F * B + 1]`` offsets."""
        lengths = np.diff(np.asarray(offsets)).astype(np.int32)
        return KeyedJaggedTensor.from_lengths_packed(keys, values, lengths,
                                                     weights, caps)

    @staticmethod
    def from_jt_dict(d: Mapping[str, JaggedTensor]) -> "KeyedJaggedTensor":
        """Host-side: one KJT from per-key JaggedTensors of one batch size,
        each key's capacity kept; all keys weighted or none."""
        keys = list(d)
        if not keys:
            raise ValueError("from_jt_dict needs at least one key")
        strides = {d[k].lengths().shape[0] for k in keys}
        if len(strides) != 1:
            raise ValueError(f"all keys must share one batch size, got "
                             f"{strides}")
        weighted = [k for k in keys if d[k].weights_or_none() is not None]
        if weighted and len(weighted) != len(keys):
            raise ValueError(
                "from_jt_dict needs all keys weighted or none weighted; "
                f"weighted={sorted(weighted)} of {keys}"
            )
        vals, lens, caps, ws = [], [], [], []
        for k in keys:
            jt = d[k]
            ln = jt.lengths().cpu().numpy()
            n = int(ln.sum())
            vals.append(jt.values().cpu().numpy()[:n])
            lens.append(ln)
            caps.append(jt.capacity)
            if weighted:
                ws.append(jt.weights_or_none().cpu().numpy()[:n])
        return KeyedJaggedTensor.from_lengths_packed(
            keys, np.concatenate(vals), np.concatenate(lens),
            np.concatenate(ws) if weighted else None, caps=caps)

    @staticmethod
    def empty(dtype: torch.dtype = torch.int32) -> "KeyedJaggedTensor":
        """No keys, no values, batch 0."""
        return KeyedJaggedTensor(
            (), torch.zeros((0,), dtype=dtype),
            torch.zeros((0,), dtype=torch.int32), stride=0, caps=())

    @staticmethod
    def empty_like(kjt: "KeyedJaggedTensor") -> "KeyedJaggedTensor":
        """The same keys, caps and strides with every length 0 (the
        buffers keep their full capacity, all padding)."""
        w = kjt.weights_or_none()
        return KeyedJaggedTensor(
            kjt.keys(), torch.zeros_like(kjt.values()),
            torch.zeros_like(kjt.lengths()),
            None if w is None else torch.zeros_like(w),
            stride=kjt.stride(), caps=kjt.caps,
            stride_per_key=kjt._stride_per_key,
            inverse_indices=kjt.inverse_indices_or_none())

    @staticmethod
    def concat(kjts: Sequence["KeyedJaggedTensor"]) -> "KeyedJaggedTensor":
        """Concatenate along keys.  All must share the full batch; an
        unweighted part gets weight 1 beside a weighted one, and a uniform
        part the identity expansion beside a variable-batch one."""
        kjts = [k for k in kjts if k.num_keys]
        if not kjts:
            return KeyedJaggedTensor.empty()
        stride = kjts[0].stride()
        if any(k.stride() != stride for k in kjts):
            raise ValueError(f"concat of strides "
                             f"{[k.stride() for k in kjts]}")
        keys = tuple(x for k in kjts for x in k.keys())
        caps = tuple(c for k in kjts for c in k.caps)
        values = torch.cat([k.values() for k in kjts])
        lengths = torch.cat([k.lengths() for k in kjts])
        weights = None
        if any(k.weights_or_none() is not None for k in kjts):
            weights = torch.cat([
                torch.ones(k.values().shape, dtype=torch.float32,
                           device=k.values().device)
                if k.weights_or_none() is None else k.weights_or_none()
                for k in kjts])
        spk = inv = None
        if any(k.variable_stride_per_key for k in kjts):
            spk = tuple(s for k in kjts for s in k.stride_per_key())
            rows = []
            for k in kjts:
                ki = k.inverse_indices_or_none()
                if ki is None:  # a uniform part: the identity expansion
                    ki = torch.arange(stride, dtype=torch.int32,
                                      device=k.lengths().device).expand(
                        k.num_keys, stride)
                rows.append(ki)
            inv = torch.cat(rows, dim=0)
        return KeyedJaggedTensor(keys, values, lengths, weights, stride,
                                 caps, stride_per_key=spk,
                                 inverse_indices=inv)

    def to(self, device: Union[str, torch.device],
           non_blocking: bool = False) -> "KeyedJaggedTensor":
        """The same batch with every buffer on ``device``."""

        def move(t):
            return None if t is None else t.to(device,
                                               non_blocking=non_blocking)

        return KeyedJaggedTensor(
            self._keys, move(self._values), move(self._lengths),
            move(self._weights), stride=self._stride, caps=self._caps,
            stride_per_key=self._stride_per_key,
            inverse_indices=move(self._inverse_indices),
        )

    # -- accessors ---------------------------------------------------------

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
    def num_keys(self) -> int:
        return len(self._keys)

    @property
    def caps(self) -> Tuple[int, ...]:
        return self._caps

    def cap_offsets(self) -> Tuple[int, ...]:
        out = [0]
        for c in self._caps:
            out.append(out[-1] + c)
        return tuple(out)

    def stride_per_key(self) -> Tuple[int, ...]:
        """Each key's batch size (the full stride unless variable)."""
        if self._stride_per_key is not None:
            return self._stride_per_key
        return (self._stride,) * self.num_keys

    @property
    def variable_stride_per_key(self) -> bool:
        return self._stride_per_key is not None

    def inverse_indices_or_none(self) -> Optional[torch.Tensor]:
        return self._inverse_indices

    def inverse_indices(self) -> torch.Tensor:
        """The variable-batch expansion map ``[F, B]``; raises when the
        KJT has none."""
        if self._inverse_indices is None:
            raise ValueError("inverse indices are not set on this KJT")
        return self._inverse_indices

    def _length_offsets(self) -> Tuple[int, ...]:
        """Start of each key's lengths in ``lengths`` (``[F + 1]``)."""
        out = [0]
        for s in self.stride_per_key():
            out.append(out[-1] + s)
        return tuple(out)

    def lengths_for_key(self, f: int) -> torch.Tensor:
        lo = self._length_offsets()
        return self._lengths[lo[f]: lo[f + 1]]

    def length_per_key(self) -> torch.Tensor:
        """``[F]`` total real ids per key."""
        if not self.variable_stride_per_key:
            return self._lengths.reshape(self.num_keys, self._stride).sum(
                dim=1)
        if not self.num_keys:
            return self._lengths.new_zeros((0,), dtype=torch.int64)
        return torch.stack([self.lengths_for_key(f).sum()
                            for f in range(self.num_keys)])

    @property
    def total_stride(self) -> int:
        """Example slots across keys (``F * B`` with a uniform stride):
        the segment count of a pooled lookup and the padding sentinel of
        :meth:`segment_ids`."""
        return sum(self.stride_per_key())

    def segment_ids(self) -> torch.Tensor:
        """``[sum(caps)]`` int32: each buffer slot's example segment
        (``length_offset[f] + b``; ``f * B + b`` with a uniform stride),
        or :attr:`total_stride` for a padding slot."""
        lo = self._length_offsets()
        total = self.total_stride
        dev = self._lengths.device
        pieces = []
        for f, cap in enumerate(self._caps):
            offs = _cumsum0(self.lengths_for_key(f).to(torch.int64))
            pos = torch.arange(cap, dtype=torch.int64, device=dev)
            b = torch.searchsorted(offs, pos, right=True) - 1
            pieces.append(torch.where(pos < offs[-1], lo[f] + b, total))
        if not pieces:
            return torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.cat(pieces).to(torch.int32)

    def valid_mask(self) -> torch.Tensor:
        """``[sum(caps)]`` bool: the slots that hold a real id."""
        return self.segment_ids() < self.total_stride

    def overflow_counts(self) -> torch.Tensor:
        """``[F]`` int32: ids the lengths claim beyond each key's
        capacity.  Host construction raises on such a batch; a device-side
        relayout saturates (a key's first ``cap`` ids survive) and this
        counts what was dropped.  No host sync: the capacities reach the
        device by an asynchronous copy."""
        caps = torch.tensor(self._caps, dtype=torch.int32).to(
            self._lengths.device, non_blocking=True)
        return (self.length_per_key().to(torch.int32) - caps).clamp(min=0)

    # -- capacity bucketing (host-side; see bucket_ladder above) -----------

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

    def scalar_metrics(self, prefix: str = "kjt") -> Dict[str, float]:
        """Per key its occupancy, capacity, occupancy rate, overflow and
        whether it is saturated, as ``<prefix>/<key>/<counter>`` floats
        (reads the lengths on the host: call it from metric collection,
        not the hot path)."""
        from torchrec_tpu_torch.utils.profiling import counter_key

        out: Dict[str, float] = {}
        for k, occ, cap in zip(self._keys, self.occupancy_per_key(),
                               self._caps):
            out[counter_key(prefix, k, "occupancy")] = float(occ)
            out[counter_key(prefix, k, "capacity")] = float(cap)
            out[counter_key(prefix, k, "occupancy_rate")] = (
                float(occ) / max(1, cap))
            out[counter_key(prefix, k, "overflow")] = float(max(0, occ - cap))
            out[counter_key(prefix, k, "saturated")] = float(occ >= cap)
        return out

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
            stride_per_key=self._stride_per_key,
            inverse_indices=self._inverse_indices,
        )

    # -- reordering --------------------------------------------------------

    def permute(self, indices: Sequence[int]) -> "KeyedJaggedTensor":
        """The keys in the order ``indices`` (a key may repeat or be left
        out): each key's region, lengths, weights, stride and inverse
        indices move with it."""
        idx = [int(i) for i in indices]
        co, lo = self.cap_offsets(), self._length_offsets()

        def gather(buf, starts):
            if not idx:
                return buf.new_zeros((0,) + tuple(buf.shape[1:]))
            return torch.cat([buf[starts[i]: starts[i + 1]] for i in idx])

        inv = self._inverse_indices
        if inv is not None:
            inv = inv[torch.tensor(idx, dtype=torch.int64,
                                   device=inv.device)] if idx else None
        return KeyedJaggedTensor(
            tuple(self._keys[i] for i in idx),
            gather(self._values, co), gather(self._lengths, lo),
            None if self._weights is None else gather(self._weights, co),
            self._stride, tuple(self._caps[i] for i in idx),
            stride_per_key=(None if self._stride_per_key is None
                            else tuple(self._stride_per_key[i]
                                       for i in idx)),
            inverse_indices=inv,
        )

    def select_keys(self, keys: Sequence[str]) -> "KeyedJaggedTensor":
        """:meth:`permute` by key name."""
        return self.permute([self._keys.index(k) for k in keys])

    def split(self, segments: Sequence[int]) -> List["KeyedJaggedTensor"]:
        """Consecutive groups of ``segments[i]`` keys each."""
        if sum(segments) != self.num_keys:
            raise ValueError(f"segments {list(segments)} do not cover "
                             f"{self.num_keys} keys")
        out, start = [], 0
        for n in segments:
            out.append(self.permute(range(start, start + n)))
            start += n
        return out

    def with_values(
        self, values: torch.Tensor, weights: Optional[torch.Tensor] = None
    ) -> "KeyedJaggedTensor":
        """The same layout over other values (and weights, when given)."""
        return KeyedJaggedTensor(
            self._keys, values, self._lengths,
            self._weights if weights is None else weights,
            self._stride, self._caps, stride_per_key=self._stride_per_key,
            inverse_indices=self._inverse_indices,
        )

    def pad_strides(self) -> "KeyedJaggedTensor":
        """A variable-batch KJT as a uniform one: each key's ``[B_f]``
        lengths fill the first ``B_f`` of ``B`` rows, the rest length 0
        (pooled to zero, no gradient); values, weights, caps and the
        inverse indices are kept."""
        if not self.variable_stride_per_key:
            return self
        B = self._stride
        rows = []
        for f in range(self.num_keys):
            lens = self.lengths_for_key(f)
            if lens.shape[0] > B:
                raise ValueError(f"key {self._keys[f]} stride "
                                 f"{lens.shape[0]} exceeds full batch {B}")
            rows.append(torch.nn.functional.pad(lens, (0, B - lens.shape[0])))
        lengths = (torch.cat(rows) if rows
                   else self._lengths.new_zeros((0,)))
        return KeyedJaggedTensor(
            self._keys, self._values, lengths, self._weights, stride=B,
            caps=self._caps, inverse_indices=self._inverse_indices)

    def to_dict(self) -> Dict[str, JaggedTensor]:
        """key -> that key's :class:`JaggedTensor`."""
        return {k: self[k] for k in self._keys}

    def __getitem__(self, key: str) -> JaggedTensor:
        f = self._keys.index(key)
        offs = self.cap_offsets()
        s, e = offs[f], offs[f + 1]
        w = None if self._weights is None else self._weights[s:e]
        return JaggedTensor(self._values[s:e], self.lengths_for_key(f), w)

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

    @staticmethod
    def from_dict(d: Mapping[str, torch.Tensor]) -> "KeyedTensor":
        """key -> ``[B, D_k]`` tensor, concatenated in the mapping's
        order."""
        keys = tuple(d)
        return KeyedTensor(keys, [d[k].shape[-1] for k in keys],
                           torch.cat([d[k] for k in keys], dim=-1))

    @staticmethod
    def from_tensor_list(
        keys: Sequence[str], tensors: Sequence[torch.Tensor]
    ) -> "KeyedTensor":
        """Per-key ``[B, D_k]`` tensors concatenated along the last dim
        (the JAX package's ``key_dim`` and ``cat_dim`` can only be 1, and
        are left out)."""
        if len(keys) != len(tensors) or any(t.dim() != 2 for t in tensors):
            raise ValueError("from_tensor_list takes one [B, D_k] tensor "
                             "per key")
        return KeyedTensor(keys, [t.shape[-1] for t in tensors],
                           torch.cat(list(tensors), dim=-1))

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

    def to_dict(self) -> Dict[str, torch.Tensor]:
        """key -> its ``[B, D_k]`` columns (views)."""
        offs = self.offset_per_key()
        return {k: self._values[..., offs[i]: offs[i + 1]]
                for i, k in enumerate(self._keys)}

    def __getitem__(self, key: str) -> torch.Tensor:
        i = self._keys.index(key)
        offs = self.offset_per_key()
        return self._values[..., offs[i]: offs[i + 1]]

    @staticmethod
    def regroup(
        keyed_tensors: Sequence["KeyedTensor"],
        groups: Sequence[Sequence[str]],
    ) -> List[torch.Tensor]:
        """The keys of several KeyedTensors regrouped: one tensor per
        group, its keys' columns concatenated in the group's order."""
        lookup: Dict[str, torch.Tensor] = {}
        for kt in keyed_tensors:
            lookup.update(kt.to_dict())
        return [torch.cat([lookup[k] for k in g], dim=-1) for g in groups]

    @staticmethod
    def regroup_as_dict(
        keyed_tensors: Sequence["KeyedTensor"],
        groups: Sequence[Sequence[str]],
        keys: Sequence[str],
    ) -> Dict[str, torch.Tensor]:
        """:meth:`regroup` with each group named by ``keys``."""
        return dict(zip(keys, KeyedTensor.regroup(keyed_tensors, groups)))

    def __repr__(self) -> str:
        return f"KeyedTensor(keys={list(self._keys)}, dims={self._length_per_key})"
