"""Port parity for the training kernels' plain versions: the float pooled
lookup (``ops/tbe.py::pooled_lookup``, B1) and the fused backward +
optimizer (``ops/tbe_backward.py::fused_sparse_update``, B2, all eight
optimizers), against the JAX package's Pallas kernels in interpret mode
and its XLA lookup, on the same numpy inputs.

Tolerances, with their reasons:

* B1 float32, ``rtol = atol = 1e-5``: XLA on the CPU may contract the JAX
  side's ``acc + row * w`` into an FMA, which the port rounds as two
  operations (as in the quantized lookups).
* B1 bfloat16 against the Pallas kernel: at most one bfloat16 ulp
  (``rtol = 2**-7``); both accumulate in float32 and round once, and an FMA
  contraction can flip that one rounding.  Against the XLA lookup,
  ``rtol = atol = 3e-2``: XLA multiplies and sums in bfloat16.
* B2, table ``rtol = atol = 1e-6`` and momentum ``rtol = 1e-5``: the JAX
  kernel takes ``jnp.mean(g * g)`` in an order XLA does not pin down,
  where the port (and its CUDA kernel) sums lanes then an xor butterfly.
* B2's other seven optimizers, the same bounds: table ``rtol = atol =
  1e-6``, states ``rtol = 1e-5``.  Their norms (lars_sgd, lamb) and means
  (the partial-rowwise pair) reduce in an order XLA does not pin down,
  and XLA on the CPU may contract the JAX side's ``b * m + (1 - b) * g``
  into an FMA.  The Adam family needs no wider bound here: its states are
  drawn away from zero, so ``sqrt(v)`` never meets ``eps`` (where it
  does, Adam magnifies last-bit differences; ROADMAP C).
* B2 bfloat16 with a shared seed: equal or one bfloat16 ulp apart (the
  float32 value before the rounding may differ in its last bits).

The CUDA kernels cannot run here; their walk is emulated in numpy float32
(one rounding per operation, in the kernels' order) and must equal the
plain versions bit for bit, the property ``chip_smoke.py`` checks on the
card with ``torch.equal``.  The fused updates' grid (32-position windows
claimed in any order, run starts by ballot, each run walked to its end in
32-slot chunks) is emulated too, and must walk every run exactly once;
the launchers' choice of column layout by D and their width check are
pinned without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import embedding_ops as jeo
from torchrec_tpu.ops import pallas_tbe as jtbe
from torchrec_tpu.ops import pallas_tbe_backward as jbwd
from torchrec_tpu_torch.ops import embedding_ops as teo
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.ops import tbe_backward as tbw
from torchrec_tpu_torch.modules.embedding_configs import PoolingType
from torchrec_tpu_torch.parallel.sharding.common import FeatureSpec
from torchrec_tpu_torch.parallel.sharding.tw import (
    build_tw_layout,
    tw_regions,
    tw_segments,
    tw_slot_stream,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT

R, D, S, V = 64, 16, 8, 48
LR, EPS = 0.05, 1e-8
B1_CASES = {
    "uniform": ((0, R), (0, S), "rand"),
    "duplicate_heavy": ((0, 4), (0, S), "rand"),
    "empty_segments": ((0, R), (2, 5), "rand"),
    "no_weights": ((0, R), (0, S), None),
    "ids_out_of_range": ((-5, R + 10), (0, S), "rand"),
    "bad_segments": ((0, R), (-3, S + 3), "rand"),
}
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bf16_exact(x):
    """float32 values that bfloat16 holds exactly (so both packages start
    from the same table)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _b1_case(name, seed=0):
    (ilo, ihi), (slo, shi), wkind = B1_CASES[name]
    rng = np.random.RandomState(seed)
    table = _bf16_exact(rng.randn(R, D).astype(np.float32))
    ids = rng.randint(ilo, ihi, size=(V,)).astype(np.int32)
    segs = rng.randint(slo, shi, size=(V,)).astype(np.int32)
    w = rng.rand(V).astype(np.float32) if wkind else None
    return table, ids, segs, w


_pallas_b1 = jax.jit(functools.partial(
    jtbe.pallas_pooled_embedding_lookup, num_segments=S, chunk=32, group=8,
    interpret=True,
))
_xla_b1 = jax.jit(functools.partial(jeo._xla_pooled_lookup, num_segments=S))


def _port_table(table, dtype):
    return _t(table).to(DTYPES[dtype][1])


def _jax_table(table, dtype):
    return jnp.asarray(table).astype(DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(B1_CASES))
def test_pooled_lookup_plain_matches_pallas_and_xla(case, dtype):
    table, ids, segs, w = _b1_case(case)
    got = tbe.pooled_lookup(_port_table(table, dtype), _t(ids), _t(segs), S,
                            _t(w))
    assert got.shape == (S, D) and got.dtype == DTYPES[dtype][1]
    got = got.to(torch.float32).numpy()
    jt = _jax_table(table, dtype)
    pallas = np.asarray(_pallas_b1(jt, _j(ids), _j(segs), weights=_j(w))
                        .astype(jnp.float32))
    xla = np.asarray(_xla_b1(jt, _j(ids), _j(segs), weights=_j(w))
                     .astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, pallas, rtol=2.0**-7, atol=1e-6)
        np.testing.assert_allclose(got, xla, rtol=3e-2, atol=3e-2)


def test_pooled_lookup_through_embedding_ops_and_empty_batch():
    table, ids, segs, w = _b1_case("uniform")
    a = teo.pooled_embedding_lookup(_t(table), _t(ids), _t(segs), S, _t(w))
    b = tbe.pooled_lookup_plain(_t(table), _t(ids), _t(segs), S, _t(w))
    assert torch.equal(a, b)
    empty = tbe.pooled_lookup(_t(table), torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32), S)
    assert empty.shape == (S, D) and not empty.any()
    assert tbe.launch_counts()["pooled_lookup"] == 0  # CPU: no launch


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["duplicate_heavy", "bad_segments",
                                  "ids_out_of_range", "no_weights"])
def test_pooled_lookup_kernel_emulation_bit_equal(case, dtype):
    """sort_by_segment + the B1 walk (what the CUDA wrapper launches):
    widen, multiply by the weight, add, slot by slot; round once."""
    table, ids, segs, w = _b1_case(case, seed=3)
    sids, sw, offsets = (x.numpy() for x in tbe.sort_by_segment(
        _t(ids), _t(segs), _t(w), S, R))
    out = np.zeros((S, D), np.float32)
    for s in range(S):
        acc = np.zeros((D,), np.float32)
        for i in range(offsets[s], offsets[s + 1]):
            acc = acc + table[sids[i]] * sw[i]
        out[s] = acc
    plain = tbe.pooled_lookup_plain(_port_table(table, dtype), _t(ids),
                                    _t(segs), S, _t(w))
    emu = _t(out).to(DTYPES[dtype][1])
    assert torch.equal(emu, plain)


# ---------------------------------------------------------------------------
# B1 over a stream in its producer's layout (pooled_lookup_regions)
# ---------------------------------------------------------------------------

# table-wise streams: (ids per example of each of 3 features, weighted,
# pooling, lengths) with B = 16 examples and a stack of 3 x 40 rows
TW_B, TW_ROWS = 16, 40
TW_CASES = {
    "one_hot": ((1, 1, 1), False, "SUM", "random"),
    "multi_hot_weighted": ((1, 3, 6), True, "SUM", "random"),
    "mean": ((2, 1, 5), True, "MEAN", "random"),
    "overflow": ((1, 3, 6), True, "SUM", "overflow"),
    "empty_batch": ((1, 3, 6), False, "SUM", "zero"),
}


def _tw_case(name, seed=0):
    """A one-device table-wise group of 3 features on their own tables and
    a KJT batch for it: (layout, stack [120, D] float32, kjt).  With
    ``overflow`` the second feature's lengths claim more ids than its cap
    (a device relayout's saturated batch): its region reads the padding
    slots up to the group's cap, weight 0, as its segments do."""
    ids_per, weighted, pooling, lens = TW_CASES[name]
    rng = np.random.RandomState(seed)
    keys = ("a", "b", "c")
    feats = [FeatureSpec(k, f"t_{k}", TW_ROWS, D, PoolingType[pooling],
                         n * TW_B) for k, n in zip(keys, ids_per)]
    lay = build_tw_layout("tw", feats, {f.table_name: [0] for f in feats},
                          1, TW_B)
    lengths = np.concatenate([rng.randint(0, n + 1, size=TW_B)
                              for n in ids_per]).astype(np.int32)
    if lens == "zero":
        lengths[:] = 0
    if lens == "overflow":
        lengths[TW_B:2 * TW_B] = ids_per[1] + 2
    caps = [n * TW_B for n in ids_per]
    values = rng.randint(-2, TW_ROWS + 2, size=sum(caps)).astype(np.int64)
    w = rng.rand(sum(caps)).astype(np.float32) if weighted else None
    kjt = TKJT(keys, _t(values), _t(lengths), _t(w), caps=caps)
    stack = _bf16_exact(rng.randn(3 * TW_ROWS, D).astype(np.float32))
    return lay, stack, kjt


def _emulate_b1_regions(table, ids, w, lengths, regions, run_slots=32):
    """The CUDA kernel's schedule (csrc/tbe_float.cu, pool_walk.cuh::
    walk_run) in numpy float32, one rounding per operation: each warp owns
    a run of ``run`` consecutive examples of a region (``run_slots`` / the
    region's slots per example by its cap, 1 to 32), lays their slots out
    as one stream by a scan of the counts, finds each position's example
    by the kernel's binary search over the lanes, and adds the rows in
    stream order, writing an example's sum at its last slot (zeros for an
    empty one).  Returns (out, the largest run)."""
    R = table.shape[0]
    ends = np.cumsum(lengths.astype(np.int64))
    out = np.full((len(lengths), table.shape[1]), np.nan, np.float32)
    base, widest = 0, 0
    for start, cap, count in zip(regions.starts, regions.caps,
                                 regions.counts):
        per = max(1, -(-cap // count)) if count else 1
        run = min(32, max(1, run_slots // per))
        origin = ends[base - 1] if base else 0
        for first in range(0, count, run):
            n = min(run, count - first)
            widest = max(widest, n)
            # lanes past the run read a clipped index and hold no slots
            e = np.minimum(base + first + np.arange(32), len(ends) - 1)
            prev = np.where(e > 0, ends[np.maximum(e - 1, 0)], 0)
            lo = np.clip(prev - origin, 0, cap)
            hi = np.maximum(np.clip(ends[e] - origin, 0, cap), lo)
            mine = np.arange(32) < n
            begin = np.where(mine, start + lo, start)
            cnt = np.where(mine, start + hi, start) - begin
            last = np.cumsum(cnt)
            firstpos = last - cnt
            for j in np.flatnonzero(mine & (cnt == 0)):
                out[base + first + j] = 0.0
            cur, acc = -1, None
            for p in range(int(last[-1])):
                j = 0
                for step in (16, 8, 4, 2, 1):
                    if last[j + step - 1] <= p:
                        j += step
                slot = begin[j] + p - firstpos[j]
                if j != cur:
                    if cur >= 0:
                        out[base + first + cur] = acc
                    cur, acc = j, np.zeros(table.shape[1], np.float32)
                wt = np.float32(1.0) if w is None else w[slot]
                acc = acc + table[np.clip(ids[slot], 0, R - 1)] * wt
            if cur >= 0:
                out[base + first + cur] = acc
        base += count
    assert not np.isnan(out).any()  # every example written once
    return out, widest


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(TW_CASES))
def test_pooled_lookup_regions_plain_equals_sorted_on_tw_streams(case,
                                                                 dtype):
    """The table-wise ``[N, F, C]`` slots as regions: the region entry's
    plain version ``torch.equal`` to the sorted plain version over the
    slots' segments, and to the region entry (the CPU takes the plain
    version)."""
    lay, stack, kjt = _tw_case(case)
    table = _port_table(stack, dtype)
    ids, w, lengths = tw_slot_stream(lay, kjt)
    regions = tw_regions(lay, lengths)
    segs, S = tw_segments(lay, lengths)
    got = tbe.pooled_lookup_regions_plain(table, ids, regions, w)
    assert torch.equal(got, tbe.pooled_lookup_plain(table, ids, segs, S, w))
    assert torch.equal(got, tbe.pooled_lookup_regions(table, ids, regions, w))
    assert torch.equal(regions.segment_ids(ids.shape[0]), segs)
    if case == "empty_batch":
        assert not got.any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["multi_hot_weighted", "mean", "overflow"])
def test_pooled_lookup_regions_plain_matches_pallas(case, dtype):
    """The region entry's plain version against the JAX package's Pallas
    lookup (interpret mode) on the same slots and their segments."""
    lay, stack, kjt = _tw_case(case, seed=1)
    ids, w, lengths = tw_slot_stream(lay, kjt)
    segs, S = tw_segments(lay, lengths)
    got = tbe.pooled_lookup_regions_plain(
        _port_table(stack, dtype), ids, tw_regions(lay, lengths), w)
    got = got.to(torch.float32).numpy()
    want = np.asarray(jtbe.pallas_pooled_embedding_lookup(
        _jax_table(stack, dtype), _j(ids.numpy()), _j(segs.numpy()),
        num_segments=S, weights=_j(w.numpy()), chunk=32, group=8,
        interpret=True).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-6)


@pytest.mark.parametrize("run_slots", [32, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(TW_CASES))
def test_pooled_lookup_regions_kernel_emulation_bit_equal(case, dtype,
                                                          run_slots):
    """The kernel's walk of runs of examples (several a warp on one-hot
    regions) equals the region entry's plain version bit for bit."""
    lay, stack, kjt = _tw_case(case, seed=2)
    ids, w, lengths = tw_slot_stream(lay, kjt)
    regions = tw_regions(lay, lengths)
    emu, widest = _emulate_b1_regions(
        stack, ids.numpy(), None if w is None else w.numpy(),
        lengths.numpy(), regions, run_slots)
    if case == "one_hot":  # several examples a warp
        assert widest == min(TW_B, run_slots)
    plain = tbe.pooled_lookup_regions_plain(_port_table(stack, dtype), ids,
                                            regions, w)
    assert torch.equal(_t(emu).to(DTYPES[dtype][1]), plain)


def test_pooled_lookup_regions_generic_streams():
    """Regions with unread slots between them, no examples, more examples
    than slots, int64 ids past the table and past 2**31, no weights; and a
    lookup with no segments: each equal to the sorted plain version, the
    emulated walk and (with weights) the autograd entry."""
    rng = np.random.RandomState(4)
    table = _bf16_exact(rng.randn(R, D).astype(np.float32))
    counts, caps, starts = (5, 0, 40, 1), (9, 3, 20, 1000), (2, 12, 15, 40)
    lengths = np.concatenate([rng.randint(0, 4, size=5),
                              rng.randint(0, 2, size=40),
                              [1000]]).astype(np.int64)
    ids = rng.randint(-4, R + 4, size=(1040,)).astype(np.int64)
    ids[::9] = 2**31 + 5
    w = rng.rand(1040).astype(np.float32)
    regions = tbe.SlotRegions(_t(lengths), starts, caps, counts)
    S = regions.num_segments
    segs = regions.segment_ids(1040)
    for wt in (None, _t(w)):
        got = tbe.pooled_lookup_regions(_t(table), _t(ids), regions, wt)
        assert torch.equal(got, tbe.pooled_lookup_plain(_t(table), _t(ids),
                                                        segs, S, wt))
        emu, _ = _emulate_b1_regions(table, ids, None if wt is None else w,
                                     lengths, regions)
        assert torch.equal(_t(emu), got)
    assert torch.equal(got, teo.pooled_embedding_lookup_regions(
        _t(table), _t(ids), regions, _t(w)))
    none = tbe.SlotRegions(_t(np.zeros(0, np.int32)), (0,), (4,), (0,))
    out = tbe.pooled_lookup_regions(_t(table), _t(ids), none)
    assert out.shape == (0, D)
    with pytest.raises(ValueError):
        tbe.pooled_lookup_regions(_t(table), _t(ids), tbe.SlotRegions(
            _t(lengths), starts, (9, 3, 20, 1001), counts))


# ---------------------------------------------------------------------------
# B2: fused backward + rowwise Adagrad
# ---------------------------------------------------------------------------


def _b2_case(seed, dim=D, rows=R, n=V, segments=S):
    rng = np.random.RandomState(seed)
    table = _bf16_exact(rng.randn(rows, dim).astype(np.float32))
    mom = rng.rand(rows).astype(np.float32)
    # Zipf ids: heavy duplicates, some past the table (dropped)
    ids = np.minimum(rng.zipf(1.3, n) - 1, rows + 3).astype(np.int32)
    segs = rng.randint(-2, segments + 2, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    w = rng.rand(n).astype(np.float32)
    grad = rng.randn(segments, dim).astype(np.float32)
    return table, mom, ids, valid, segs, w, grad


def _kept(ids, valid, segs, rows=R, segments=S):
    return valid & (segs >= 0) & (segs < segments) & (ids >= 0) & (ids < rows)


def _jax_b2(table, mom, ids, valid, segs, w, grad, wd=0.0, sr_seed=None,
            dtype="f32"):
    t, (m,) = jbwd.pallas_fused_sparse_update(
        _jax_table(table, dtype), jnp.asarray(mom), _j(ids), _j(valid),
        _j(segs), _j(w), _j(grad), jnp.float32(LR), eps=EPS,
        optim="rowwise_adagrad", chunk=64, group=8, interpret=True,
        weight_decay=wd,
        sr_seed=None if sr_seed is None else jnp.int32(sr_seed),
    )
    return np.asarray(t.astype(jnp.float32)), np.asarray(m)


def _port_b2(table, mom, ids, valid, segs, w, grad, wd=0.0, sr_seed=None,
             dtype="f32"):
    t = _port_table(table, dtype)
    m = _t(mom)
    out = tbw.fused_sparse_update(t, m, _t(ids), _t(valid), _t(segs), _t(w),
                                  _t(grad), LR, eps=EPS, weight_decay=wd,
                                  sr_seed=sr_seed)
    assert out[0] is t and out[1][0] is m  # in place
    return t.to(torch.float32).numpy(), m.numpy()


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_update_plain_matches_pallas(wd):
    case = _b2_case(seed=1)
    table, mom, ids, valid, segs = case[:5]
    jt, jm = _jax_b2(*case, wd=wd)
    pt, pm = _port_b2(*case, wd=wd)
    np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm, jm, rtol=1e-5, atol=0)
    touched = np.isin(np.arange(R), ids[_kept(ids, valid, segs)])
    assert touched.sum() > 5 and (~touched).sum() > 5
    # untouched rows and momentum stay bitwise unchanged
    np.testing.assert_array_equal(pt[~touched], table[~touched])
    np.testing.assert_array_equal(pm[~touched], mom[~touched])
    assert (pt[touched] != table[touched]).any(axis=1).all()


def test_hash_bits_equal_jax():
    seeds = [0, 1, -1, -5, 777, 123456789, 2**31 - 1, -(2**31)]
    rows = np.array([0, 1, 7, 4095, 99_999, 2_599_999, 2**31 - 1])
    for seed in seeds:
        got = tbw.hash_bits(seed, torch.from_numpy(rows), 37).numpy()
        want = np.stack([
            np.asarray(jbwd._hash_bits(jnp.int32(seed), jnp.int32(r),
                                       (1, 37)))[0]
            for r in rows
        ]).astype(np.int64)
        np.testing.assert_array_equal(got, want)


def test_bf16_stochastic_rounding_matches_pallas_within_one_ulp():
    case = list(_b2_case(seed=2))
    table, grad, ids, valid, segs = case[0], case[6], case[2], case[3], case[4]
    kept = np.flatnonzero(_kept(ids, valid, segs))
    # a non-finite value on two touched rows: inf in a weight, NaN in the
    # gradient of a segment that only feeds another row
    table[ids[kept[0]], 3] = np.inf
    lone = [i for i in kept if (ids[kept] == ids[i]).sum() == 1
            and ids[i] != ids[kept[0]]][0]
    nan_seg = segs[lone]
    segs[(segs == nan_seg) & (np.arange(V) != lone)] = -1
    grad[nan_seg, 5] = np.nan
    jt, _ = _jax_b2(*case, sr_seed=777, dtype="bf16")
    pt, _ = _port_b2(*case, sr_seed=777, dtype="bf16")
    ulp = np.abs(pt.view(np.int32).astype(np.int64)
                 - jt.view(np.int32).astype(np.int64)) >> 16
    finite = np.isfinite(jt)
    assert ulp[finite].max() <= 1 and (ulp[finite] == 0).mean() > 0.99
    assert np.array_equal(np.isinf(pt), np.isinf(jt)) and np.isinf(
        pt[ids[kept[0]], 3])
    assert np.array_equal(np.isnan(pt), np.isnan(jt)) and np.isnan(
        pt[ids[lone]]).all()
    # stochastic rounding differs from round-to-nearest somewhere
    rn, _ = _port_b2(*case, sr_seed=None, dtype="bf16")
    assert (rn[finite] != pt[finite]).any()


def _emulate_b2(table, mom, srows, ssegs, sw, grad, wd, dim):
    """numpy float32 emulation of the B2 kernel: one warp per run, the
    lane columns of ``lane_columns``, lane sums then the xor butterfly."""
    table, mom = table.copy(), mom.copy()
    cols = tbw.lane_columns(dim).numpy()
    f32 = np.float32
    i, n = 0, len(srows)
    while i < n and srows[i] < len(mom):
        r, j = srows[i], i
        g = np.zeros((dim,), f32)
        while j < n and srows[j] == r:
            g = g + grad[ssegs[j]] * sw[j]
            j += 1
        w = table[r].copy()
        if wd:
            g = g + f32(wd) * w
        gp = np.concatenate([g * g, np.zeros((1,), f32)])
        s = np.zeros((32,), f32)
        for k in range(cols.shape[1]):
            s = s + gp[cols[:, k]]
        for off in (16, 8, 4, 2, 1):
            s = s + s[np.arange(32) ^ off]
        m_new = mom[r] + s[0] / f32(dim)
        scale = f32(-LR) / (np.sqrt(m_new) + f32(EPS))
        table[r] = w + scale * g
        mom[r] = m_new
        i = j
    return table, mom


@pytest.mark.parametrize("dim,wd", [(16, 0.0), (6, 0.01), (132, 0.01)])
def test_fused_update_kernel_emulation_bit_equal(dim, wd):
    """sort_by_row + the B2 kernel's arithmetic, for both lane layouts
    (D % 4 == 0 and not, one and two 128-column blocks)."""
    case = _b2_case(seed=dim, dim=dim)
    table, mom, ids, valid, segs, w, grad = case
    srows, ssegs, sw = (x.numpy() for x in tbw.sort_by_row(
        _t(ids), _t(valid), _t(segs), _t(w), R, S))
    et, em = _emulate_b2(table, mom, srows, ssegs, sw, grad, wd, dim)
    pt, pm = _port_b2(*case, wd=wd)
    np.testing.assert_array_equal(pt, et)
    np.testing.assert_array_equal(pm, em)


def test_lane_columns_cover_each_column_once():
    for dim in (1, 6, 16, 31, 128, 132, 512):
        cols = tbw.lane_columns(dim).numpy().ravel()
        assert sorted(cols[cols < dim]) == list(range(dim))
        # each lane's columns ascend (the order it sums them)
        per_lane = tbw.lane_columns(dim).numpy()
        for lane in per_lane:
            own = lane[lane < dim]
            assert (np.diff(own) > 0).all()


@pytest.mark.parametrize("dim,layout,cols", [
    (4, "narrow", 4), (100, "narrow", 4), (128, "narrow", 4),
    (132, "wide", 16), (256, "wide", 16), (512, "wide", 16),
    (6, "scalar", 16), (130, "scalar", 16), (510, "scalar", 16),
])
def test_column_layout_by_width(dim, layout, cols):
    """The launchers' D -> instantiation choice: the narrow layout (one
    float4 a lane) for D <= 128 with D % 4 == 0, the 16-column layouts
    otherwise; each holds every column ``lane_columns`` gives a lane."""
    assert tbw.column_layout(dim) == (layout, cols)
    assert tbw.lane_columns(dim).shape[1] <= cols


@pytest.mark.parametrize("launch", [tbw.launch_fused_sparse_update,
                                    tbw.launch_dedup_fused_sparse_update])
def test_launchers_reject_wide_tables_before_building(launch, monkeypatch):
    """Past 512 columns both launchers raise the ValueError they always
    raised, before any kernel is built."""
    from torchrec_tpu_torch.ops import _native

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_native, "load_library", no_build)
    with pytest.raises(ValueError, match="D <= 512, got 513"):
        tbw.column_layout(513)
    e = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="D <= 512, got 513"):
        launch(torch.zeros((4, 513)), [], e, e, e.float(),
               torch.zeros((1, 513)), "sgd", LR, EPS, 0.0, (0.9, 0.999),
               (1.0, 1.0), None)


def _emulate_grid(srows, num_rows, order):
    """numpy emulation of ``fused_update_kernel``'s schedule
    (``csrc/backward_common.cuh``): the 32-position windows claimed in
    ``order``, a claim past V or on the sentinel stops its warp, the
    ballot over ``rows[p] != rows[p - 1]`` finds the runs that start in
    a window, and the owner walks each: its slots in the window (from
    its start lane to the first lane whose row differs), then, if it
    reaches the window's end, 32-slot chunks (the run is the prefix of
    equal rows of each).  Returns {start: (row, end)} of the runs walked;
    raises if one is walked twice."""
    V, lane = len(srows), np.arange(32)

    def rows_at(q):
        return np.where(q < V, srows[np.minimum(q, V - 1)], num_rows)

    walked = {}
    for w in order:
        base = 32 * w
        if base >= V:
            continue
        r = rows_at(base + lane)
        if r[0] >= num_rows:
            continue
        prev = np.concatenate([[srows[base - 1] if base else -1], r[:-1]])
        for k in np.flatnonzero((r < num_rows) & (r != prev)):
            same = (r == r[k]) | (lane < k)
            end = base + (32 if same.all() else int(np.argmin(same)))
            b = base + 32
            while end == b:  # the run reached the chunk's end
                same = rows_at(b + lane) == r[k]
                end = b + (32 if same.all() else int(np.argmin(same)))
                b += 32
            assert base + k not in walked
            walked[base + k] = (r[k], end)
    return walked


# run lengths of the valid slots (each on its own row), then padding slots
GRID_STREAMS = {
    "runs": ([1, 31, 32, 33, 64, 3000, 1, 2], 40),
    "crossing": ([20, 100, 7], 0),
    "one_valid": ([1], 50),
    "all_sentinels": ([], 70),
    "ends_on_window": ([10, 22, 32], 32),
    "no_sentinel": ([5, 59], 0),
}


@pytest.mark.parametrize("case", sorted(GRID_STREAMS))
def test_grid_schedule_walks_each_run_once(case):
    """Whatever order the work queue hands out the windows in (and the
    static grid's order), every run of ``sort_by_row``'s stream is walked
    exactly once, from its first slot to its last, and nothing else."""
    lengths, pad = GRID_STREAMS[case]
    rng = np.random.RandomState(len(lengths) + pad)
    rows = rng.permutation(R)[: len(lengths)]
    ids = np.concatenate([np.repeat(rows, lengths),
                          rng.randint(0, R, pad)]).astype(np.int64)
    valid = np.arange(len(ids)) < sum(lengths)
    perm = rng.permutation(len(ids))
    segs = rng.randint(0, S, len(ids))
    srows, _, _ = tbw.sort_by_row(_t(ids[perm]), _t(valid[perm]),
                                  _t(segs), None, R, S)
    srows = srows.numpy()
    n = sum(lengths)
    first = np.flatnonzero(np.diff(srows[:n], prepend=-1) != 0) if n else []
    want = {int(s): (srows[s], int(e))
            for s, e in zip(first, list(first[1:]) + [n])}
    windows = -(-len(ids) // 32) + 3  # and claims past V
    for order in (range(windows), rng.permutation(windows)):
        assert _emulate_grid(srows, R, order) == want


def test_fused_update_empty_batch_and_no_valid_slot_are_identity():
    table, mom, ids, valid, segs, w, grad = _b2_case(seed=4)
    t, m = _t(table), _t(mom)
    e = torch.zeros(0, dtype=torch.int32)
    tbw.fused_sparse_update(t, m, e, e.bool(), e, None, _t(grad), LR)
    tbw.fused_sparse_update(t, m, _t(ids), torch.zeros(V, dtype=torch.bool),
                            _t(segs), _t(w), _t(grad), LR)
    assert torch.equal(t, _t(table)) and torch.equal(m, _t(mom))
    assert tbe.launch_counts()["fused_sparse_update"] == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_sparse_update_segments_dispatch(dtype):
    """The fused optimizer's entry point runs B2 on the segment gradient;
    the seed rounds a bfloat16 table stochastically and a float32 table
    ignores it."""
    table, mom, ids, valid, segs, w, grad = _b2_case(seed=5)
    sg = tfu.SparseSegGrad(_t(ids), _t(valid), _t(segs), _t(w), _t(grad))
    cfg = tfu.FusedOptimConfig(learning_rate=LR)
    t, st = _port_table(table, dtype), tfu.init_optimizer_state(cfg, R, D)
    t0 = t.clone()
    st["momentum"].copy_(_t(mom))
    out = tfu.apply_sparse_update_segments(t, st, sg, cfg, sr_seed=777)
    assert out[0] is t and out[1] is st
    seed = 777 if dtype == "bf16" else None
    pt, pm = _port_b2(table, mom, ids, valid, segs, w, grad, sr_seed=seed,
                      dtype=dtype)
    assert torch.equal(t.to(torch.float32), _t(pt))
    assert torch.equal(st["momentum"], _t(pm))
    # the slot mask agrees with the JAX package's
    from torchrec_tpu.ops.fused_update import SparseSegGrad as JSeg

    want = np.asarray(JSeg(_j(ids), _j(valid), _j(segs), _j(w),
                           _j(grad)).ok())
    np.testing.assert_array_equal(sg.ok().numpy(), want)
    from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
    from torchrec_tpu.ops.fused_update import FusedOptimConfig as JCfg
    from torchrec_tpu.ops.fused_update import init_optimizer_state as jinit

    for optim in tfu.EmbOptimType:
        # every optimizer's state has the JAX layout, and the per-id
        # kernel takes all eight: the entry point equals B2's plain version
        # on the optimizer's states, with the incremented step's
        # corrections for the Adam family
        ocfg = tfu.FusedOptimConfig(optim=optim, learning_rate=LR)
        got = tfu.init_optimizer_state(ocfg, R, D)
        want = jinit(JCfg(optim=JOptim(optim.value)), R, D)
        assert {k: np.shape(v) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        ta = _port_table(table, dtype)
        tfu.apply_sparse_update_segments(ta, got, sg, ocfg, sr_seed=777)
        tb = _port_table(table, dtype)
        ref = tfu.init_optimizer_state(ocfg, R, D)
        adam = optim in tfu.ADAM_FAMILY
        tbw.fused_sparse_update_plain(
            tb, ref.get("momentum"), *(_t(x) for x in (ids, valid, segs, w,
                                                        grad)),
            LR, sr_seed=seed, optim=optim.value,
            states=(ref["m"], ref["v"]) if adam else None,
            bias_corrections=tfu.bias_corrections(ocfg, 1) if adam
            else (1.0, 1.0))
        assert torch.equal(ta, tb) and not torch.equal(ta, t0)
        for k, v in got.items():
            if k == "step":
                assert v == 1
            else:
                assert torch.equal(v, ref[k])


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the loader raises and names it: a wrapper given CUDA
    tensors on such a machine fails, it never falls back."""
    from torchrec_tpu_torch.ops import _native

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.load_libraries()
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# B2's other seven optimizers (and rowwise Adagrad through the same code)
# ---------------------------------------------------------------------------

ADAM_FAMILY = ("adam", "lamb", "partial_rowwise_adam", "partial_rowwise_lamb")
OTHER_OPTIMIZERS = tuple(o for o in tbw.OPTIMIZERS if o != "rowwise_adagrad")
STEP = 3  # the Adam family's steps so far: the update is step 4


def _optim_case(optim, seed):
    """The B2 case of :func:`_b2_case` with random float32 states in the
    optimizer's layout (from 0.05 up, away from eps)."""
    table, _, ids, valid, segs, w, grad = _b2_case(seed)
    rng = np.random.RandomState(seed + 100)
    states = [(rng.rand(*((R,) if kind == "row" else (R, D))) + 0.05)
              .astype(np.float32) for kind in tbw.STATE_LAYOUTS[optim]]
    return table, states, ids, valid, segs, w, grad


def _port_bc():
    return tfu.bias_corrections(tfu.FusedOptimConfig(), STEP + 1)


def _port_b2_optim(optim, case, wd=0.0, sr_seed=None, dtype="f32"):
    table, states, ids, valid, segs, w, grad = case
    t = _port_table(table, dtype)
    sts = [_t(x) for x in states]
    adam = optim in ADAM_FAMILY
    out = tbw.fused_sparse_update(
        t, None if adam or not sts else sts[0], _t(ids), _t(valid), _t(segs),
        _t(w), _t(grad), LR, eps=EPS, weight_decay=wd, sr_seed=sr_seed,
        optim=optim, states=sts if adam else None,
        bias_corrections=_port_bc() if adam else (1.0, 1.0))
    assert out[0] is t and all(a is b for a, b in zip(out[1], sts))
    return t.to(torch.float32).numpy(), [x.numpy() for x in sts]


def _jax_b2_optim(optim, case, wd=0.0, sr_seed=None, dtype="f32"):
    table, states, ids, valid, segs, w, grad = case
    adam = optim in ADAM_FAMILY
    kw = {}
    if adam:
        t = jnp.float32(STEP + 1)
        kw = dict(states=tuple(jnp.asarray(x) for x in states),
                  bias_corrections=(1.0 - 0.9 ** t, 1.0 - 0.999 ** t))
    mom = jnp.asarray(states[0]) if states and not adam else None
    jt, jst = jbwd.pallas_fused_sparse_update(
        _jax_table(table, dtype), mom, _j(ids), _j(valid), _j(segs), _j(w),
        _j(grad), jnp.float32(LR), eps=EPS, optim=optim, chunk=64, group=8,
        interpret=True, weight_decay=wd,
        sr_seed=None if sr_seed is None else jnp.int32(sr_seed), **kw)
    return (np.asarray(jt.astype(jnp.float32)),
            [np.asarray(x).reshape(np.shape(a)) for x, a in zip(jst, states)])


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("optim", OTHER_OPTIMIZERS)
def test_fused_update_optimizers_plain_match_pallas(optim, wd):
    case = _optim_case(optim, seed=11)
    table, states, ids, valid, segs = case[:5]
    pt, ps = _port_b2_optim(optim, case, wd)
    jt, js = _jax_b2_optim(optim, case, wd)
    np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-6)
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    # untouched rows and states stay bitwise as they were
    touched = np.isin(np.arange(R), ids[_kept(ids, valid, segs)])
    assert touched.sum() > 5 and (~touched).sum() > 5
    np.testing.assert_array_equal(pt[~touched], table[~touched])
    for a, b in zip(ps, states):
        np.testing.assert_array_equal(a[~touched], b[~touched])
    assert (pt[touched] != table[touched]).any(axis=1).all()


@pytest.mark.parametrize("optim", ["adagrad", "lamb"])
def test_fused_update_optimizers_bf16_within_one_ulp(optim):
    """bfloat16 tables with one shared seed: every element equal to the
    JAX kernel's or one bfloat16 ulp apart, and rounded stochastically."""
    case = _optim_case(optim, seed=12)
    pt, _ = _port_b2_optim(optim, case, sr_seed=777, dtype="bf16")
    jt, _ = _jax_b2_optim(optim, case, sr_seed=777, dtype="bf16")
    ulp = np.abs(pt.view(np.int32).astype(np.int64)
                 - jt.view(np.int32).astype(np.int64)) >> 16
    assert ulp.max() <= 1 and (ulp == 0).mean() > 0.99
    rn, _ = _port_b2_optim(optim, case, sr_seed=None, dtype="bf16")
    assert (rn != pt).any()


def _emulate_b2_optim(optim, case, wd, bc):
    """numpy float32 emulation of csrc/tbe_backward.cu for any optimizer:
    sort_by_row, one owner per run, slot-order accumulation, the lane
    columns with the xor butterfly for every mean and norm, one rounding
    per operation, ``_bwd_body``'s op order (``1 - beta`` in float32,
    rowwise Adagrad's ``((-lr) / (sqrt(m) + eps)) * g``)."""
    table, states, ids, valid, segs, w, grad = case
    table = table.copy()
    states = [x.copy() for x in states]
    srows, ssegs, sw = (x.numpy() for x in tbw.sort_by_row(
        _t(ids), _t(valid), _t(segs), _t(w), R, S))
    cols = tbw.lane_columns(D).numpy()
    f = np.float32

    def sum_sq(x):
        xp = np.concatenate([x * x, np.zeros((1,), f)])
        s = np.zeros((32,), f)
        for k in range(cols.shape[1]):
            s = s + xp[cols[:, k]]
        for off in (16, 8, 4, 2, 1):
            s = s + s[np.arange(32) ^ off]
        return s[0]

    def trust(a, b):
        return a / max(b, f(1e-12)) if a > 0 and b > 0 else f(1.0)

    b1, b2 = f(0.9), f(0.999)
    omb1, omb2 = f(1.0) - b1, f(1.0) - b2
    bc1, bc2 = f(bc[0]), f(bc[1])
    neg_lr = f(-LR)
    i = 0
    while i < V and srows[i] < R:
        r, j = srows[i], i
        g = np.zeros((D,), f)
        while j < V and srows[j] == r:
            g = g + grad[ssegs[j]] * sw[j]
            j += 1
        wr = table[r].copy()
        if wd:
            g = g + f(wd) * wr
        if optim == "sgd":
            delta = neg_lr * g
        elif optim == "lars_sgd":
            delta = (neg_lr * trust(np.sqrt(sum_sq(wr)),
                                    np.sqrt(sum_sq(g)))) * g
        elif optim == "adagrad":
            states[0][r] = states[0][r] + g * g
            delta = (neg_lr * g) / (np.sqrt(states[0][r]) + f(EPS))
        elif optim == "rowwise_adagrad":
            states[0][r] = states[0][r] + sum_sq(g) / f(D)
            delta = (neg_lr / (np.sqrt(states[0][r]) + f(EPS))) * g
        else:
            states[0][r] = b1 * states[0][r] + omb1 * g
            if optim.startswith("partial"):
                states[1][r] = b2 * states[1][r] + omb2 * (sum_sq(g) / f(D))
            else:
                states[1][r] = b2 * states[1][r] + (omb2 * g) * g
            vpe = np.sqrt(states[1][r]) / np.sqrt(bc2) + f(EPS)
            direction = (states[0][r] / bc1) / vpe
            if optim.endswith("lamb"):
                direction = direction * trust(np.sqrt(sum_sq(wr)),
                                              np.sqrt(sum_sq(direction)))
            delta = neg_lr * direction
        table[r] = wr + delta
        i = j
    return table, states


@pytest.mark.parametrize("optim", tbw.OPTIMIZERS)
def test_fused_update_optimizers_kernel_emulation_bit_equal(optim):
    case = _optim_case(optim, seed=13)
    et, es = _emulate_b2_optim(optim, case, 0.01, _port_bc())
    pt, ps = _port_b2_optim(optim, case, 0.01)
    np.testing.assert_array_equal(pt, et)
    for a, b in zip(ps, es):
        np.testing.assert_array_equal(a, b)


def test_fused_update_optimizers_order_differs_from_dedup():
    """B2's ``1 - beta`` is rounded in float32 and B6's from a double, so
    the same Adam step on the same inputs differs in the last bits."""
    assert np.float32(1.0) - np.float32(0.9) != np.float32(1.0 - 0.9)
    case = _optim_case("adam", seed=14)
    pt, _ = _port_b2_optim("adam", case)
    table, states, ids, valid, segs, w, grad = case
    t = _t(table)
    tbw.dedup_fused_sparse_update(
        t, [_t(x) for x in states], _t(ids), _t(valid), _t(segs), _t(w),
        _t(grad), "adam", LR, eps=EPS, bias_corrections=_port_bc())
    assert not np.array_equal(pt, t.numpy())
    np.testing.assert_allclose(pt, t.numpy(), rtol=1e-6, atol=1e-6)


def test_fused_update_optimizers_empty_batch_and_checks():
    for optim in OTHER_OPTIMIZERS:
        case = _optim_case(optim, seed=15)
        table, states, ids, valid, segs, w, grad = case
        e = torch.zeros(0, dtype=torch.int32)
        empty = (table, states, e.numpy(), e.bool().numpy(), e.numpy(),
                 None, grad)
        pt, ps = _port_b2_optim(optim, empty)
        nothing = (table, states, ids, np.zeros(V, bool), segs, w, grad)
        qt, qs = _port_b2_optim(optim, nothing)
        for t_, s_ in ((pt, ps), (qt, qs)):
            np.testing.assert_array_equal(t_, table)
            for a, b in zip(s_, states):
                np.testing.assert_array_equal(a, b)
    assert tbe.launch_counts()["fused_sparse_update"] == 0
    t = _t(table)
    with pytest.raises(ValueError):  # adam needs (m, v)
        tbw.fused_sparse_update(t, _t(states[0]), e, e.bool(), e, None,
                                _t(grad), LR, optim="adam")
    with pytest.raises(ValueError):  # adagrad needs its momentum
        tbw.fused_sparse_update(t, None, e, e.bool(), e, None, _t(grad), LR,
                                optim="adagrad")
    with pytest.raises(TypeError):  # adagrad's momentum is [R, D]
        tbw.fused_sparse_update(t, torch.zeros(R), e, e.bool(), e, None,
                                _t(grad), LR, optim="adagrad")
    with pytest.raises(ValueError):
        tbw.fused_sparse_update(t, None, e, e.bool(), e, None, _t(grad), LR,
                                optim="adamw")

