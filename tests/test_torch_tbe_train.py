"""Port parity for the training kernels' plain versions: the float pooled
lookup (``ops/tbe.py::pooled_lookup``, B1) and the fused backward +
rowwise Adagrad (``ops/tbe_backward.py::fused_sparse_update``, B2),
against the JAX package's Pallas kernels in interpret mode and its XLA
lookup, on the same numpy inputs.

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
* B2 bfloat16 with a shared seed: equal or one bfloat16 ulp apart (the
  float32 value before the rounding may differ in its last bits).

The CUDA kernels cannot run here; their walk is emulated in numpy float32
(one rounding per operation, in the kernels' order) and must equal the
plain versions bit for bit, the property ``chip_smoke.py`` checks on the
card with ``torch.equal``.
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
    assert out[0] is t and out[1] is m  # in place
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
        # every optimizer's state has the JAX layout (the dedup kernel
        # takes all eight); the per-id kernel raises for all but one
        got = tfu.init_optimizer_state(tfu.FusedOptimConfig(optim=optim), R,
                                       D)
        want = jinit(JCfg(optim=JOptim(optim.value)), R, D)
        assert {k: np.shape(v) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        if optim == tfu.EmbOptimType.ROWWISE_ADAGRAD:
            continue
        with pytest.raises(NotImplementedError):
            tfu.apply_sparse_update_segments(
                t, st, sg, tfu.FusedOptimConfig(optim=optim))


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
