"""Port parity for the dedup kernel family's plain versions: the ragged
dedup pooled lookup (``ops/tbe.py::dedup_pooled_lookup``, B4) and the
dedup fused backward + optimizer for all eight optimizers
(``ops/tbe_backward.py::dedup_fused_sparse_update``, B6), against the JAX
package's XLA dedup lookup and XLA update path and its Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances, with their reasons:

* B4 float32: bitwise against both JAX arms (the XLA dedup lookup pools
  with separate multiply and add in slot order, and the Pallas kernel
  keeps them in separate lane loops), and bitwise against the port's own
  per-id lookup B1.
* B4 bfloat16: against the Pallas kernel at most one bfloat16 ulp
  (``rtol = 2**-7``; both accumulate in float32 and round once, and the
  float32 sums may differ in a last bit); against the XLA dedup lookup,
  which multiplies and sums in bfloat16, ``rtol = atol = 3e-2``.
* B6 against ``embedding_row_grads`` + ``apply_sparse_update`` (eager
  XLA): bitwise for sgd, adagrad and adam, whose math has no reduction
  over D, and for partial_rowwise_adam, whose one mean over D = 16 sums
  to the same bits in both orders on these inputs; ``atol = rtol = 1e-6``
  on the table and ``rtol = 1e-5`` on the states for rowwise_adagrad,
  lars_sgd, lamb and partial_rowwise_lamb, where the port's mean or norm
  sums lanes then an xor butterfly and XLA's ``jnp.mean`` /
  ``jnp.linalg.norm`` sum in another order (they differ by up to
  1.2e-7).
* B6 against the Pallas dedup kernel (rowwise_adagrad and adam): the same
  as against the XLA path, which that kernel equals bitwise.
* B6 bfloat16 with stochastic rounding from one shared seed: equal or one
  bfloat16 ulp apart (the float32 value before the rounding may differ in
  its last bits).

The CUDA kernels cannot run here; their walks are emulated in numpy
float32 (one rounding per operation, in the kernels' order) and must
equal the plain versions bit for bit, the property ``chip_smoke.py``
checks on the card with ``torch.equal``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import embedding_ops as jeo
from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import pallas_tbe as jtbe
from torchrec_tpu.ops import pallas_tbe_backward as jbwd
from torchrec_tpu_torch.ops import embedding_ops as teo
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.ops import tbe_backward as tbw

R, D, S, V = 64, 16, 8, 48
LR, EPS, WD = 0.05, 1e-8, 0.01
STEP = 3  # the Adam family's steps so far: the update is step 4
LOOKUP_CASES = {
    "uniform": ((0, R), (0, S), "rand"),
    "duplicate_heavy": ((0, 4), (0, S), "rand"),
    "empty_segments": ((0, R), (2, 5), "rand"),
    "no_weights": ((0, R), (0, S), None),
    "ids_out_of_range": ((-5, R + 10), (0, S), "rand"),
    "bad_segments": ((0, R), (-3, S + 3), "rand"),
}
BITWISE = ("sgd", "adagrad", "adam", "partial_rowwise_adam")


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bf16_exact(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _lookup_case(name, seed=0):
    (ilo, ihi), (slo, shi), wkind = LOOKUP_CASES[name]
    rng = np.random.RandomState(seed)
    table = _bf16_exact(rng.randn(R, D).astype(np.float32))
    ids = rng.randint(ilo, ihi, size=(V,)).astype(np.int32)
    segs = rng.randint(slo, shi, size=(V,)).astype(np.int32)
    w = rng.rand(V).astype(np.float32) if wkind else None
    return table, ids, segs, w


_pallas_b4 = jax.jit(functools.partial(
    jtbe.pallas_ragged_dedup_lookup, num_segments=S, chunk=32, group=8,
    interpret=True,
))


@jax.jit
def _xla_dedup(table, ids, segs, w):
    return jeo._dedup_pooled_lookup(table, ids, jnp.where(segs < 0, S, segs),
                                    w, S)


# ---------------------------------------------------------------------------
# B4: the ragged dedup pooled lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
def test_dedup_lookup_plain_matches_jax(case, dtype):
    table, ids, segs, w = _lookup_case(case)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tt = _t(table).to(tdt)
    got = tbe.dedup_pooled_lookup(tt, _t(ids), _t(segs), S, _t(w))
    assert got.shape == (S, D) and got.dtype == tdt
    # the per-id lookup B1 gives the same bits (f32 and bf16 alike)
    assert torch.equal(got, tbe.pooled_lookup(tt, _t(ids), _t(segs), S,
                                              _t(w)))
    assert torch.equal(got, teo.pooled_embedding_lookup(
        tt, _t(ids), _t(segs), S, _t(w), kernel="dedup"))
    got = got.to(torch.float32).numpy()
    jt = jnp.asarray(table).astype(jdt)
    jw = jnp.ones((V,), jnp.float32) if w is None else jnp.asarray(w)
    pallas = np.asarray(_pallas_b4(jt, _j(ids), _j(segs), weights=_j(w))
                        .astype(jnp.float32))
    xla = np.asarray(_xla_dedup(jt, _j(ids), _j(segs), jw)
                     .astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, xla)
    else:
        np.testing.assert_allclose(got, pallas, rtol=2.0**-7, atol=1e-6)
        np.testing.assert_allclose(got, xla, rtol=3e-2, atol=3e-2)


# segment lengths around the kernel walk's depth (4 row loads in flight)
# and its 32-slot metadata fetch
SEGMENT_LENGTHS = (1, 3, 4, 5, 7, 8, 9, 31, 32, 33, 64, 65, 1000)
WALK_DEPTH, WALK_FETCH = 4, 32


def _segment_case(length, seed):
    """Segment 2 holds ``length`` slots (half on 4 hot rows, some ids out
    of range), shuffled among 12 slots of other and invalid segments."""
    rng = np.random.RandomState(seed)
    table = _bf16_exact(rng.randn(R, D).astype(np.float32))
    others = [s for s in range(-2, S + 2) if s != 2]
    segs = np.concatenate([np.full(length, 2), rng.choice(others, size=12)])
    segs = segs[rng.permutation(segs.size)].astype(np.int32)
    n = segs.size
    ids = np.where(rng.rand(n) < 0.5, rng.randint(0, 4, size=(n,)),
                   rng.randint(-3, R + 3, size=(n,))).astype(np.int32)
    return table, ids, segs, rng.rand(n).astype(np.float32)


def _emulate_dedup_kernel(tt, ids, segs, w):
    """csrc/tbe_dedup.cu in numpy float32: the sized prep, then per
    segment the owner warp's walk over its slots in slot order, 32 slots'
    index, key and weight at a time, rows read straight from the table
    (widening is exact) by the key's id clipped to the table, 4 row loads
    before the adds, one multiply and one add per slot, each rounded, and
    one rounding of the sum to the table's dtype."""
    ukeys, inv, sw, offs = (x.numpy() for x in tbe.dedup_prepare_sized(
        _t(ids), _t(segs), _t(w), S))
    table = tt.to(torch.float32).numpy()
    out = np.zeros((S, D), np.float32)
    added = 0
    for s in range(S):
        begin, end = offs[s], offs[s + 1]
        acc = np.zeros((D,), np.float32)
        for base in range(begin, end, WALK_FETCH):
            n = min(WALK_FETCH, end - base)
            keys = ukeys[inv[base:base + n]]
            assert (keys != tbe.SENTINEL).all()
            rows = np.clip((keys & 0xFFFFFFFF) - 2**31, 0, R - 1)
            wi = sw[base:base + n]
            for j0 in range(0, n, WALK_DEPTH):
                loaded = table[rows[j0:j0 + WALK_DEPTH]]
                for k, v in enumerate(loaded):
                    acc = acc + v * wi[j0 + k]
                    added += 1
        out[s] = acc
    assert added == offs[-1]
    return _t(out).to(tt.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["duplicate_heavy", "ids_out_of_range",
                                  "bad_segments", "no_weights"] + [
    f"segment_of_{n}" for n in SEGMENT_LENGTHS])
def test_dedup_lookup_kernel_emulation_bit_equal(case, dtype):
    """dedup_prepare_sized + the one launch of csrc/tbe_dedup.cu, emulated,
    equals the plain version bit for bit, on the lookup cases and on a
    segment of each of SEGMENT_LENGTHS slots."""
    if case.startswith("segment_of_"):
        table, ids, segs, w = _segment_case(int(case.split("_")[-1]), seed=9)
    else:
        table, ids, segs, w = _lookup_case(case, seed=5)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tt = _t(table).to(tdt)
    plain = tbe.dedup_pooled_lookup_plain(tt, _t(ids), _t(segs), S, _t(w))
    assert torch.equal(_emulate_dedup_kernel(tt, ids, segs, w), plain)


def test_dedup_lookup_empty_batch_and_wrapper_checks():
    table = torch.ones((R, D))
    e = torch.zeros(0, dtype=torch.int32)
    out = tbe.dedup_pooled_lookup(table, e, e, S)
    assert out.shape == (S, D) and not out.any()
    with pytest.raises(TypeError):
        tbe.dedup_pooled_lookup(table.to(torch.float64), e, e, S)
    with pytest.raises(ValueError):
        teo.pooled_embedding_lookup(table, e, e, S, kernel="xla")
    meta = torch.device("meta")
    m = torch.empty((4,), dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        tbe.dedup_pooled_lookup(torch.empty((R, D), device=meta), m, m, S)


# ---------------------------------------------------------------------------
# B6: the dedup fused backward + optimizer
# ---------------------------------------------------------------------------


def _update_case(optim, seed=3):
    """Heavy duplicates, dropped slots (invalid, negative and
    out-of-range segments, ids past the table) and random states."""
    rng = np.random.RandomState(seed)
    table = _bf16_exact(rng.randn(R, D).astype(np.float32))
    ids = np.minimum(rng.zipf(1.3, V) - 1, R + 3).astype(np.int32)
    segs = rng.randint(-3, S + 4, size=V).astype(np.int32)
    valid = rng.rand(V) > 0.15
    w = rng.rand(V).astype(np.float32)
    grad = rng.randn(S, D).astype(np.float32)
    states = [rng.rand(*((R,) if kind == "row" else (R, D)))
              .astype(np.float32) for kind in tbw.STATE_LAYOUTS[optim]]
    return table, states, ids, valid, segs, w, grad


def _ok(ids, valid, segs):
    return valid & (segs >= 0) & (segs < S) & (ids >= 0) & (ids < R)


def _state_dict(optim, states, array):
    if optim in ("adam", "lamb", "partial_rowwise_adam",
                 "partial_rowwise_lamb"):
        return {"m": array(states[0]), "v": array(states[1]), "step": STEP}
    return {"momentum": array(states[0])} if states else {}


def _bc(t):
    return tfu.bias_corrections(tfu.FusedOptimConfig(), t)


def _port_b6(optim, case, wd, dtype=torch.float32, sr_seed=None):
    table, states, ids, valid, segs, w, grad = case
    t = _t(table).to(dtype)
    sts = [_t(s) for s in states]
    out = tbw.dedup_fused_sparse_update(
        t, sts, _t(ids), _t(valid), _t(segs), _t(w), _t(grad), optim, LR,
        eps=EPS, weight_decay=wd, bias_corrections=_bc(STEP + 1),
        sr_seed=sr_seed)
    assert out[0] is t and all(a is b for a, b in zip(out[1], sts))
    return t.to(torch.float32).numpy(), [s.numpy() for s in sts]


def _jax_xla(optim, case, wd):
    table, states, ids, valid, segs, w, grad = case
    cfg = jfu.FusedOptimConfig(optim=jfu.EmbOptimType(optim),
                               learning_rate=LR, eps=EPS, weight_decay=wd)
    state = _state_dict(optim, states, jnp.asarray)
    if "step" in state:
        state["step"] = jnp.asarray(STEP, jnp.int32)
    ok = jnp.asarray(valid) & (jnp.asarray(segs) >= 0) & (
        jnp.asarray(segs) < S)
    rg = jeo.embedding_row_grads(
        jnp.asarray(grad), jnp.where(jnp.asarray(segs) < 0, S,
                                     jnp.asarray(segs)), jnp.asarray(w))
    t, st = jfu.apply_sparse_update(jnp.asarray(table), state,
                                    jnp.asarray(ids), ok, rg, cfg)
    keys = ["m", "v"] if "m" in st else (["momentum"] if st else [])
    return np.asarray(t), [np.asarray(st[k]) for k in keys]


def _assert_update_close(optim, got, want):
    (pt, ps), (jt, js) = got, want
    if optim in BITWISE:
        np.testing.assert_array_equal(pt, jt)
        for a, b in zip(ps, js):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-6)
        for a, b in zip(ps, js):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("wd", [0.0, WD])
@pytest.mark.parametrize("optim", tbw.OPTIMIZERS)
def test_dedup_update_plain_matches_xla_path(optim, wd):
    case = _update_case(optim)
    table, states, ids, valid, segs = case[:5]
    got = _port_b6(optim, case, wd)
    _assert_update_close(optim, got, _jax_xla(optim, case, wd))
    # untouched rows and states stay as they were, touched rows move
    touched = np.isin(np.arange(R), ids[_ok(ids, valid, segs)])
    assert touched.sum() > 5 and (~touched).sum() > 5
    np.testing.assert_array_equal(got[0][~touched], table[~touched])
    for a, b in zip(got[1], states):
        np.testing.assert_array_equal(a[~touched], b[~touched])
    assert (got[0][touched] != table[touched]).any(axis=1).all()


@pytest.mark.parametrize("optim", ["rowwise_adagrad", "adam"])
def test_dedup_update_plain_matches_pallas(optim):
    case = _update_case(optim, seed=4)
    table, states, ids, valid, segs, w, grad = case
    kw = {}
    mom = None
    if optim == "adam":
        t = jnp.float32(STEP + 1)
        kw = dict(states=tuple(jnp.asarray(s) for s in states),
                  bias_corrections=(1.0 - 0.9 ** t, 1.0 - 0.999 ** t))
    else:
        mom = jnp.asarray(states[0])
    jt, jst = jbwd.pallas_dedup_fused_sparse_update(
        jnp.asarray(table), mom, _j(ids), _j(valid), _j(segs), _j(w),
        _j(grad), jnp.float32(LR), eps=EPS, optim=optim, chunk=32, group=8,
        interpret=True, weight_decay=WD, **kw)
    want = (np.asarray(jt), [np.asarray(s).reshape(np.shape(a))
                             for s, a in zip(jst, states)])
    _assert_update_close(optim, _port_b6(optim, case, WD), want)


def test_dedup_update_bf16_stochastic_rounding_within_one_ulp():
    case = _update_case("rowwise_adagrad", seed=6)
    table, states, ids, valid, segs, w, grad = case
    jt, _ = jbwd.pallas_dedup_fused_sparse_update(
        jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(states[0]),
        _j(ids), _j(valid), _j(segs), _j(w), _j(grad), jnp.float32(LR),
        eps=EPS, optim="rowwise_adagrad", chunk=32, group=8, interpret=True,
        sr_seed=jnp.int32(777))
    jt = np.asarray(jt.astype(jnp.float32))
    pt, _ = _port_b6("rowwise_adagrad", case, 0.0, torch.bfloat16, 777)
    ulp = np.abs(pt.view(np.int32).astype(np.int64)
                 - jt.view(np.int32).astype(np.int64)) >> 16
    assert ulp.max() <= 1 and (ulp == 0).mean() > 0.99
    rn, _ = _port_b6("rowwise_adagrad", case, 0.0, torch.bfloat16, None)
    assert (rn != pt).any()  # stochastic rounding differs from nearest


def _emulate_b6(optim, case, wd, bc):
    """numpy float32 emulation of csrc/tbe_dedup_backward.cu: sort_by_row,
    one owner per run, slot-order accumulation, the lane columns with the
    xor butterfly for every mean and norm, one rounding per operation."""
    table, states, ids, valid, segs, w, grad = case
    table = table.copy()
    states = [s.copy() for s in states]
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
    omb1, omb2 = f(1.0 - 0.9), f(1.0 - 0.999)
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
            t = trust(np.sqrt(sum_sq(wr)), np.sqrt(sum_sq(g)))
            delta = (neg_lr * t) * g
        elif optim == "adagrad":
            states[0][r] = states[0][r] + g * g
            delta = (neg_lr * g) / (np.sqrt(states[0][r]) + f(EPS))
        elif optim == "rowwise_adagrad":
            states[0][r] = states[0][r] + sum_sq(g) / f(D)
            scale = f(1.0) / (np.sqrt(states[0][r]) + f(EPS))
            delta = (neg_lr * g) * scale
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
def test_dedup_update_kernel_emulation_bit_equal(optim):
    case = _update_case(optim, seed=8)
    bc = _bc(STEP + 1)
    et, es = _emulate_b6(optim, case, WD, bc)
    pt, ps = _port_b6(optim, case, WD)
    np.testing.assert_array_equal(pt, et)
    for a, b in zip(ps, es):
        np.testing.assert_array_equal(a, b)


def test_dedup_update_empty_batch_is_identity():
    case = _update_case("adam", seed=9)
    table, states, ids, valid, segs, w, grad = case
    t, sts = _t(table), [_t(s) for s in states]
    e = torch.zeros(0, dtype=torch.int32)
    tbw.dedup_fused_sparse_update(t, sts, e, e.bool(), e, None, _t(grad),
                                  "adam", LR, bias_corrections=_bc(1))
    tbw.dedup_fused_sparse_update(t, sts, _t(ids), torch.zeros(V, dtype=bool),
                                  _t(segs), _t(w), _t(grad), "adam", LR,
                                  bias_corrections=_bc(1))
    assert torch.equal(t, _t(table))
    assert all(torch.equal(a, _t(b)) for a, b in zip(sts, states))
    assert tbe.launch_counts()["dedup_fused_sparse_update"] == 0
    with pytest.raises(ValueError):  # adam needs (m, v)
        tbw.dedup_fused_sparse_update(t, sts[:1], e, e.bool(), e, None,
                                      _t(grad), "adam", LR)
    with pytest.raises(TypeError):  # of [R, D] each
        tbw.dedup_fused_sparse_update(t, (sts[0], sts[0][:, 0].clone()), e,
                                      e.bool(), e, None, _t(grad), "adam", LR)
    with pytest.raises(ValueError):
        tbw.dedup_fused_sparse_update(t, (), e, e.bool(), e, None, _t(grad),
                                      "adamw", LR)


def test_bias_corrections_match_jax():
    """``1 - beta**t`` on the host (torch's float32 CPU pow) against the
    JAX package's f32 XLA pow, for steps 1..100: every value equal."""
    cfg = tfu.FusedOptimConfig()

    @jax.jit
    def jax_bc(step):
        t = step.astype(jnp.float32)
        return 1.0 - cfg.beta1 ** t, 1.0 - cfg.beta2 ** t

    for step in range(1, 101):
        want = tuple(float(np.float32(x)) for x in jax_bc(jnp.int32(step)))
        assert tfu.bias_corrections(cfg, step) == want, step


@pytest.mark.parametrize("optim", ["rowwise_adagrad", "adam", "lars_sgd"])
def test_apply_sparse_update_segments_dedup_dispatch(optim):
    """The fused optimizer's entry point on the dedup kernel equals the
    XLA-path port (``apply_sparse_update``) and advances the Adam
    family's step; the per-id kernel takes the same optimizer in B2's op
    order (``fused_sparse_update_plain``)."""
    case = _update_case(optim, seed=10)
    table, states, ids, valid, segs, w, grad = case
    cfg = tfu.FusedOptimConfig(optim=tfu.EmbOptimType(optim),
                               learning_rate=LR, weight_decay=WD)
    sg = tfu.SparseSegGrad(_t(ids), _t(valid), _t(segs), _t(w), _t(grad))
    t, st = _t(table), _state_dict(optim, states, _t)
    out = tfu.apply_sparse_update_segments(t, st, sg, cfg,
                                           update_kernel="dedup")
    assert out[0] is t and out[1] is st
    t2, st2 = _t(table), _state_dict(optim, states, _t)
    rg = teo.embedding_row_grads(_t(grad), torch.where(
        _t(segs) < 0, S, _t(segs)), _t(w))
    tfu.apply_sparse_update(t2, st2, _t(ids), sg.ok(), rg, cfg)
    assert torch.equal(t, t2)
    for k in st:
        if k == "step":
            assert st[k] == st2[k] == STEP + 1
        else:
            assert torch.equal(st[k], st2[k])
    t3, st3 = _t(table), _state_dict(optim, states, _t)
    tfu.apply_sparse_update_segments(t3, st3, sg, cfg)
    t4, st4 = _t(table), _state_dict(optim, states, _t)
    adam = "m" in st4
    tbw.fused_sparse_update_plain(
        t4, st4.get("momentum"), sg.ids, sg.valid, sg.segments, sg.weights,
        sg.grad_seg, LR, EPS, WD, optim=optim,
        states=(st4["m"], st4["v"]) if adam else None,
        bias_corrections=_bc(STEP + 1))
    assert torch.equal(t3, t4)
    for k in st3:
        if k == "step":
            assert st3[k] == STEP + 1
        else:
            assert torch.equal(st3[k], st4[k])


def test_row_grads_and_aggregation_match_jax():
    case = _update_case("sgd", seed=11)
    _, _, ids, valid, segs, w, grad = case
    segs_j = np.where(segs < 0, S, segs)
    want = np.asarray(jeo.embedding_row_grads(_j(grad), _j(segs_j), _j(w)))
    got = teo.embedding_row_grads(_t(grad), _t(segs_j), _t(w))
    np.testing.assert_array_equal(got.numpy(), want)
    jr, jg = jeo.aggregate_duplicate_rows(_j(ids), _j(valid), _j(want))
    tr, tg = teo.aggregate_duplicate_rows(_t(ids), _t(valid), got)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # every real row's sum is equal; the invalid slots' group (row = int32
    # max, dropped by every caller) is summed by JAX and left zero here
    real = tr.numpy() < np.iinfo(np.int32).max
    assert 5 < real.sum() < V and np.asarray(jg)[~real].any()
    np.testing.assert_array_equal(tg.numpy()[real], np.asarray(jg)[real])
    assert not tg.numpy()[~real].any()
