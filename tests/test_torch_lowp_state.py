"""Low-precision optimizer state and the stochastic-rounding switch of the
port's fused updates (``ops/fused_update.py``, ``ops/tbe_backward.py``)
against the JAX package on the CPU.

* The plain versions of B6 (the XLA path's op order) and B2 (its per-id
  order) over a bfloat16 or float16 state, for the six optimizers with a
  state, against ``apply_sparse_update`` with the same ``momentum_dtype``
  (the JAX Pallas kernels refuse a non-f32 state, so XLA is the
  reference): the stored states bitwise; the table bitwise where the JAX
  update's op order is the kernel's (:data:`TABLE_BITWISE`), else within
  the f32 tolerance of ``test_torch_dedup_tbe.py`` (rtol 1e-6, atol 1e-6).
* The reference's weakly typed betas: ``0.9 * bf16(1)`` is 0.8984375 and
  ``0.999 * bf16(3)`` stays 3.0 (0.999 rounds to 1.0 in bfloat16), so a
  bfloat16 ``v`` never decays; the port computes the same.
* The switch off on a bfloat16 table: one rounding to nearest, as
  ``pallas_fused_sparse_update(stochastic_rounding=False)``, and no seed
  reaches the kernel even when the step hands one.
* ``stochastic_round_to_bf16``'s contract over a ``torch.Generator``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import embedding_ops as jeo
from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import pallas_tbe_backward as jbwd
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import tbe_backward as tbw

R, D, S, V = 64, 16, 8, 48
LR, EPS = 0.05, 1e-8
STEP = 3  # the Adam family's steps so far: the update is step 4
STATEFUL = ("adagrad", "rowwise_adagrad", "adam", "partial_rowwise_adam",
            "lamb", "partial_rowwise_lamb")
ADAM = ("adam", "partial_rowwise_adam", "lamb", "partial_rowwise_lamb")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
# (state dtype, optimizer) whose table B6's plain version gives bitwise
TABLE_BITWISE = {("bf16", "adagrad"), ("bf16", "adam"),
                 ("bf16", "partial_rowwise_adam"), ("f16", "adagrad"),
                 ("f16", "partial_rowwise_adam")}


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(optim, jdtype, seed=3):
    """Duplicated ids, dropped slots, a bf16-exact table and random
    states exact in the state dtype."""
    rng = np.random.RandomState(seed)
    table = np.asarray(jnp.asarray(rng.randn(R, D).astype(np.float32),
                                   jnp.bfloat16).astype(jnp.float32))
    ids = np.minimum(rng.zipf(1.3, V) - 1, R + 3).astype(np.int32)
    segs = rng.randint(-3, S + 4, size=V).astype(np.int32)
    valid = rng.rand(V) > 0.15
    w = rng.rand(V).astype(np.float32)
    grad = rng.randn(S, D).astype(np.float32)
    states = [np.asarray(jnp.asarray(
        rng.rand(*((R,) if k == "row" else (R, D))).astype(np.float32),
        jdtype).astype(jnp.float32)) for k in tbw.STATE_LAYOUTS[optim]]
    return table, states, ids, valid, segs, w, grad


def _jax_xla(optim, jdtype, case):
    table, states, ids, valid, segs, w, grad = case
    cfg = jfu.FusedOptimConfig(optim=jfu.EmbOptimType(optim),
                               learning_rate=LR, eps=EPS,
                               momentum_dtype=jdtype)
    if optim in ADAM:
        state = {"m": jnp.asarray(states[0], jdtype),
                 "v": jnp.asarray(states[1], jdtype),
                 "step": jnp.asarray(STEP, jnp.int32)}
        keys = ("m", "v")
    else:
        state = {"momentum": jnp.asarray(states[0], jdtype)}
        keys = ("momentum",)
    ok = jnp.asarray(valid) & (jnp.asarray(segs) >= 0) & (
        jnp.asarray(segs) < S)
    rg = jeo.embedding_row_grads(
        jnp.asarray(grad), jnp.where(jnp.asarray(segs) < 0, S,
                                     jnp.asarray(segs)), jnp.asarray(w))
    t, st = jfu.apply_sparse_update(jnp.asarray(table), state,
                                    jnp.asarray(ids), ok, rg, cfg)
    assert all(st[k].dtype == jdtype for k in keys)
    return np.asarray(t), [np.asarray(st[k].astype(jnp.float32))
                           for k in keys]


def _port(optim, tdtype, case, per_id):
    table, states, ids, valid, segs, w, grad = case
    t = _t(table)
    sts = [_t(s).to(tdtype) for s in states]
    bc = tfu.bias_corrections(tfu.FusedOptimConfig(), STEP + 1)
    args = (_t(ids), _t(valid), _t(segs), _t(w), _t(grad))
    if per_id:
        adam = optim in ADAM
        tbw.fused_sparse_update(
            t, None if adam else sts[0], *args, LR, eps=EPS, optim=optim,
            states=sts if adam else None, bias_corrections=bc)
    else:
        tbw.dedup_fused_sparse_update(t, sts, *args, optim, LR, eps=EPS,
                                      bias_corrections=bc)
    assert all(s.dtype == tdtype for s in sts)
    return t.numpy(), [s.to(torch.float32).numpy() for s in sts]


@pytest.mark.parametrize("per_id", [False, True], ids=["b6", "b2"])
@pytest.mark.parametrize("sdtype", sorted(DTYPES))
@pytest.mark.parametrize("optim", STATEFUL)
def test_lowp_state_plain_matches_apply_sparse_update(optim, sdtype,
                                                      per_id):
    jdtype, tdtype = DTYPES[sdtype]
    case = _case(optim, jdtype)
    pt, ps = _port(optim, tdtype, case, per_id)
    jt, js = _jax_xla(optim, jdtype, case)
    for a, b in zip(ps, js):  # the stored states: bitwise, both orders
        np.testing.assert_array_equal(a, b)
    if not per_id and (sdtype, optim) in TABLE_BITWISE:
        np.testing.assert_array_equal(pt, jt)
    else:
        np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-6)
    assert (pt != case[0]).any()


def test_weakly_typed_betas_pinned():
    """The reference's bf16 ``b * m``: the beta rounded to bf16 first, the
    product rounded to bf16; the port's ``_decay`` gives the same."""
    one = jnp.ones((1,), jnp.bfloat16)
    three = jnp.full((1,), 3.0, jnp.bfloat16)
    assert float((0.9 * one)[0]) == 0.8984375
    assert float((0.999 * three)[0]) == 3.0
    assert float(tbw._decay(0.9, torch.ones(1, dtype=torch.bfloat16))) == (
        0.8984375)
    assert float(tbw._decay(0.999, torch.full((1,), 3.0,
                                              dtype=torch.bfloat16))) == 3.0
    assert float((0.999 * jnp.full((1,), 3.0, jnp.float16))[0]) == float(
        tbw._decay(0.999, torch.full((1,), 3.0, dtype=torch.float16)))
    # so a bf16 v never decays: one Adam step adds (1 - b2) g g to it
    case = _case("adam", jnp.bfloat16, seed=5)
    _, ps = _port("adam", torch.bfloat16, case, per_id=False)
    _, js = _jax_xla("adam", jnp.bfloat16, case)
    np.testing.assert_array_equal(ps[1], js[1])
    table, states, ids, valid, segs = case[:5]
    ok = valid & (segs >= 0) & (segs < S) & (ids >= 0) & (ids < R)
    untouched = ~np.isin(np.arange(R), ids[ok])
    np.testing.assert_array_equal(ps[1][untouched], states[1][untouched])
    assert (ps[1][~untouched] >= states[1][~untouched]).all()


def test_config_and_state_dtype():
    with pytest.raises(ValueError):
        tfu.FusedOptimConfig(momentum_dtype=torch.float64)
    for dt in tfu.MOMENTUM_DTYPES:
        for optim in tfu.EmbOptimType:
            cfg = tfu.FusedOptimConfig(optim=optim, momentum_dtype=dt)
            st = tfu.init_optimizer_state(cfg, 10, 4)
            assert all(v.dtype == dt for k, v in st.items() if k != "step")
            assert isinstance(st.get("step", 0), int)
    t = torch.zeros((4, 4))
    with pytest.raises(TypeError):  # states of two dtypes
        tbw.dedup_fused_sparse_update(
            t, (torch.zeros((4, 4)), torch.zeros(4, dtype=torch.bfloat16)),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=bool),
            torch.zeros(1, dtype=torch.int32), None, torch.zeros((1, 4)),
            "partial_rowwise_adam", LR)


def test_sr_off_rounds_once_to_nearest_as_pallas():
    """A bf16 table with the switch off: B2's plain version against the
    Pallas kernel with ``stochastic_rounding=False`` (interpret mode),
    equal but where B2's f32 tolerance crosses a bf16 rounding boundary;
    and through ``apply_sparse_update_segments``
    a step's seed reaches no kernel: the same bits as no seed, not
    those of the switch on."""
    case = _case("rowwise_adagrad", jnp.float32, seed=7)
    table, states, ids, valid, segs, w, grad = case
    jt, (jm,) = jbwd.pallas_fused_sparse_update(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(states[0]),
        jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(segs),
        jnp.asarray(w), jnp.asarray(grad), jnp.float32(LR), eps=EPS,
        optim="rowwise_adagrad", chunk=64, group=8, interpret=True,
        stochastic_rounding=False, sr_seed=jnp.int32(99))
    t = _t(table).to(torch.bfloat16)
    m = _t(states[0])
    tbw.fused_sparse_update(t, m, _t(ids), _t(valid), _t(segs), _t(w),
                            _t(grad), LR, eps=EPS)
    got, want = t.float().numpy(), np.asarray(jt.astype(jnp.float32))
    # rounded once to nearest from float32 values within B2's tolerance:
    # the same bf16 value but where that tolerance straddles a rounding
    # boundary, there one bf16 ulp (2^-8 relative) apart
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert (got == want).mean() >= 0.99
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    sg = tfu.SparseSegGrad(_t(ids), _t(valid), _t(segs), _t(w), _t(grad))
    runs = {}
    for kernel in tfu.FUSED_KERNELS:
        for sr in (False, True):
            cfg = tfu.FusedOptimConfig(learning_rate=LR,
                                       stochastic_rounding=sr)
            tt = _t(table).to(torch.bfloat16)
            st = tfu.init_optimizer_state(cfg, R, D)
            st["momentum"].copy_(_t(states[0]))
            tfu.apply_sparse_update_segments(tt, st, sg, cfg, sr_seed=99,
                                             update_kernel=kernel)
            runs[kernel, sr] = tt
        tt = _t(table).to(torch.bfloat16)
        st = {"momentum": _t(states[0])}
        tfu.apply_sparse_update_segments(
            tt, st, sg, tfu.FusedOptimConfig(learning_rate=LR),
            update_kernel=kernel)
        assert torch.equal(runs[kernel, False], tt)
        assert not torch.equal(runs[kernel, False], runs[kernel, True])


def test_stochastic_round_to_bf16_contract():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(256) * 3
    x[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0])
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lo = (bits & 0xFFFF0000)
    lo = torch.where(lo > 2**31 - 1, lo - 2**32, lo).to(torch.int32)
    lo = lo.view(torch.float32)  # toward zero
    ulp = (lo.abs().to(torch.bfloat16).view(torch.int16) + 1).view(
        torch.bfloat16).float() - lo.abs()
    hi = lo + torch.sign(lo) * ulp  # away from zero
    draws = torch.stack([tfu.stochastic_round_to_bf16(x, gen).float()
                         for _ in range(2000)])
    fin = torch.isfinite(x)
    assert ((draws[:, fin] == lo[fin]) | (draws[:, fin] == hi[fin])).all()
    assert torch.equal(draws[0, :2], x[:2]) and torch.isnan(draws[0, 2])
    err = (draws[:, fin].double().mean(0) - x[fin].double()).abs()
    assert (err <= 5 * ulp[fin].double() / np.sqrt(2000) + 1e-12).all()
    again = tfu.stochastic_round_to_bf16(
        x, torch.Generator().manual_seed(1))
    assert torch.equal(again.view(torch.int16), tfu.stochastic_round_to_bf16(
        x, torch.Generator().manual_seed(1)).view(torch.int16))
    with pytest.raises(TypeError):
        tfu.stochastic_round_to_bf16(x.double(), gen)
