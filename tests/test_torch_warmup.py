"""Port parity for ``optim/warmup.py``: every policy's schedule equals the
JAX package's ``warmup_schedule`` called on each step, bit for bit in
float32, over steps 0-200 (stage boundaries and the held tail included),
and the warmup-wrapped Adagrad follows ``warmup_optimizer(optax.adagrad)``
within ``rtol = 1e-6, atol = 1e-7`` (neither side's ``rsqrt`` is
correctly rounded)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.optim import warmup as J
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.optim import warmup as T

# (policy, max_iters, value, lr_scale, decay_iters) per stage
SCHEDULES = {
    "linear": [("LINEAR", 20, 1.0, 1.0, -1)],
    "linear_scaled": [("LINEAR", 33, 0.7, 1.3, -1)],
    "constant": [("CONSTANT", 50, 0.3, 1.7, -1)],
    "poly": [("POLY", 37, 0.9, 1.1, -1)],
    "poly_decay_iters": [("POLY", 41, 1.0, 1.0, 17)],
    "invsqrt": [("INVSQRT", 29, 1.0, 1.0, -1)],
    "invsqrt_decay_iters": [("INVSQRT", 13, 1.3, 0.5, 40)],
    "none_step": [("NONE", 3, 1.0, 1.0, -1), ("STEP", 4, 1.0, 1.0, -1)],
    "chain": [("LINEAR", 7, 0.5, 2.0, -1), ("CONSTANT", 5, 0.3, 1.0, -1),
              ("POLY", 30, 1.0, 0.7, 45), ("INVSQRT", 25, 0.9, 1.0, -1)],
    "empty": [],
}


def _stages(mod, spec):
    return [mod.WarmupStage(mod.WarmupPolicy[p], m, v, l, d)
            for p, m, v, l, d in spec]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_bitwise(name):
    spec = SCHEDULES[name]
    js = J.warmup_schedule(_stages(J, spec), base_multiplier=0.75)
    ts = T.warmup_schedule(_stages(T, spec), base_multiplier=0.75)
    want = np.asarray([np.float32(js(i)) for i in range(201)])
    got = np.asarray([ts(i) for i in range(201)], np.float32)
    assert got.tobytes() == want.tobytes(), np.flatnonzero(got != want)
    assert all(np.float32(ts(i)) == ts(i) for i in range(201))


def test_warmup_adagrad_matches_optax_chain():
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (0.1 if i else 0.0)).astype(np.float32)
              for k, s in shapes.items()} for i in range(12)]
    spec = SCHEDULES["chain"]
    lr = 0.05
    tx = J.warmup_optimizer(optax.adagrad(lr), _stages(J, spec))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = T.warmup_optimizer(adagrad(lr), _stages(T, spec))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert ts["count"] == int(js[1].count) == len(grads)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            ts["base"][k].numpy(), np.asarray(js[0][0].sum_of_squares[k]),
            rtol=1e-6, atol=1e-7)
