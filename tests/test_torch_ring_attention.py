"""The port's ring attention across 4 ranks (4 gloo processes on the CPU,
one launch) against the JAX package's ``full_attention_reference`` and the
port's own unsharded version: the forward with and without a causal mask
(by global position) and a padding mask (the last rank's keys all
padding), the gradients of q, k and v through the ring's hand-written
backward (JAX's ``jax.grad`` of the unsharded attention and the port's
autograd of it), and the sequence-sharded multi-head step.

Tolerances: outputs ``atol = 1e-5`` (the online softmax and the
unsharded softmax round differently; the oracle test of the JAX package
holds its own ring to 2e-5); gradients ``atol = 2e-5`` (the ring's
backward recomputes the probabilities from each row's log-sum-exp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops.ring_attention import (
    full_attention_reference as j_full,
)
from torchrec_tpu_torch.ops.ring_attention import (
    RingMultiHeadAttention,
    full_attention_reference,
    ring_attention,
)
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_sequence_workers as workers

WORLD, B, T, H, Dh = 4, 2, 32, 2, 8
CASES = {"plain": (False, False), "causal": (True, False),
         "padded": (False, True), "causal_padded": (True, True)}


def _case(seed, causal, padded):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, T, H, Dh).astype(np.float32)
                  for _ in range(4))
    valid = np.ones((B, T), bool)
    if padded:  # the last quarter (rank 3's keys) and a few more
        valid[0, T - T // WORLD - 3:] = False
        valid[1, T - T // WORLD:] = False
    return {"q": q, "k": k, "v": v, "g": g, "valid": valid,
            "causal": causal}


def _mha_case():
    rng = np.random.RandomState(9)
    Dm = H * Dh
    p = RingMultiHeadAttention.init(torch.Generator().manual_seed(0), Dm)
    c = {k: v.numpy() for k, v in p.items()}
    c.update(x=rng.randn(B, T, Dm).astype(np.float32),
             valid=np.ones((B, T), bool), causal=True, heads=H)
    return c


@pytest.fixture(scope="module")
def world():
    cases = {name: _case(i, *flags)
             for i, (name, flags) in enumerate(CASES.items())}
    cases["mha"] = _mha_case()
    return cases, launch(workers.ring_rank, WORLD, args=(cases,),
                         timeout=120)


def _joined(ranks, name, i):
    return np.concatenate([r[name][i] for r in ranks], axis=1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_forward_matches_full_attention(world, name):
    cases, ranks = world
    c = cases[name]
    args = [jnp.asarray(c[x]) for x in ("q", "k", "v")]
    want = np.asarray(j_full(*args, kv_valid=jnp.asarray(c["valid"]),
                             causal=c["causal"]))
    got = _joined(ranks, name, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    port = full_attention_reference(
        *(torch.from_numpy(c[x]) for x in ("q", "k", "v")),
        torch.from_numpy(c["valid"]), c["causal"]).numpy()
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_grads_match_unsharded_autodiff(world, name):
    cases, ranks = world
    c = cases[name]

    def j_loss(q, k, v):
        o = j_full(q, k, v, kv_valid=jnp.asarray(c["valid"]),
                   causal=c["causal"])
        return jnp.sum(o * jnp.asarray(c["g"]))

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(c[x]) for x in ("q", "k", "v")))
    qkv = [torch.from_numpy(c[x]).requires_grad_() for x in ("q", "k", "v")]
    o = full_attention_reference(*qkv, torch.from_numpy(c["valid"]),
                                 c["causal"])
    (o * torch.from_numpy(c["g"])).sum().backward()
    for i, (jg, t) in enumerate(zip(j_grads, qkv)):
        got = _joined(ranks, name, i + 1)
        np.testing.assert_allclose(got, np.asarray(jg), rtol=0, atol=2e-5,
                                   err_msg="qkv"[i])
        np.testing.assert_allclose(got, t.grad.numpy(), rtol=0, atol=2e-5)
    if "padded" in name:  # padded keys get no gradient
        dk = _joined(ranks, name, 2)
        assert not dk[~c["valid"]].any()


def test_ring_multi_head_step_matches_unsharded(world):
    cases, ranks = world
    c = cases["mha"]
    x = torch.from_numpy(c["x"])
    p = {k: torch.from_numpy(c[k]) for k in ("wq", "wk", "wv", "wo")}

    def heads(w):
        return (x @ w).reshape(B, T, H, Dh)

    want = full_attention_reference(heads(p["wq"]), heads(p["wk"]),
                                     heads(p["wv"]), causal=True)
    want = want.reshape(B, T, H * Dh) @ p["wo"]
    np.testing.assert_allclose(_joined(ranks, "mha", 0), want.numpy(),
                               rtol=0, atol=1e-5)


def test_one_rank_ring_is_full_attention():
    c = _case(5, True, True)
    q, k, v = (torch.from_numpy(c[x]) for x in ("q", "k", "v"))
    env = ShardingEnv.single_device("cpu")
    got = ring_attention(q, k, v, env, torch.from_numpy(c["valid"]), True)
    want = full_attention_reference(q, k, v, torch.from_numpy(c["valid"]),
                                    True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
