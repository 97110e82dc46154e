"""Chunked pooled all-to-alls (``parallel/chunked_a2a.py``) across 4 gloo
ranks on the CPU (one spawn) against the JAX ``chunked_a2a`` on a 4-device
mesh of the conftest's virtual CPU devices, as ``tests/test_chunked_a2a.py``
holds them: K column-chunked all-to-alls bit for bit one all-to-all of the
whole payload (and JAX's), and the overlapped first dense layer within
2e-5 of ``a2a(x) @ w`` (the reassociated additions); each chunk's bytes
in the ledger."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torchrec_tpu.parallel.chunked_a2a import chunked_a2a_linear as j_linear
from torchrec_tpu.parallel.chunked_a2a import chunked_pooled_a2a as j_chunked
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu_torch.parallel.multiprocess import launch

import torch_sharding_workers as workers

N, B, D, H = 4, 4, 64, 16
KS = [1, 2, 4, 8]


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    x = rng.randn(N * N, B, D).astype(np.float32)
    w = (rng.randn(D, H) * 0.1).astype(np.float32)
    port = launch(workers.chunked_rank, N,
                  args=([x[r * N:(r + 1) * N] for r in range(N)], w, KS),
                  timeout=120)
    mesh = create_mesh((N,), ("model",), devices=jax.devices()[:N])
    want = {}
    for k in KS:
        f = jax.jit(jax.shard_map(
            lambda xs, k=k: (j_chunked(xs, "model", k),
                             j_linear(xs, jnp.asarray(w), "model", k)),
            mesh=mesh, in_specs=P("model"),
            out_specs=(P("model"), P("model")), check_vma=False))
        c, lin = f(jnp.asarray(x))
        want[k] = (np.asarray(c), np.asarray(lin))
    return port, want


@pytest.mark.parametrize("k", KS)
def test_chunked_a2a_matches_monolithic_and_jax(world, k):
    port, want = world
    for r in range(N):
        chunked, mono, _, _, ledger = port[r][k]
        np.testing.assert_array_equal(chunked, mono)
        np.testing.assert_array_equal(chunked,
                                      want[k][0][r * N * B:(r + 1) * N * B])
        assert ledger["chunked_a2a"] == N * B * D * 4


@pytest.mark.parametrize("k", [2, 8])
def test_chunked_a2a_linear_matches(world, k):
    port, want = world
    for r in range(N):
        _, _, lin, mono_w, ledger = port[r][k]
        np.testing.assert_allclose(lin, mono_w, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(lin, want[k][1][r * N * B:(r + 1) * N * B],
                                   rtol=2e-5, atol=2e-5)
        assert ledger["chunked_a2a_linear"] == N * B * D * 4
