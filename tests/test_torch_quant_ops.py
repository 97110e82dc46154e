"""Port parity: row-wise int8/int4/int2 quantization and unpacking are
bit-equal between ``torchrec_tpu_torch`` and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import quant_ops as jq
from torchrec_tpu_torch.ops import quant_ops as tq

QUANTIZERS = {
    8: (jq.quantize_rowwise_int8, tq.quantize_rowwise_int8),
    4: (jq.quantize_rowwise_int4, tq.quantize_rowwise_int4),
    2: (jq.quantize_rowwise_int2, tq.quantize_rowwise_int2),
}


def _weights(seed, R, D):
    rng = np.random.RandomState(seed)
    w = rng.randn(R, D).astype(np.float32)
    w[0] = 0.25  # a constant row: the 1e-8 scale floor
    w[1, : D // 2] = 1.5  # ties at the row's extremes
    w[2] *= 1e-3
    return w


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("seed,R,D", [(0, 64, 8), (1, 200, 16), (2, 7, 16)])
def test_quantize_rowwise_bit_equal(bits, seed, R, D):
    w = _weights(seed, R, D)
    jfn, tfn = QUANTIZERS[bits]
    jout = [np.asarray(x) for x in jfn(jnp.asarray(w))]
    tout = [x.numpy() for x in tfn(torch.from_numpy(w))]
    for name, a, b in zip(("codes", "scale", "bias"), jout, tout):
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_round_half_to_even():
    # (w - lo) / scale lands exactly on k + 0.5 for these rows: both
    # packages must round to the even code
    w = np.array([[0.0, 0.5 / 255 * 2, 1.5 / 255 * 2, 2.0]], np.float32)
    jq_, _, _ = jq.quantize_rowwise_int8(jnp.asarray(w))
    tq_, _, _ = tq.quantize_rowwise_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jq_), tq_.numpy())


@pytest.mark.parametrize(
    "bits,junpack,tunpack",
    [(4, jq.unpack_int4, tq.unpack_int4), (2, jq.unpack_int2, tq.unpack_int2)],
)
def test_unpack_order_equal(bits, junpack, tunpack):
    rng = np.random.RandomState(3)
    packed = rng.randint(0, 256, size=(32, 16 * bits // 8)).astype(np.uint8)
    a = np.asarray(junpack(jnp.asarray(packed)))
    b = tunpack(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(a, b)
    # and unpacking inverts the port's packing
    w = _weights(4, 32, 16)
    q8, _, _ = tq._quantize_rowwise(torch.from_numpy(w), (1 << bits) - 1)
    packed_t, _, _ = QUANTIZERS[bits][1](torch.from_numpy(w))
    np.testing.assert_array_equal(tunpack(packed_t).numpy(), q8.numpy())


def test_odd_dims_raise():
    with pytest.raises(ValueError):
        tq.quantize_rowwise_int4(torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        tq.quantize_rowwise_int2(torch.zeros((2, 6)))
