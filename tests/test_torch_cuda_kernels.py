"""The port's CUDA lookup kernels on the card against their plain PyTorch
versions, bit for bit (``torch.equal``), at shapes ``chip_smoke.py``
does not reach: a width that is not a multiple of 4 (the kernels'
one-column-per-lane path), empty batches, empty segments, clipped ids and
dropped segments.

Needs a CUDA device and ``nvcc``; marked ``cuda`` and skipped elsewhere.
It imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's ``conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from torchrec_tpu_torch.ops import tbe

pytestmark = pytest.mark.cuda

R, S, V = 300, 37, 400

# (kernel, bits, D): every packed width at a width divisible by 4, and
# the widths that are not (int8 at 6 and 130, int4 at 6)
CONFIGS = [
    ("tbe", 8, 6), ("tbe", 8, 16), ("tbe", 8, 130),
    ("dedup", 8, 6), ("dedup", 8, 16), ("dedup", 8, 130),
    ("dedup", 4, 6), ("dedup", 4, 16),
    ("dedup", 2, 16), ("dedup", 2, 128),
]
CASES = ("mixed", "no_weights", "empty_batch")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(case, bits, D, seed):
    rng = np.random.RandomState(seed)
    n = 0 if case == "empty_batch" else V
    packed = rng.randint(0, 256, size=(R, D * bits // 8)).astype(np.uint8)
    scale = (rng.rand(R).astype(np.float32) + 0.5) * np.float32(0.01)
    bias = rng.randn(R).astype(np.float32)
    # ids partly outside [0, R) (clipped), segments partly outside [0, S)
    # (dropped); segments 0..4 never appear, so they pool to zero
    ids = rng.randint(-3, R + 3, size=(n,))
    segs = rng.randint(5, S + 4, size=(n,))
    segs[: n // 10] = -1
    w = None if case == "no_weights" else rng.rand(n).astype(np.float32)
    return packed, scale, bias, ids, segs, w


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel,bits,D", CONFIGS)
def test_kernel_equals_plain_on_card(dev, kernel, bits, D, case):
    packed, scale, bias, ids, segs, w = (
        None if x is None else torch.from_numpy(np.asarray(x)).to(dev)
        for x in _inputs(case, bits, D, seed=D + bits)
    )
    if kernel == "tbe":
        wrapper = tbe.quant_pooled_lookup_int8
        plain = tbe.quant_pooled_lookup_int8_plain
        name, kw = "quant_pooled_lookup_int8", {}
    else:
        wrapper = tbe.dedup_quant_pooled_lookup
        plain = tbe.dedup_quant_pooled_lookup_plain
        name, kw = "dedup_quant_pooled_lookup", {"bits": bits}
    before = tbe.launch_counts()[name]
    got = wrapper(packed, scale, bias, ids, segs, S, w, **kw)
    torch.cuda.synchronize()
    assert tbe.launch_counts()[name] == before + 1
    ref = plain(packed, scale, bias, ids, segs, S, w, **kw)
    assert got.shape == (S, D) and got.device.type == "cuda"
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert not got[:5].any()
