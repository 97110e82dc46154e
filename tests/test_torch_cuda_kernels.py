"""The port's CUDA kernels on the card against their plain PyTorch
versions, bit for bit (``torch.equal``), at shapes ``chip_smoke.py``
does not reach: widths that are not a multiple of the vector width (the
kernels' one-column-per-lane paths) and past one 128-column block, empty
batches, empty segments, clipped ids, dropped segments and slots, weight
decay and bfloat16 stochastic rounding.

Needs a CUDA device and ``nvcc``; marked ``cuda`` and skipped elsewhere.
It imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's ``conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from torchrec_tpu_torch.ops import tbe
from torchrec_tpu_torch.ops import tbe_backward

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


# (dtype, D) for the float lookup (B1): vector path at 16 / 128 / 8, the
# one-column path at 6 and 130 (130 % 8 != 0 for bf16, % 4 != 0 for f32)
FLOAT_CONFIGS = [
    (torch.float32, 16), (torch.float32, 6), (torch.float32, 130),
    (torch.bfloat16, 8), (torch.bfloat16, 128), (torch.bfloat16, 6),
    (torch.bfloat16, 130),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,D", FLOAT_CONFIGS)
def test_pooled_lookup_equals_plain_on_card(dev, dtype, D, case):
    rng = np.random.RandomState(D)
    n = 0 if case == "empty_batch" else V
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    ids = torch.from_numpy(rng.randint(-3, R + 3, size=(n,))).to(dev)
    segs = rng.randint(5, S + 4, size=(n,))
    segs[: n // 10] = -1
    segs = torch.from_numpy(segs).to(dev)
    w = (None if case == "no_weights"
         else torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev))
    before = tbe.launch_counts()["pooled_lookup"]
    got = tbe.pooled_lookup(table, ids, segs, S, w)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["pooled_lookup"] == before + 1
    ref = tbe.pooled_lookup_plain(table, ids, segs, S, w)
    assert got.dtype == dtype and got.shape == (S, D)
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())
    assert not got[:5].any()


def test_no_segments_launch_nothing_on_card(dev):
    """A lookup with no output segments launches no kernel and counts
    none: an empty [0, D] output."""
    ids = torch.arange(8, device=dev)
    w = torch.ones(8, device=dev)
    q = torch.zeros((R, 16), dtype=torch.uint8, device=dev)
    scale = torch.ones(R, device=dev)
    before = tbe.launch_counts()
    outs = [
        tbe.pooled_lookup(torch.ones((R, 16), device=dev), ids, ids, 0, w),
        tbe.quant_pooled_lookup_int8(q, scale, scale, ids, ids, 0, w),
        tbe.dedup_quant_pooled_lookup(q, scale, scale, ids, ids, 0, w),
    ]
    assert all(o.shape == (0, 16) and o.device.type == "cuda" for o in outs)
    assert tbe.launch_counts() == before


# (dtype, D, weight decay, stochastic-rounding seed) for the fused update
UPDATE_CONFIGS = [
    (torch.float32, 16, 0.0, None), (torch.float32, 6, 0.01, None),
    (torch.float32, 132, 0.01, None), (torch.float32, 512, 0.0, None),
    (torch.bfloat16, 16, 0.0, 12345), (torch.bfloat16, 132, 0.01, -7),
    (torch.bfloat16, 128, 0.0, None),
]


@pytest.mark.parametrize("case", ("zipf", "empty_batch"))
@pytest.mark.parametrize("dtype,D,wd,seed", UPDATE_CONFIGS)
def test_fused_update_equals_plain_on_card(dev, dtype, D, wd, seed, case):
    rng = np.random.RandomState(D + 1)
    n = 0 if case == "empty_batch" else V
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    mom = torch.from_numpy(rng.rand(R).astype(np.float32)).to(dev)
    ids = np.minimum(rng.zipf(1.2, n) - 1, R + 3)
    args = [torch.from_numpy(x).to(dev) for x in (
        ids, rng.rand(n) > 0.1, rng.randint(-2, S + 2, n),
        rng.rand(n).astype(np.float32))]
    grad = torch.from_numpy(rng.randn(S, D).astype(np.float32)).to(dev)
    tk, mk = table.clone(), mom.clone()
    tp, mp = table.clone(), mom.clone()
    before = tbe.launch_counts()["fused_sparse_update"]
    tbe_backward.fused_sparse_update(tk, mk, *args, grad, 0.05,
                                     weight_decay=wd, sr_seed=seed)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["fused_sparse_update"] == before + (n > 0)
    tbe_backward.fused_sparse_update_plain(tp, mp, *args, grad, 0.05,
                                           weight_decay=wd, sr_seed=seed)
    assert torch.equal(tk, tp), float((tk.float() - tp.float()).abs().max())
    assert torch.equal(mk, mp)
    assert (n == 0) == torch.equal(tk, table)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,D", FLOAT_CONFIGS)
def test_dedup_pooled_lookup_equals_plain_on_card(dev, dtype, D, case):
    """B4 against its plain version, and against B1 (the same function;
    bitwise for float32 and bfloat16 tables alike)."""
    rng = np.random.RandomState(D + 7)
    n = 0 if case == "empty_batch" else V
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    # a few hot rows: duplicates within and across segments
    ids = np.where(rng.rand(n) < 0.5, rng.randint(0, 8, size=(n,)),
                   rng.randint(-3, R + 3, size=(n,)))
    ids = torch.from_numpy(ids).to(dev)
    segs = rng.randint(5, S + 4, size=(n,))
    segs[: n // 10] = -1
    segs = torch.from_numpy(segs).to(dev)
    w = (None if case == "no_weights"
         else torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev))
    before = tbe.launch_counts()["dedup_pooled_lookup"]
    got = tbe.dedup_pooled_lookup(table, ids, segs, S, w)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["dedup_pooled_lookup"] == before + 1
    ref = tbe.dedup_pooled_lookup_plain(table, ids, segs, S, w)
    assert got.dtype == dtype and got.shape == (S, D)
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())
    assert torch.equal(got, tbe.pooled_lookup(table, ids, segs, S, w))
    assert not got[:5].any()


def test_dedup_lookup_no_segments_launch_nothing_on_card(dev):
    ids = torch.arange(8, device=dev)
    before = tbe.launch_counts()
    out = tbe.dedup_pooled_lookup(torch.ones((R, 16), device=dev), ids, ids,
                                  0, torch.ones(8, device=dev))
    assert out.shape == (0, 16) and out.device.type == "cuda"
    assert tbe.launch_counts() == before


# (dtype, D, weight decay, stochastic-rounding seed) for the dedup fused
# update (B6): every optimizer on float32 at the vector layout, the
# one-column layout and past one 128-column block; bfloat16 with
# stochastic rounding for rowwise Adagrad and Adam
DEDUP_UPDATE_CONFIGS = [
    (optim, torch.float32, D, wd, None)
    for optim in tbe_backward.OPTIMIZERS
    for D, wd in ((16, 0.01), (6, 0.0), (132, 0.01))
] + [
    ("rowwise_adagrad", torch.bfloat16, 128, 0.0, 12345),
    ("adam", torch.bfloat16, 16, 0.01, -7),
]


@pytest.mark.parametrize("case", ("zipf", "empty_batch"))
@pytest.mark.parametrize("optim,dtype,D,wd,seed", DEDUP_UPDATE_CONFIGS)
def test_dedup_fused_update_equals_plain_on_card(dev, optim, dtype, D, wd,
                                                 seed, case):
    rng = np.random.RandomState(D + 3)
    n = 0 if case == "empty_batch" else V
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    states = [torch.from_numpy(
        rng.rand(*((R,) if kind == "row" else (R, D))).astype(np.float32)
    ).to(dev) for kind in tbe_backward.STATE_LAYOUTS[optim]]
    ids = np.minimum(rng.zipf(1.2, n) - 1, R + 3)
    args = [torch.from_numpy(x).to(dev) for x in (
        ids, rng.rand(n) > 0.1, rng.randint(-2, S + 2, n),
        rng.rand(n).astype(np.float32))]
    grad = torch.from_numpy(rng.randn(S, D).astype(np.float32)).to(dev)
    kw = dict(weight_decay=wd, sr_seed=seed, bias_corrections=(0.271, 0.004))
    tk, sk = table.clone(), [s.clone() for s in states]
    tp, sp = table.clone(), [s.clone() for s in states]
    before = tbe.launch_counts()["dedup_fused_sparse_update"]
    tbe_backward.dedup_fused_sparse_update(tk, sk, *args, grad, optim, 0.05,
                                           **kw)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["dedup_fused_sparse_update"] == before + (
        n > 0)
    tbe_backward.dedup_fused_sparse_update_plain(tp, sp, *args, grad, optim,
                                                 0.05, **kw)
    assert torch.equal(tk, tp), float((tk.float() - tp.float()).abs().max())
    for a, b in zip(sk, sp):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert (n == 0) == torch.equal(tk, table)


# (optim, dtype, D, weight decay, stochastic-rounding seed) for the per-id
# fused update (B2) beyond rowwise Adagrad: each of the seven other
# optimizers on float32 at the vector layout, the one-column layout and
# past one 128-column block, and on bfloat16 with stochastic rounding
PER_ID_UPDATE_CONFIGS = [
    (optim, torch.float32, D, wd, None)
    for optim in tbe_backward.OPTIMIZERS if optim != "rowwise_adagrad"
    for D, wd in ((16, 0.01), (6, 0.0), (132, 0.01))
] + [
    (optim, torch.bfloat16, 128, 0.01, 12345)
    for optim in tbe_backward.OPTIMIZERS if optim != "rowwise_adagrad"
]
_ADAM = ("adam", "lamb", "partial_rowwise_adam", "partial_rowwise_lamb")


@pytest.mark.parametrize("case", ("zipf", "empty_batch"))
@pytest.mark.parametrize("optim,dtype,D,wd,seed", PER_ID_UPDATE_CONFIGS)
def test_fused_update_optimizers_equal_plain_on_card(dev, optim, dtype, D,
                                                     wd, seed, case):
    rng = np.random.RandomState(D + 5)
    n = 0 if case == "empty_batch" else V
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    states = [torch.from_numpy(
        rng.rand(*((R,) if kind == "row" else (R, D))).astype(np.float32)
    ).to(dev) for kind in tbe_backward.STATE_LAYOUTS[optim]]
    ids = np.minimum(rng.zipf(1.2, n) - 1, R + 3)
    args = [torch.from_numpy(x).to(dev) for x in (
        ids, rng.rand(n) > 0.1, rng.randint(-2, S + 2, n),
        rng.rand(n).astype(np.float32))]
    grad = torch.from_numpy(rng.randn(S, D).astype(np.float32)).to(dev)
    adam = optim in _ADAM

    def run(fn, t, sts):
        fn(t, None if adam or not sts else sts[0], *args, grad, 0.05,
           weight_decay=wd, sr_seed=seed, optim=optim,
           states=sts if adam else None, bias_corrections=(0.271, 0.004))

    tk, sk = table.clone(), [s.clone() for s in states]
    tp, sp = table.clone(), [s.clone() for s in states]
    before = tbe.launch_counts()["fused_sparse_update"]
    run(tbe_backward.fused_sparse_update, tk, sk)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["fused_sparse_update"] == before + (n > 0)
    run(tbe_backward.fused_sparse_update_plain, tp, sp)
    assert torch.equal(tk, tp), float((tk.float() - tp.float()).abs().max())
    for a, b in zip(sk, sp):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert (n == 0) == torch.equal(tk, table)
    assert tbe_backward.fused_update_registers(optim, dtype, D) > 0
