"""The port's CUDA kernels on the card against their plain PyTorch
versions, bit for bit (``torch.equal``), at shapes ``chip_smoke.py``
does not reach: widths that are not a multiple of the vector width (the
kernels' one-column-per-lane paths) and past one 128-column block, empty
batches, empty segments, clipped ids, dropped segments and slots, weight
decay and bfloat16 stochastic rounding; the fused updates' grid and run
walk on slot streams built to hit its edges (runs of 1 to 3,000 slots,
one valid slot, only sentinels, valid slots ending on a window boundary,
two launches in a row) at every column layout; the ragged dedup lookup
(B4) on segments of 1 to 1,000 slots around its walk's depth and fetch,
its wrapper under ``torch.cuda.set_sync_debug_mode("error")``, one
native launch a call and no allocation beyond the output and the prep;
the float lookup (B1) over slot regions (int32 and int64 ids and
lengths, no weights, caps the lengths overflow, segments of 0 to 1,000
slots, more regions than one launch holds) against both plain versions,
one launch a call, no host sync and nothing allocated but its output and
the lengths' running ends; B2 at a warmup schedule's learning rate;
and the grouped quantized
lookups of a served batch (every feature in one launch, tables whose rows
start off a 4-byte boundary, MEAN features, a key no feature reads), with
the collection's forward run under
``torch.cuda.set_sync_debug_mode("error")``; and B6 with Adam over the
BERT4Rec step's per-id slots and weighted B1 at the position-weighted
EBC's shapes; and B1 and B4 over float16 tables and from 16-bit tables
into float32 (the FP16/BF16 serving tables), alone and as the serving
collection's grouped float lookup, one launch a feature into each
feature's columns, with no host sync; and the ``trt::`` operators
(``csrc/torch_ops.cpp``) the grouped wrappers launch through, each
against the C entry point it wraps and its plain version at the served
batch's shapes, with the operator library's launch counts, and a
serving module exported on the card holding them; and B2 and B6 over
bfloat16 and float16 optimizer states (every stateful optimizer, every
column layout, float32 and bfloat16 tables, stochastic rounding on and
off), with their instantiations' registers; and the tiered cache's IO
(``tiered/``): ``apply_io`` fed by the prefetcher's side-stream copies
from pinned buffers equal, bit for bit, to the synchronous path over a
small table far larger than its cache, every eviction written back and
fetched again.

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
from torchrec_tpu_torch.ops.embedding_ops import mean_pooling_weights
from torchrec_tpu_torch.parallel.sharding.common import per_slot_segments

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


# ---------------------------------------------------------------------------
# B1 over a stream in its producer's layout (ops/tbe.py::
# pooled_lookup_regions): no sort, one launch
# ---------------------------------------------------------------------------


def _regions(dev, counts, caps, lengths, ids_dtype=torch.int64,
             weighted=True, gap=3, seed=0, lengths_dtype=torch.int32):
    """A slot stream of regions with ``gap`` unread slots before each,
    regions of ``counts[k]`` examples of ``lengths`` and ``caps[k]`` slots
    (lengths past a cap overflow it), ids partly outside the table;
    returns (ids, weights or None, SlotRegions) on ``dev``."""
    rng = np.random.RandomState(seed)
    starts, pos = [], 0
    for cap in caps:
        starts.append(pos + gap)
        pos += gap + cap
    ids = rng.randint(-3, R + 3, size=(pos,)).astype(np.int64)
    w = rng.rand(pos).astype(np.float32) if weighted else None
    regions = tbe.SlotRegions(
        torch.as_tensor(np.asarray(lengths), dtype=lengths_dtype,
                        device=dev),
        tuple(starts), tuple(caps), tuple(counts))
    return (torch.from_numpy(ids).to(dev, ids_dtype),
            None if w is None else torch.from_numpy(w).to(dev), regions)


def _check_regions(table, ids, w, regions, launches=1):
    """The region entry on the card: ``launches`` counted launches,
    ``torch.equal`` to its plain version and to the sorted plain version
    over the same slots."""
    before = tbe.launch_counts()["pooled_lookup"]
    got = tbe.pooled_lookup_regions(table, ids, regions, w)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["pooled_lookup"] == before + launches
    S = regions.num_segments
    assert got.shape == (S, table.shape[1]) and got.dtype == table.dtype
    plain = tbe.pooled_lookup_regions_plain(table, ids, regions, w)
    assert torch.equal(got, plain), float(
        (got.float() - plain.float()).abs().max())
    segs = regions.segment_ids(ids.shape[0])
    assert torch.equal(got, tbe.pooled_lookup_plain(table, ids, segs, S, w))
    return got


@pytest.mark.parametrize("weighted", (True, False))
@pytest.mark.parametrize("ids_dtype", (torch.int32, torch.int64))
@pytest.mark.parametrize("dtype,D", FLOAT_CONFIGS)
def test_pooled_lookup_regions_equals_plain_on_card(dev, dtype, D,
                                                    ids_dtype, weighted):
    """Five regions: one-slot examples (a run of 32 a warp), multi-hot
    ones, a region whose lengths overflow its cap, an empty region, a
    region with no examples; ids int32 or int64, weights or none."""
    rng = np.random.RandomState(D)
    counts = (100, 37, 20, 9, 0)
    lengths = np.concatenate([
        rng.randint(0, 2, size=100), rng.randint(0, 12, size=37),
        rng.randint(3, 9, size=20), np.zeros(9, np.int64)])
    caps = (100, 37 * 12, 60, 4, 5)  # the third's lengths overflow it
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    ids, w, regions = _regions(dev, counts, caps, lengths, ids_dtype,
                               weighted, seed=D)
    got = _check_regions(table, ids, w, regions)
    assert not got[-9:].any()


@pytest.mark.parametrize("length", (0, 1, 31, 32, 33, 1000))
@pytest.mark.parametrize("dtype,D", ((torch.float32, 128),
                                     (torch.bfloat16, 130)))
def test_pooled_lookup_regions_segment_lengths_on_card(dev, dtype, D,
                                                      length):
    """Example 40 of a region of 64 holds ``length`` slots among short
    ones (each warp's run of segments, and a run of one segment when the
    region's cap makes long segments)."""
    rng = np.random.RandomState(length)
    lengths = rng.randint(0, 3, size=64)
    lengths[40] = length
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    for cap in (int(lengths.sum()), 64 * max(length, 1)):
        ids, w, regions = _regions(dev, (64,), (cap,), lengths, seed=cap)
        got = _check_regions(table, ids, w, regions)
        assert bool(got[40].any()) == (length > 0)


def test_pooled_lookup_regions_many_regions_and_int64_on_card(dev):
    """300 regions (a launch takes 128: regions 0-127 and 256-299 are
    two launches, regions 128-255 hold no example and launch nothing),
    int64 lengths, and int64 ids at and past 2**31 clipped to the last
    row."""
    rng = np.random.RandomState(3)
    counts = rng.randint(0, 9, size=300)
    counts[128:256] = 0
    counts[[0, 256]] = 5
    counts = tuple(int(c) for c in counts)
    lengths = rng.randint(0, 4, size=sum(counts))
    caps = tuple(3 * c for c in counts)
    table = torch.from_numpy(rng.randn(R, 16).astype(np.float32)).to(dev)
    ids, w, regions = _regions(dev, counts, caps, lengths, seed=3,
                               lengths_dtype=torch.int64)
    ids[::7] = 2**31 + torch.arange(ids[::7].numel(), device=dev)
    ids[1] = 2**40
    _check_regions(table, ids, w, regions, launches=2)


def test_pooled_lookup_regions_one_launch_no_sync_on_card(dev):
    """One call is one counted launch, makes no host sync
    (``set_sync_debug_mode("error")``), and allocates no more than its
    output and the lengths' running ends."""
    rng = np.random.RandomState(5)
    counts, caps = (4096,) * 26, (4096,) * 26
    lengths = rng.randint(0, 2, size=26 * 4096)
    table = torch.from_numpy(rng.randn(20_000, 128).astype(np.float32)).to(
        dev)
    ids, w, regions = _regions(dev, counts, caps, lengths, torch.int32,
                               gap=0, seed=5)
    args = (table, ids, regions, w)
    want = tbe.pooled_lookup_regions(*args)  # builds and loads the library
    torch.cuda.synchronize()
    before = tbe.launch_counts()["pooled_lookup"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbe.pooled_lookup_regions(*args)
        unweighted = tbe.pooled_lookup_regions(*args[:3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tbe.launch_counts()["pooled_lookup"] == before + 2
    assert torch.equal(got, want)
    assert torch.equal(unweighted,
                       tbe.pooled_lookup_regions_plain(*args[:3]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = tbe.pooled_lookup_regions(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ends_bytes = regions.lengths.numel() * regions.lengths.element_size()
    assert peak <= out.numel() * out.element_size() + ends_bytes + 1024


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


def test_id_overflow_count_makes_no_host_sync_on_card(dev):
    """The train step's ``id_overflow``: the KJT's overflow counts and
    their sum over ranks (one rank here) under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from torchrec_tpu_torch.parallel.comm import ShardingEnv, all_reduce_sum
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    lengths = torch.tensor([3, 3, 3, 2, 1, 0, 2, 1], dtype=torch.int32,
                           device=dev)
    kjt = KeyedJaggedTensor(["c0", "c1"], torch.arange(16, device=dev),
                            lengths, stride=4, caps=[8, 8])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = all_reduce_sum(kjt.overflow_counts(),
                             ShardingEnv.single_device(dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.tolist() == [3, 0]


@pytest.mark.parametrize("step", (0, 3, 25))
def test_fused_update_at_scheduled_lr_equals_plain_on_card(dev, step):
    """B2 through ``apply_sparse_update_segments`` at a warmup schedule's
    learning rate (the DMP's ``sparse_lr``: a float32 value on the host,
    passed by value): the kernel equals its plain version at that lr, and
    at the ramp's steps it moves the rows less than the base lr does."""
    from torchrec_tpu_torch.ops.fused_update import (
        FusedOptimConfig,
        SparseSegGrad,
        apply_sparse_update_segments,
    )
    from torchrec_tpu_torch.optim.warmup import (
        WarmupPolicy,
        WarmupStage,
        warmup_schedule,
    )

    sched = warmup_schedule([WarmupStage(WarmupPolicy.LINEAR, 20)])
    cfg = FusedOptimConfig(learning_rate=0.05)
    lr = float(np.float32(sched(step)) * np.float32(cfg.learning_rate))
    rng = np.random.RandomState(step)
    table = torch.from_numpy(rng.randn(R, 128).astype(np.float32)).to(dev)
    ids = np.minimum(rng.zipf(1.2, V) - 1, R - 1)
    sg = SparseSegGrad(*[torch.from_numpy(x).to(dev) for x in (
        ids, rng.rand(V) > 0.1, rng.randint(0, S, V),
        rng.rand(V).astype(np.float32),
        rng.randn(S, 128).astype(np.float32))])
    runs = {}
    for arm, lr_arm in (("kernel", lr), ("base", None)):
        t, st = table.clone(), {"momentum": torch.zeros(R, device=dev)}
        before = tbe.launch_counts()["fused_sparse_update"]
        apply_sparse_update_segments(t, st, sg, cfg, learning_rate=lr_arm)
        torch.cuda.synchronize()
        assert tbe.launch_counts()["fused_sparse_update"] == before + 1
        runs[arm] = t
    plain = table.clone()
    tbe_backward.fused_sparse_update_plain(
        plain, torch.zeros(R, device=dev), sg.ids, sg.valid, sg.segments,
        sg.weights, sg.grad_seg, lr)
    assert torch.equal(runs["kernel"], plain)
    moved = (runs["kernel"] - table).abs().sum()
    base_moved = (runs["base"] - table).abs().sum()
    assert (moved < base_moved) if step < 20 else torch.equal(
        runs["kernel"], runs["base"])


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


# segment lengths around the B4 walk's depth (4 row loads in flight) and
# its 32-slot metadata fetch
SEGMENT_LENGTHS = (1, 3, 4, 5, 7, 8, 9, 31, 32, 33, 64, 65, 1000)


def _segment_inputs(dev, dtype, D, length, seed):
    """Segment 7 holds ``length`` slots (half on 4 hot rows, some ids out
    of range), shuffled among 40 slots of other and invalid segments."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    others = [s for s in range(-2, S + 2) if s != 7]
    segs = np.concatenate([np.full(length, 7), rng.choice(others, size=40)])
    segs = segs[rng.permutation(segs.size)]
    n = segs.size
    ids = np.where(rng.rand(n) < 0.5, rng.randint(0, 4, size=(n,)),
                   rng.randint(-3, R + 3, size=(n,)))
    w = rng.rand(n).astype(np.float32)
    return table, *(torch.from_numpy(x).to(dev) for x in (ids, segs, w))


@pytest.mark.parametrize("length", SEGMENT_LENGTHS)
@pytest.mark.parametrize("dtype,D", FLOAT_CONFIGS)
def test_dedup_lookup_segment_lengths_on_card(dev, dtype, D, length):
    """B4 on a segment of ``length`` slots: equal to its plain version
    and to B1, and the segment's row equal to its slots' weighted sum."""
    table, ids, segs, w = _segment_inputs(dev, dtype, D, length,
                                          seed=length + D)
    got = tbe.dedup_pooled_lookup(table, ids, segs, S, w)
    torch.cuda.synchronize()
    ref = tbe.dedup_pooled_lookup_plain(table, ids, segs, S, w)
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())
    assert torch.equal(got, tbe.pooled_lookup(table, ids, segs, S, w))
    assert int((segs == 7).sum()) == length and got[7].any()


def _wrapper_inputs(dev, dtype, D):
    """20,000 rows and 4,000 slots, half on 8 hot rows, a few invalid:
    enough distinct rows that a copy of them would outweigh the prep."""
    rng = np.random.RandomState(D)
    rows, n = 20_000, 4_000
    table = torch.from_numpy(rng.randn(rows, D).astype(np.float32)).to(
        dev, dtype)
    ids = np.where(rng.rand(n) < 0.5, rng.randint(0, 8, size=(n,)),
                   rng.randint(0, rows, size=(n,)))
    segs = rng.randint(-1, S, size=(n,))
    w = rng.rand(n).astype(np.float32)
    return table, *(torch.from_numpy(x).to(dev) for x in (ids, segs, w))


@pytest.mark.parametrize("dtype,D", ((torch.float32, 128),
                                     (torch.bfloat16, 130)))
def test_dedup_lookup_makes_no_host_sync_on_card(dev, dtype, D):
    """B4's wrapper (the sized prep and the launch) under
    ``torch.cuda.set_sync_debug_mode("error")``: no synchronisation."""
    table, ids, segs, w = _wrapper_inputs(dev, dtype, D)
    args = (table, ids, segs, S)
    want = tbe.dedup_pooled_lookup(*args, w)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbe.dedup_pooled_lookup(*args, w)
        unweighted = tbe.dedup_pooled_lookup(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert torch.equal(unweighted, tbe.dedup_pooled_lookup_plain(*args))


def test_dedup_lookup_one_launch_no_scratch_on_card(dev):
    """One B4 call is one native kernel launch (counted by the profiler
    and by the launch count), and allocates nothing beyond its output and
    what the sized prep alone allocates: no [U, D] copy of the rows."""
    from torch.profiler import ProfilerActivity, profile

    table, ids, segs, w = _wrapper_inputs(dev, torch.float32, 128)
    args = (table, ids, segs, S, w)
    tbe.dedup_pooled_lookup(*args)  # builds and loads the library
    torch.cuda.synchronize()
    before = tbe.launch_counts()["dedup_pooled_lookup"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tbe.dedup_pooled_lookup(*args)
        torch.cuda.synchronize()
    ours = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "dedup_pooled_kernel" in e.name]
    assert len(ours) == 3
    assert tbe.launch_counts()["dedup_pooled_lookup"] == before + 3

    def memory(fn):
        """(peak, held) above the start, from an emptied cache."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        del kept
        return torch.cuda.max_memory_allocated() - base, held

    prep, _ = memory(lambda: tbe.dedup_prepare_sized(ids, segs, w, S))
    peak, out_bytes = memory(lambda: tbe.dedup_pooled_lookup(*args))
    assert out_bytes >= S * 128 * 4
    distinct = int(torch.unique(ids[segs >= 0]).numel())
    assert distinct * 128 * 4 > prep  # a row copy would show
    assert peak <= prep + out_bytes


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


# ---------------------------------------------------------------------------
# the fused updates' grid and walk (B2 and B6, backward_common.cuh): slot
# streams built to hit the edges of the 32-position windows and of a run's
# 32-slot chunks, at every column layout
# ---------------------------------------------------------------------------

# run lengths of the valid slots (each on its own row), then invalid slots
# (the sentinel); the 3,000-slot run crosses some 94 windows
RUN_STREAMS = {
    "runs": ([1, 31, 32, 33, 64, 3000, 1], 100),
    "one_valid": ([1], 63),
    "all_sentinels": ([], 64),
    "ends_on_window": ([1, 31, 32], 32),
}
RUN_DIMS = (4, 100, 128, 256, 512)  # narrow, narrow, narrow, wide, wide
UPDATES = ("fused_sparse_update", "dedup_fused_sparse_update")


def _run_stream(dev, case, D, seed):
    """(ids, valid, segments, weights) on the card, shuffled, and a random
    ``[S, D]`` upstream gradient."""
    lengths, pad = RUN_STREAMS[case]
    rng = np.random.RandomState(seed)
    rows = rng.permutation(R)[: len(lengths)]
    ids = np.concatenate([np.repeat(rows, lengths), rng.randint(0, R, pad)])
    n = len(ids)
    perm = rng.permutation(n)
    arrays = (ids[perm], (np.arange(n) < sum(lengths))[perm],
              rng.randint(0, S, n), rng.rand(n).astype(np.float32))
    grad = rng.randn(S, D).astype(np.float32)
    return ([torch.from_numpy(x).to(dev) for x in arrays],
            torch.from_numpy(grad).to(dev))


def _update(kernel, plain, optim, table, states, args, grad, seed):
    """B2 or B6 (or its plain version) with ``optim``, in place."""
    kw = dict(weight_decay=0.01, sr_seed=seed,
              bias_corrections=(0.271, 0.004))
    if kernel == "dedup_fused_sparse_update":
        fn = (tbe_backward.dedup_fused_sparse_update_plain if plain
              else tbe_backward.dedup_fused_sparse_update)
        fn(table, states, *args, grad, optim, 0.05, **kw)
        return
    fn = (tbe_backward.fused_sparse_update_plain if plain
          else tbe_backward.fused_sparse_update)
    adam = len(states) == 2
    fn(table, None if adam or not states else states[0], *args, grad, 0.05,
       optim=optim, states=states if adam else None, **kw)


def _check_stream(dev, kernel, optim, dtype, D, case, seed, calls=1):
    """``calls`` kernel launches in a row on one stream against as many
    plain-version calls: ``torch.equal`` on the table and every state."""
    rng = np.random.RandomState(D + len(case))
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    states = [torch.from_numpy(
        rng.rand(*((R,) if kind == "row" else (R, D))).astype(np.float32)
    ).to(dev) for kind in tbe_backward.STATE_LAYOUTS[optim]]
    args, grad = _run_stream(dev, case, D, seed=D + 1)
    tk, sk = table.clone(), [s.clone() for s in states]
    tp, sp = table.clone(), [s.clone() for s in states]
    before = tbe.launch_counts()[kernel]
    for _ in range(calls):
        _update(kernel, False, optim, tk, sk, args, grad, seed)
    torch.cuda.synchronize()
    assert tbe.launch_counts()[kernel] == before + calls
    for _ in range(calls):
        _update(kernel, True, optim, tp, sp, args, grad, seed)
    assert torch.equal(tk, tp), float((tk.float() - tp.float()).abs().max())
    for a, b in zip(sk, sp):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert torch.equal(tk, table) == (case == "all_sentinels")


@pytest.mark.parametrize("case", sorted(RUN_STREAMS))
@pytest.mark.parametrize("D", RUN_DIMS)
@pytest.mark.parametrize("optim", tbe_backward.OPTIMIZERS)
@pytest.mark.parametrize("kernel", UPDATES)
def test_update_run_streams_equal_plain_on_card(dev, kernel, optim, D, case):
    _check_stream(dev, kernel, optim, torch.float32, D, case, None)


@pytest.mark.parametrize("optim", tbe_backward.OPTIMIZERS)
@pytest.mark.parametrize("kernel", UPDATES)
def test_update_run_streams_bf16_stochastic_on_card(dev, kernel, optim):
    _check_stream(dev, kernel, optim, torch.bfloat16, 128, "runs", 12345)


@pytest.mark.parametrize("kernel,optim", [
    ("fused_sparse_update", "adagrad"),
    ("dedup_fused_sparse_update", "rowwise_adagrad"),
])
def test_update_two_launches_reset_the_queue_on_card(dev, kernel, optim):
    """The second launch on a stream finds the work queue the first left
    at 0: both updates equal the plain version's two calls, and the
    queues read 0 afterwards."""
    _check_stream(dev, kernel, optim, torch.float32, 128, "runs", None,
                  calls=2)
    for q in tbe_backward._QUEUES.values():
        assert q.tolist() == [0, 0]


@pytest.mark.parametrize("D", RUN_DIMS + (6, 130))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("kernel", UPDATES)
def test_update_instantiation_by_width_on_card(dev, kernel, dtype, D):
    """The launch takes the layout ``column_layout`` names; a narrow
    instantiation fits two 256-thread blocks an SM (<= 128 registers);
    the grid is the resident blocks, no more warps than windows."""
    layout, _ = tbe_backward.column_layout(D)
    for optim in tbe_backward.OPTIMIZERS:
        info = tbe_backward.update_launch(kernel, optim, dtype, D, 10**6)
        assert info["layout"] == layout
        if layout == "narrow":
            assert info["registers"] <= 128 and info["blocks_per_sm"] >= 2
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert info["blocks"] == info["blocks_per_sm"] * sms
        small = tbe_backward.update_launch(kernel, optim, dtype, D, 33 * 8)
        assert small["blocks"] == 2  # 9 windows: 9 warps in 2 blocks
    regs = (tbe_backward.fused_update_registers if kernel == UPDATES[0]
            else tbe_backward.dedup_fused_update_registers)
    assert regs(optim, dtype, D) == info["registers"]


# ---------------------------------------------------------------------------
# the grouped lookups (one launch for every feature of a served batch)
# ---------------------------------------------------------------------------

GB = 24  # examples
# per feature: (table, max ids per example, MEAN); f3 shares t0's table
GROUP_FEATURES = [(0, 3, False), (1, 9, True), (2, 40, False), (0, 5, True)]
GROUP_ROWS = [300, 50, 1000]
# (kernel, bits, D): the vector paths, the one-column paths (D = 6, 130),
# and tables whose rows start off a 4-byte boundary (the byte paths)
GROUP_CONFIGS = [
    ("tbe", 8, 16, False), ("tbe", 8, 130, False), ("tbe", 8, 6, False),
    ("tbe", 8, 128, True), ("dedup", 8, 128, False), ("dedup", 8, 6, False),
    ("dedup", 4, 16, False), ("dedup", 4, 6, False), ("dedup", 2, 128, False),
    ("dedup", 2, 16, True),
]


def _group_inputs(dev, kernel, bits, D, misaligned, case, seed):
    """A KJT-shaped batch (key 1 read by no feature, empty examples, ids
    partly out of range, junk in the padding, one key with no padding) and
    the group's GroupFeatures; "no_valid_ids": every length 0."""
    rng = np.random.RandomState(seed)
    K = len(GROUP_FEATURES) + 1
    key_of = [0, 2, 3, 4]  # the feature -> key map; key 1 is unused
    lengths = np.zeros((K, GB), np.int32)
    if case != "no_valid_ids":
        for f, (_, most, _) in enumerate(GROUP_FEATURES):
            lengths[key_of[f]] = rng.randint(0, most + 1, size=GB)
        lengths[1] = rng.randint(0, 3, size=GB)
        lengths[:, 5] = 0
    caps = [int(n) + (0 if k == 3 else 7)
            for k, n in enumerate(lengths.sum(1))]
    values = np.concatenate([
        np.concatenate([rng.randint(-3, 1010, size=int(lengths[k].sum())),
                        rng.randint(-10**9, 10**9, size=c - lengths[k].sum())])
        for k, c in enumerate(caps)]).astype(np.int64)
    Dp = D * bits // 8
    tables = []
    for r in GROUP_ROWS:
        buf = torch.from_numpy(rng.randint(
            0, 256, size=(r * Dp + 1,)).astype(np.uint8)).to(dev)
        q = (buf[1:] if misaligned else buf[:-1]).view(r, Dp)
        tables.append((q, torch.from_numpy(
            (rng.rand(r) * 0.01 + 0.005).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randn(r).astype(np.float32)).to(dev)))
    feats = [tbe.GroupFeature(*tables[t], key_of[f], 3 + f * D, mean)
             for f, (t, _, mean) in enumerate(GROUP_FEATURES)]
    offs = tuple(int(x) for x in np.concatenate([[0], np.cumsum(caps)]))
    return (torch.from_numpy(values).to(dev),
            torch.from_numpy(lengths.reshape(-1)).to(dev), offs, feats)


@pytest.mark.parametrize("case", ("mixed", "no_valid_ids"))
@pytest.mark.parametrize("kernel,bits,D,misaligned", GROUP_CONFIGS)
def test_grouped_lookup_equals_plain_on_card(dev, kernel, bits, D,
                                             misaligned, case):
    """One grouped launch against the grouped plain version (and that
    against each feature's per-table kernel): every output column of
    every example, the padding columns untouched."""
    values, lengths, offs, feats = _group_inputs(
        dev, kernel, bits, D, misaligned, case, seed=D + bits)
    width = 3 + len(feats) * D + 2
    if kernel == "tbe":
        wrapper = tbe.quant_pooled_lookup_int8_grouped
        plain = tbe.quant_pooled_lookup_int8_grouped_plain
        name, kw = "quant_pooled_lookup_int8", {}
    else:
        wrapper = tbe.dedup_quant_pooled_lookup_grouped
        plain = tbe.dedup_quant_pooled_lookup_grouped_plain
        name, kw = "dedup_quant_pooled_lookup", {"bits": bits}
    got = torch.full((GB, width), 7.0, device=dev)
    before = tbe.launch_counts()[name]
    wrapper(values, lengths, offs, feats, got, **kw)
    torch.cuda.synchronize()
    assert tbe.launch_counts()[name] == before + 1
    ref = plain(values, lengths, offs, feats,
                torch.full((GB, width), 7.0, device=dev), **kw)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert bool((got[:, :3] == 7).all() and (got[:, -2:] == 7).all())
    assert not got[5, 3:-2].any()
    # each feature alone through the per-table kernel
    for f in feats:
        lo, hi = offs[f.key], offs[f.key + 1]
        f_len = lengths[f.key * GB:(f.key + 1) * GB]
        seg = per_slot_segments(f_len, hi - lo)
        w = mean_pooling_weights(seg, f_len) if f.mean else None
        if kernel == "tbe":
            one = tbe.quant_pooled_lookup_int8(f.q, f.scale, f.bias,
                                               values[lo:hi], seg, GB, w)
        else:
            one = tbe.dedup_quant_pooled_lookup(f.q, f.scale, f.bias,
                                                values[lo:hi], seg, GB, w,
                                                bits)
        assert torch.equal(got[:, f.col:f.col + D], one)


def test_grouped_keys_kernel_equals_plain_on_card(dev):
    """The dedup keys kernel (with the sized unique after it) against
    ``group_keys_plain``."""
    values, lengths, offs, feats = _group_inputs(dev, "dedup", 4, 16, False,
                                                 "mixed", seed=3)
    ends, ukeys, inv = tbe.dedup_prepare_grouped(values, lengths, offs,
                                                 feats, GB)
    keys = tbe.group_keys_plain(values, lengths, offs, feats, GB)
    want_u, want_inv = tbe.sized_unique(keys)
    assert torch.equal(ukeys, want_u) and torch.equal(inv, want_inv)
    assert int(tbe.num_unique(ukeys)) > 0


@pytest.mark.parametrize("kernel,bits", (("tbe", 8), ("dedup", 8),
                                         ("dedup", 4), ("dedup", 2)))
def test_collection_forward_makes_no_host_sync(dev, kernel, bits):
    """``QuantEmbeddingBagCollection.forward`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: one grouped launch and
    no synchronisation, equal to the CPU collection's forward."""
    from torchrec_tpu_torch.modules.embedding_configs import (
        DataType,
        EmbeddingBagConfig,
        PoolingType,
    )
    from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    values, lengths, offs, feats = _group_inputs(
        torch.device("cpu"), kernel, bits, 16, False, "mixed", seed=11)
    dt = {8: DataType.INT8, 4: DataType.INT4, 2: DataType.INT2}[bits]
    tables, params = [], {}
    for i, f in enumerate(feats):
        tables.append(EmbeddingBagConfig(
            num_embeddings=f.q.shape[0], embedding_dim=16, name=f"t{i}",
            feature_names=[f"k{f.key}"], data_type=dt,
            pooling=PoolingType.MEAN if f.mean else PoolingType.SUM))
        params[f"t{i}"] = {"q": f.q, "scale": f.scale, "bias": f.bias}
    cpu = QuantEmbeddingBagCollection(tables, params, lookup_kernel=kernel)
    card = QuantEmbeddingBagCollection(tables, params,
                                       lookup_kernel=kernel).to(dev)
    keys = [f"k{k}" for k in range(len(offs) - 1)]
    kjt = KeyedJaggedTensor(keys, values, lengths, stride=GB,
                            caps=np.diff(offs).tolist())
    want = cpu(kjt)
    kjt = kjt.to(dev)
    card(kjt)  # first call: builds and loads the library
    torch.cuda.synchronize()
    name = ("quant_pooled_lookup_int8" if kernel == "tbe"
            else "dedup_quant_pooled_lookup")
    before = tbe.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = card(kjt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = tbe.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    assert torch.equal(got.values().cpu(), want.values())


# ---------------------------------------------------------------------------
# the pooled lookup with a gradient (ops/embedding_ops.py::
# pooled_embedding_lookup, the autograd Function over B1 and B4)
# ---------------------------------------------------------------------------

GRAD_CONFIGS = [(torch.float32, 16), (torch.float32, 130),
                (torch.bfloat16, 128)]


def _grad_inputs(dev, dtype, D, case, seed):
    """A table, slots with clipped ids and dropped segments (Zipf: most
    slots on a few rows, so the scatter-add has long runs), weights and an
    upstream gradient, on ``dev``."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    if case == "zipf":
        ids = np.minimum(rng.zipf(1.2, size=V) - 1, R + 2)
    else:
        ids = rng.randint(-3, R + 3, size=(V,))
    segs = rng.randint(0, S + 4, size=(V,))
    segs[: V // 10] = -1
    w = rng.rand(V).astype(np.float32)
    g = rng.randn(S, D).astype(np.float32)
    return (table, torch.from_numpy(ids).to(dev),
            torch.from_numpy(segs).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(g).to(dev))


def _lookup_grads(kernel, table, ids, segs, w, g):
    from torchrec_tpu_torch.ops.embedding_ops import pooled_embedding_lookup

    t = table.detach().requires_grad_()
    wt = w.detach().requires_grad_()
    out = pooled_embedding_lookup(t, ids, segs, S, wt, kernel=kernel)
    return out, torch.autograd.grad((out.float() * g).sum(), [t, wt])


@pytest.mark.parametrize("dtype,D", GRAD_CONFIGS)
@pytest.mark.parametrize("kernel", ("tbe", "dedup"))
def test_pooled_lookup_grad_forward_is_the_kernel_on_card(dev, kernel, dtype,
                                                          D):
    """The Function's forward launches the kernel once and returns what a
    direct call of its wrapper returns."""
    table, ids, segs, w, g = _grad_inputs(dev, dtype, D, "mixed", seed=D)
    name = "pooled_lookup" if kernel == "tbe" else "dedup_pooled_lookup"
    wrapper = getattr(tbe, name)
    want = wrapper(table, ids, segs, S, w)
    before = tbe.launch_counts()
    got, _ = _lookup_grads(kernel, table, ids, segs, w, g)
    torch.cuda.synchronize()
    after = tbe.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", ("mixed", "zipf"))
@pytest.mark.parametrize("dtype,D", GRAD_CONFIGS)
@pytest.mark.parametrize("kernel", ("tbe", "dedup"))
def test_pooled_lookup_backward_deterministic_on_card(dev, kernel, dtype, D,
                                                      case):
    """Two backward calls give the same table and weight gradients, bit
    for bit (the scatter-add sorts by row: no float atomics), and they
    agree with the CPU's within ``rtol = atol = 1e-5`` (the weights'
    column sum may reduce in another order)."""
    args = _grad_inputs(dev, dtype, D, case, seed=7 + D)
    _, first = _lookup_grads(kernel, *args)
    _, second = _lookup_grads(kernel, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert first[0].dtype == dtype and first[0].shape == args[0].shape
    _, cpu = _lookup_grads(kernel, *(a.cpu() for a in args))
    for a, b in zip(first, cpu):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_pooled_lookup_over_row_wise_buckets_equals_plain_on_card(dev,
                                                                  dtype):
    """B1 over what a row-wise owner receives: ``[N_src, F, C]`` buckets
    from ``moe_dispatch_batched`` (each source's ids bucketed by owner),
    read as ``F * N`` regions in (feature, source) order with each
    example's length counted from its example id in the bucket
    (``rw.block_regions``), ``torch.equal`` to the plain version, one
    launch."""
    import types

    from torchrec_tpu_torch.parallel.sharding.common import (
        moe_dispatch_batched,
    )
    from torchrec_tpu_torch.parallel.sharding.rw import block_regions

    rng = np.random.RandomState(7)
    N, F, B, C, rows, D, me = 4, 5, 32, 96, 1000, 64, 2
    bs = -(-rows // N)
    recv = []
    for _ in range(N):  # each source's dispatch; the owner gets bucket me
        lens = rng.randint(0, 4, size=(F, B))
        ids = [torch.from_numpy(rng.randint(0, rows, C)).to(dev)
               for _ in range(F)]
        segs = [per_slot_segments(torch.from_numpy(lens[f]).to(dev), C)
                for f in range(F)]
        w = [torch.from_numpy(rng.rand(C).astype(np.float32)).to(dev)
             for _ in range(F)]
        out = moe_dispatch_batched(
            [(i % bs).to(torch.int32) for i in ids],
            ([s.to(torch.int32) for s in segs], w), [i // bs for i in ids],
            [s < B for s in segs], N, C, (0, B, 0.0))
        recv.append([o[me] for o in out])
    ids_r, b_r, w_r = (torch.stack([r[k] for r in recv]) for k in range(3))
    regions = block_regions(types.SimpleNamespace(batch_size=B), b_r)
    table = torch.randn((bs, D), device=dev).to(dtype)
    ids, w = ids_r.reshape(-1), w_r.reshape(-1)
    tbe.reset_launch_counts()
    got = tbe.pooled_lookup_regions(table, ids, regions, w)
    assert tbe.launch_counts()["pooled_lookup"] == 1
    assert int(regions.lengths.sum()) == int((b_r < B).sum())
    assert torch.equal(got, tbe.pooled_lookup_regions_plain(table, ids,
                                                            regions, w))


def test_one_rank_nccl_forward_and_step_on_card(dev):
    """One rank over NCCL on the card: the row-wise plan's KeyedTensor
    and its tables after one step ``torch.equal`` to the one-device
    DMP's (at one rank a row-wise table is the whole table)."""
    from torchrec_tpu_torch.parallel.multiprocess import launch

    import torch_sharding_workers as workers

    (rec,) = launch(workers.nccl_rank, 1, timeout=300)
    assert rec["kt_equal"] and rec["tables_equal"], rec
    assert rec["backend"] == "nccl" and rec["loss"] == rec["one_loss"]


# ---------------------------------------------------------------------------
# the sharded EC's update (B6 over per-id segments) and the data-parallel
# groups' every-row update (B2 or B6 over the slots plus one zero-gradient
# slot a row no slot touches)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optim", tbe_backward.OPTIMIZERS)
def test_dedup_update_per_id_segments_equals_plain_on_card(dev, optim):
    """B6 with each id its own segment of weight 1 (the sharded EC's
    update): ``torch.equal`` to its plain version and to
    ``apply_sparse_update`` (the JAX collection's XLA update) on the same
    per-id gradients."""
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
        apply_sparse_update,
        bias_corrections,
        init_optimizer_state,
    )
    from torchrec_tpu_torch.parallel.embedding import _per_id

    rng = np.random.RandomState(7)
    D = 16
    ids = torch.from_numpy(np.minimum(rng.zipf(1.3, V) - 1, R - 1)).to(dev)
    valid = torch.from_numpy(rng.rand(V) > 0.2).to(dev)
    rg = torch.from_numpy(rng.randn(V, D).astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(dev)
    cfg = FusedOptimConfig(optim=EmbOptimType(optim), learning_rate=0.05,
                           weight_decay=0.01)
    out = []
    for way in ("kernel", "plain", "xla"):
        t = table.clone()
        st = init_optimizer_state(cfg, R, D, dev)
        states = [v for k, v in st.items() if k != "step"]
        sg = _per_id(ids, valid, rg)
        if way == "xla":
            apply_sparse_update(t, st, ids, valid, rg, cfg)
        else:
            fn = (tbe_backward.dedup_fused_sparse_update if way == "kernel"
                  else tbe_backward.dedup_fused_sparse_update_plain)
            # the Adam family's corrections at the XLA path's step, t = 1
            hyp = ({"bias_corrections": bias_corrections(cfg, 1)}
                   if optim in _ADAM else {})
            fn(t, states, sg.ids, sg.valid, sg.segments, sg.weights,
               sg.grad_seg, optim, 0.05, weight_decay=0.01, **hyp)
        torch.cuda.synchronize()
        out.append((t, states))
    for t, states in out[1:]:
        assert torch.equal(out[0][0], t)
        for a, b in zip(out[0][1], states):
            assert torch.equal(a, b)


@pytest.mark.parametrize("optim", ("rowwise_adagrad", "adam", "sgd"))
@pytest.mark.parametrize("kernel", UPDATES)
def test_every_row_update_equals_plain_on_card(dev, kernel, optim):
    """The data-parallel update over every row (``grouped.step_every_row``)
    through B2 or B6: ``torch.equal`` to its plain version, the touched
    rows ``torch.equal`` to the update of the slots alone, and (with
    weight decay) every row moved."""
    from torchrec_tpu_torch.ops.fused_update import SparseSegGrad
    from torchrec_tpu_torch.parallel.grouped import step_every_row

    args, grad = _run_stream(dev, "runs", 16, seed=3)
    sg = SparseSegGrad(*args[:3], args[3], grad)
    every = step_every_row(sg, R)
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.randn(R, 16).astype(np.float32)).to(dev)
    states = [torch.from_numpy(
        rng.rand(*((R,) if kind == "row" else (R, 16))).astype(np.float32)
    ).to(dev) for kind in tbe_backward.STATE_LAYOUTS[optim]]
    runs = {}
    for name, s, plain in (("kernel", every, False), ("plain", every, True),
                           ("slots", sg, False)):
        t, st = table.clone(), [x.clone() for x in states]
        _update(kernel, plain, optim, t, st,
                (s.ids, s.valid, s.segments, s.weights), s.grad_seg, None)
        torch.cuda.synchronize()
        runs[name] = (t, st)
    assert torch.equal(runs["kernel"][0], runs["plain"][0])
    for a, b in zip(runs["kernel"][1], runs["plain"][1]):
        assert torch.equal(a, b)
    touched = torch.zeros(R, dtype=torch.bool, device=dev)
    touched[sg.ids[sg.ok()].long()] = True
    assert torch.equal(runs["kernel"][0][touched], runs["slots"][0][touched])
    assert (runs["kernel"][0] != table).any(dim=1).all()  # weight decay


# ---------------------------------------------------------------------------
# the sequence path and the position-weighted EBC (slice 13)
# ---------------------------------------------------------------------------


def test_sequence_item_update_equals_plain_on_card(dev):
    """B6 with Adam over per-id segments at the BERT4Rec step's shapes
    (``SequenceModelParallel`` at the ML-20m width: a 26,744 x 64 item
    table, 256 sessions of 5 to 200 Zipf(1.0) ids in 51,200 slots, each
    id its own segment of weight 1), through the sharded collection's
    update: ``torch.equal`` to the plain version, one launch."""
    from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.parallel.embedding import (
        ShardedEmbeddingCollection,
    )
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    Vv, Dd, Bb, L = 26_744, 64, 256, 200
    rng = np.random.RandomState(13)
    lengths = rng.randint(5, L + 1, size=Bb).astype(np.int32)
    p = 1.0 / np.arange(1, Vv + 1)
    values = rng.choice(Vv, size=int(lengths.sum()), p=p / p.sum())
    kjt = KeyedJaggedTensor.from_lengths_packed(["item"], values, lengths,
                                                caps=Bb * L).to(dev)
    tables = [EmbeddingConfig(num_embeddings=Vv, embedding_dim=Dd,
                              name="t_item", feature_names=["item"])]
    ec = ShardedEmbeddingCollection.build(
        tables, {"t_item": ParameterSharding(ShardingType.TABLE_WISE,
                                             ranks=[0])}, 1, Bb,
        {"item": Bb * L})
    cfg = FusedOptimConfig(optim=EmbOptimType.ADAM, learning_rate=1e-4)
    w = torch.from_numpy(rng.randn(Vv, Dd).astype(np.float32))
    params = ec.params_from_tables({"t_item": w}, device=dev)
    _, ctxs = ec.forward_local(params, kjt)
    grads = {"item": torch.from_numpy(rng.randn(Bb * L, Dd).astype(
        np.float32)).to(dev)}
    (sg,) = ec.backward_local(ctxs, grads).values()
    assert sg.ids.numel() == Bb * L
    name = ec.group_names[0]
    out = []
    for fn in (tbe_backward.dedup_fused_sparse_update,
               tbe_backward.dedup_fused_sparse_update_plain):
        t = params[name].clone()
        st = [torch.from_numpy(rng.rand(Vv, Dd).astype(np.float32)).to(dev)
              * 1e-3 for _ in range(2)] if not out else [
                  s.clone() for s in out[0][2]]
        st0 = [s.clone() for s in st]
        before = tbe.launch_counts()["dedup_fused_sparse_update"]
        fn(t, st, sg.ids, sg.valid, sg.segments, sg.weights, sg.grad_seg,
           "adam", 1e-4, eps=1e-8, bias_corrections=(0.1, 0.001))
        torch.cuda.synchronize()
        launched = tbe.launch_counts()["dedup_fused_sparse_update"] - before
        out.append((t, st, st0, launched))
    (tk, sk, _, nk), (tp, sp, _, np_) = out
    assert (nk, np_) == (1, 0)
    assert torch.equal(tk, tp), float((tk - tp).abs().max())
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)
    touched = torch.zeros(Vv, dtype=torch.bool, device=dev)
    touched[torch.from_numpy(np.unique(values)).to(dev)] = True
    moved = (tk != params[name]).any(dim=1)
    assert torch.equal(moved, touched)


def test_position_weighted_lookup_equals_plain_on_card(dev):
    """Weighted B1 at the position-weighted EBC's shapes (one 100,000 x
    128 table, B=4096, 1 to 20 ids an example, each id weighted by its
    position's learned weight): the collection's forward ``torch.equal``
    to its plain version on the same card tensors, one launch."""
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
        key_regions,
    )
    from torchrec_tpu_torch.modules.feature_processor import (
        FeatureProcessedEmbeddingBagCollection,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    Bb, Lmax, rows, Dd = 4096, 20, 100_000, 128
    rng = np.random.RandomState(17)
    lengths = rng.randint(1, Lmax + 1, size=Bb).astype(np.int32)
    values = rng.randint(0, rows, size=int(lengths.sum()))
    kjt = KeyedJaggedTensor.from_lengths_packed(["f"], values, lengths,
                                                caps=Bb * Lmax).to(dev)
    ebc = EmbeddingBagCollection(
        [EmbeddingBagConfig(num_embeddings=rows, embedding_dim=Dd,
                            name="t", feature_names=["f"])],
        is_weighted=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    fp = FeatureProcessedEmbeddingBagCollection(ebc, {"f": Lmax}).to(dev)
    with torch.no_grad():
        fp.position_weights.position_weight_f.copy_(
            torch.rand(Lmax, generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev))
        weighted = fp.position_weights(kjt)
        before = tbe.launch_counts()["pooled_lookup"]
        got = fp(kjt).values()
        torch.cuda.synchronize()
        assert tbe.launch_counts()["pooled_lookup"] == before + 1
        ids, w, regions, _ = key_regions(weighted, [0])
        plain = tbe.pooled_lookup_regions_plain(ebc.t, ids, regions, w)
    assert got.shape == (Bb, Dd)
    assert torch.equal(got, plain), float((got - plain).abs().max())


# ---------------------------------------------------------------------------
# B1 and B4 over 16-bit serving tables: float16 tables, and float32 output
# from a bfloat16 / float16 table (read in place), with an output row
# stride (one feature's columns of a wider buffer)
# ---------------------------------------------------------------------------

# (table dtype, output dtype, D): every new instantiation, vector (D % 4
# == 0) and one-column paths
SERVING_FLOAT_CONFIGS = [
    (torch.float16, torch.float16, 8), (torch.float16, torch.float16, 130),
    (torch.float16, torch.float32, 128), (torch.float16, torch.float32, 6),
    (torch.bfloat16, torch.float32, 128), (torch.bfloat16, torch.float32, 6),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,out_dtype,D", SERVING_FLOAT_CONFIGS)
def test_serving_float_lookups_equal_plain_on_card(dev, dtype, out_dtype, D,
                                                   case):
    """B1 and B4 on a 16-bit table: ``torch.equal`` to their plain
    versions and to the same kernel over ``table.float()`` (rounded to
    the output's dtype), one launch each, the wrappers under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    rng = np.random.RandomState(D + 3)
    n = 0 if case == "empty_batch" else V
    table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
        dev, dtype)
    ids = np.where(rng.rand(n) < 0.5, rng.randint(0, 8, size=(n,)),
                   rng.randint(-3, R + 3, size=(n,)))
    ids = torch.from_numpy(ids).to(dev)
    segs = rng.randint(5, S + 4, size=(n,))
    segs[: n // 10] = -1
    segs = torch.from_numpy(segs).to(dev)
    w = (None if case == "no_weights"
         else torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev))
    over_f32 = tbe.pooled_lookup(table.float(), ids, segs, S, w).to(
        out_dtype)
    for name, fn, plain in (
            ("pooled_lookup", tbe.pooled_lookup, tbe.pooled_lookup_plain),
            ("dedup_pooled_lookup", tbe.dedup_pooled_lookup,
             tbe.dedup_pooled_lookup_plain)):
        before = tbe.launch_counts()[name]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(table, ids, segs, S, w, out_dtype=out_dtype)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert tbe.launch_counts()[name] == before + 1
        assert got.dtype == out_dtype and got.shape == (S, D)
        ref = plain(table, ids, segs, S, w, out_dtype=out_dtype)
        assert torch.equal(got, ref), name
        assert torch.equal(got, over_f32), name
        assert not got[:5].any()


@pytest.mark.parametrize("kernel", ("tbe", "dedup"))
@pytest.mark.parametrize("dtype", (torch.float16, torch.bfloat16))
def test_float_grouped_lookup_writes_columns_no_sync_on_card(dev, kernel,
                                                             dtype):
    """The FP16/BF16 collection's grouped lookup on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: one B1 (or B4) launch a
    feature, float32 written straight into each feature's columns (a
    row stride wider than D, columns off a 16-byte boundary for one
    feature), no cast kernel and no host sync; ``torch.equal`` to its
    plain version and to the lookups over ``table.float()``; with MEAN
    features."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    rng = np.random.RandomState(21)
    B, caps, Dd = 64, (3, 1, 7, 5), 16
    lengths = np.concatenate([rng.randint(0, c + 1, size=B)
                              for c in caps]).astype(np.int32)
    values = np.concatenate([
        rng.randint(0, 500, size=int(lengths[k * B:(k + 1) * B].sum()))
        for k in range(len(caps))])
    kjt = KeyedJaggedTensor.from_lengths_packed(
        [f"k{k}" for k in range(len(caps))], values, lengths,
        caps=[c * B for c in caps]).to(dev)
    feats, col = [], 0
    for k in (0, 2, 3):
        t = torch.from_numpy(rng.randn(500, Dd).astype(np.float32)).to(
            dev, dtype)
        col += 1 if k == 2 else 0  # a feature off the 4-value alignment
        feats.append(tbe.FloatFeature(t, k, col, mean=k == 3))
        col += Dd
    args = (kjt.values(), kjt.lengths(), kjt.cap_offsets(), feats)
    out = torch.zeros((B, col), device=dev)
    tbe.float_pooled_lookup_grouped(*args, out.clone(), kernel)  # build
    torch.cuda.synchronize()
    name = "pooled_lookup" if kernel == "tbe" else "dedup_pooled_lookup"
    before = tbe.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbe.float_pooled_lookup_grouped(*args, out.clone(), kernel)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = tbe.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: len(feats) * int(k == name) for k in after}
    ref = tbe.float_pooled_lookup_grouped_plain(*args, out.clone(), kernel)
    assert torch.equal(got, ref)
    f32 = [tbe.FloatFeature(f.table.float(), f.key, f.col, f.mean)
           for f in feats]
    over = tbe.float_pooled_lookup_grouped_plain(*args[:3], f32, out.clone(),
                                                 "tbe")
    assert torch.equal(got, over)


# ---------------------------------------------------------------------------
# the trt:: operators: each against the C entry point it wraps (the launch
# the grouped wrappers made through ctypes before) and its plain version,
# at the served batch's shapes (26 features, B = 256, the MLPerf DLRM-v2
# multi-hot caps, D = 128), counted by the operator library
# ---------------------------------------------------------------------------

SB, SD = 256, 128


def _ctypes_features(features, cap_offsets):
    """The C entry points' host array of a quantized group (9 int64 a
    feature: the tables' pointers and rows, region start and cap, key,
    column, MEAN)."""
    import ctypes

    vals = []
    for f in features:
        lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
        vals += [f.q.data_ptr(), f.scale.data_ptr(), f.bias.data_ptr(),
                 f.q.shape[0], lo, hi - lo, f.key, f.col, int(f.mean)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _served_batch(dev, seed):
    """A served batch in the KeyedJaggedTensor's layout: int32 values
    with ids partly out of range, lengths up to each cap."""
    from torchrec_tpu_torch.datasets.criteo import MLPERF_DLRM_V2_MULTI_HOT

    rng = np.random.RandomState(seed)
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    lengths = np.concatenate([rng.randint(0, c + 1, size=SB) for c in caps])
    values = np.concatenate([
        np.concatenate([rng.randint(-2, 1100, size=int(
            lengths[k * SB:(k + 1) * SB].sum())), np.zeros(c * SB - int(
                lengths[k * SB:(k + 1) * SB].sum()), np.int64)])
        for k, c in enumerate(caps)])
    offs = tuple(int(x) for x in np.concatenate([[0], np.cumsum(caps)]) * SB)
    return (torch.from_numpy(values.astype(np.int32)).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev), offs)


def _quant_group(dev, bits, seed):
    rng = np.random.RandomState(seed)
    Dp = SD * bits // 8
    feats = []
    for k in range(26):
        R = 1000 + 7 * k
        feats.append(tbe.GroupFeature(
            torch.from_numpy(rng.randint(0, 256, size=(R, Dp)).astype(
                np.uint8)).to(dev),
            torch.from_numpy((rng.rand(R) * 0.01 + 0.005).astype(
                np.float32)).to(dev),
            torch.from_numpy(rng.randn(R).astype(np.float32)).to(dev),
            k, k * SD, mean=k % 9 == 4))
    return feats


def _op_counts():
    from torchrec_tpu_torch.ops import custom_ops

    return custom_ops.op_launch_counts()


def test_q8_operator_equals_its_c_entry_and_plain_on_card(dev):
    from torchrec_tpu_torch.ops import _native

    values, lengths, offs = _served_batch(dev, seed=1)
    feats = _quant_group(dev, 8, seed=2)
    W = 26 * SD
    before = _op_counts()
    got = tbe.quant_pooled_lookup_int8_grouped(
        values, lengths, offs, feats, torch.zeros((SB, W), device=dev))
    torch.cuda.synchronize()
    after = _op_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == "q8_pooled") for k in after}
    lib = _native.load_library("tbe_quant.cu")
    direct = torch.zeros((SB, W), device=dev)
    ends = tbe.group_ends(lengths, 26, SB)
    ids = values.to(torch.int64)
    assert lib.q8_pooled(_ctypes_features(feats, offs), 26, SB, SD, W,
                         ids.data_ptr(), None, ends.data_ptr(),
                         direct.data_ptr(),
                         torch.cuda.current_stream().cuda_stream) == 0
    ref = tbe.quant_pooled_lookup_int8_grouped_plain(
        values, lengths, offs, feats, torch.zeros((SB, W), device=dev))
    assert torch.equal(got, direct) and torch.equal(got, ref)


@pytest.mark.parametrize("bits", (8, 4, 2))
def test_dedup_q_operators_equal_their_c_entries_and_plain_on_card(dev,
                                                                   bits):
    from torchrec_tpu_torch.ops import _native

    values, lengths, offs = _served_batch(dev, seed=3)
    feats = _quant_group(dev, bits, seed=4)
    W, Dp = 26 * SD, SD * bits // 8
    stream = torch.cuda.current_stream().cuda_stream
    lib = _native.load_library("tbe_quant.cu")
    arr = _ctypes_features(feats, offs)
    before = _op_counts()
    ends, ukeys, inv = tbe.dedup_prepare_grouped(values, lengths, offs,
                                                 feats, SB)
    keys = torch.empty(values.shape, dtype=torch.int64, device=dev)
    ids = values.to(torch.int64)
    assert lib.dedup_q_keys(arr, 26, SB, ids.data_ptr(), ends.data_ptr(),
                            keys.data_ptr(), keys.shape[0], stream) == 0
    assert torch.equal(tbe.sized_unique(keys)[0], ukeys)
    got = tbe.launch_dedup_q_grouped(feats, offs, ends, ukeys, inv,
                                     torch.zeros((SB, W), device=dev), bits)
    torch.cuda.synchronize()
    after = _op_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("dedup_q_keys", "dedup_q_gather", "dedup_q_pool"))
        for k in after}
    rows = torch.empty((ukeys.shape[0], SD), device=dev)
    direct = torch.zeros((SB, W), device=dev)
    assert lib.dedup_q_gather(arr, 26, SD, Dp, bits, ukeys.data_ptr(),
                              rows.data_ptr(), ukeys.shape[0], stream) == 0
    assert lib.dedup_q_pool(arr, 26, SB, SD, W, inv.data_ptr(), None,
                            ends.data_ptr(), rows.data_ptr(),
                            direct.data_ptr(), stream) == 0
    ref = tbe.dedup_quant_pooled_lookup_grouped_plain(
        values, lengths, offs, feats, torch.zeros((SB, W), device=dev), bits)
    assert torch.equal(got, direct) and torch.equal(got, ref)


@pytest.mark.parametrize("kernel", ("tbe", "dedup"))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_float_operators_equal_their_c_entries_and_plain_on_card(dev, kernel,
                                                                 dtype):
    import ctypes

    from torchrec_tpu_torch.ops import _native

    values, lengths, offs = _served_batch(dev, seed=5)
    rng = np.random.RandomState(6)
    feats = [tbe.FloatFeature(torch.from_numpy(rng.randn(
        1000 + k, SD).astype(np.float32)).to(dev, dtype), k, k * SD,
        mean=k % 9 == 4) for k in range(26)]
    W = 26 * SD
    before = _op_counts()
    got = tbe.float_pooled_lookup_grouped(values, lengths, offs, feats,
                                          torch.zeros((SB, W), device=dev),
                                          kernel)
    torch.cuda.synchronize()
    after = _op_counts()
    op = "tbe_pooled" if kernel == "tbe" else "dedup_pooled"
    assert {k: after[k] - before[k] for k in after} == {
        k: 26 * int(k == op) for k in after}
    ref = tbe.float_pooled_lookup_grouped_plain(
        values, lengths, offs, feats, torch.zeros((SB, W), device=dev),
        kernel)
    assert torch.equal(got, ref)
    # each feature through the C entry point the operator wraps
    direct = torch.zeros((SB, W), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    code = _native.LOOKUP_DTYPES[dtype]
    w = tbe._group_mean_weights(values, lengths, offs, feats, SB)
    if kernel == "tbe":
        lib = _native.load_library("tbe_float.cu")
        ends = tbe.group_ends(lengths, 26, SB)
        for f in feats:
            lo, hi = offs[f.key], offs[f.key + 1]
            regions = (ctypes.c_longlong * 4)(lo, hi - lo, 0, SB)
            assert lib.tbe_pooled(
                f.table.data_ptr(), values.data_ptr(), 0, w.data_ptr(),
                ends[f.key].data_ptr(), 0, regions, 1,
                direct[:, f.col:].data_ptr(), SD, f.table.shape[0], code, 0,
                W, stream) == 0
    else:
        lib = _native.load_library("tbe_dedup.cu")
        seg = tbe._group_segments(values, lengths, offs, feats, SB)
        ukeys, inv, sw, offsets = tbe.dedup_prepare_sized(values, seg, w,
                                                          26 * SB)
        for f in feats:
            assert lib.dedup_pooled(
                f.table.data_ptr(), ukeys.data_ptr(), inv.data_ptr(),
                sw.data_ptr(), offsets[f.key * SB:].data_ptr(),
                direct[:, f.col:].data_ptr(), SB, SD, f.table.shape[0], code,
                0, W, stream) == 0
    assert torch.equal(got, direct)


@pytest.mark.parametrize("quant,kernel", (("int8", None), ("int4", None),
                                          ("bf16", "tbe"), ("bf16", "dedup")))
def test_exported_serving_module_holds_the_operators_on_card(
        dev, tmp_path, quant, kernel):
    """``torch.export`` of a serving artifact's flat module on the card:
    each group's ``trt::`` operators in the graph and the tables read by
    nothing else; the exported program's scores ``torch.equal`` to the
    eager module's (the same operators, in the same order)."""
    import dataclasses

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        MLPERF_DLRM_V2_MULTI_HOT,
        mlperf_dlrm_v2_tables,
    )
    from torchrec_tpu_torch.inference import package_model
    from torchrec_tpu_torch.inference.predict_factory import flat_serving
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops import custom_ops

    tables = tuple(dataclasses.replace(c, num_embeddings=min(
        c.num_embeddings, 2000), embedding_dim=16)
        for c in mlperf_dlrm_v2_tables(16))
    rng = np.random.RandomState(7)
    weights = {c.name: (rng.randn(c.num_embeddings, 16) * 0.05).astype(
        np.float32) for c in tables}
    torch.manual_seed(0)
    model = DLRM(EmbeddingBagCollection(tables, device="meta"), 13,
                 (32, 16), (32, 1))
    caps = list(MLPERF_DLRM_V2_MULTI_HOT)
    path = str(tmp_path / "artifact")
    package_model(path, tables, weights, dict(zip(DEFAULT_CAT_NAMES, caps)),
                  13, quant_dtype=quant, dense_state_dict=model.state_dict(),
                  model_config={"arch": "dlrm",
                                "dense_arch_layer_sizes": [32, 16],
                                "over_arch_layer_sizes": [32, 1]})
    flat, _ = flat_serving(path, dev, kernel, 16)
    inputs = flat.example_inputs(dev)
    lengths = torch.from_numpy(np.concatenate([
        rng.randint(0, c + 1, size=16) for c in caps]).astype(np.int32))
    values = torch.from_numpy(rng.randint(0, 2000, size=inputs[1].shape)
                              .astype(np.int32))
    inputs = (torch.from_numpy(rng.randn(16, 13).astype(np.float32)).to(dev),
              values.to(dev), lengths.to(dev))
    with torch.no_grad():
        ep = torch.export.export(flat, inputs)
    per_group = {"int8": {"q8_pooled": 1},
                 "int4": {"dedup_q_keys": 1, "dedup_q_gather": 1,
                          "dedup_q_pool": 1},
                 "bf16": {f"{kernel}_pooled": 26}}[quant]
    assert custom_ops.trt_op_calls(ep.graph) == per_group
    tables_in = {spec.arg.name for spec in ep.graph_signature.input_specs
                 if spec.target and spec.target.endswith(".q")}
    for node in ep.graph.nodes:
        if node.name in tables_in:
            assert all(u.target.namespace == "trt" for u in node.users)
    assert torch.equal(ep.module()(*inputs), flat(*inputs))


# B2 and B6 over a bfloat16 or float16 optimizer state (the six optimizers
# with one), float32 and bfloat16 tables, at the three column layouts, and
# the stochastic-rounding switch: bitwise their plain versions, the state
# kept in its dtype, and a bf16 table's two settings apart
LOWP_STATEFUL = ("adagrad", "rowwise_adagrad", "adam",
                 "partial_rowwise_adam", "lamb", "partial_rowwise_lamb")
LOWP_CONFIGS = [
    (kernel, optim, sdtype, D)
    for kernel in UPDATES for optim in LOWP_STATEFUL
    for sdtype in (torch.bfloat16, torch.float16) for D in (16, 6, 132)
]


def _lowp_update(kernel, plain, optim, table, states, args, grad, seed):
    bc = (0.271, 0.004)
    if kernel == UPDATES[0]:
        fn = (tbe_backward.fused_sparse_update_plain if plain
              else tbe_backward.fused_sparse_update)
        adam = optim in _ADAM
        fn(table, None if adam else states[0], *args, grad, 0.05,
           weight_decay=0.01, sr_seed=seed, optim=optim,
           states=states if adam else None, bias_corrections=bc)
    else:
        fn = (tbe_backward.dedup_fused_sparse_update_plain if plain
              else tbe_backward.dedup_fused_sparse_update)
        fn(table, states, *args, grad, optim, 0.05, weight_decay=0.01,
           sr_seed=seed, bias_corrections=bc)


@pytest.mark.parametrize("kernel,optim,sdtype,D", LOWP_CONFIGS)
def test_update_low_precision_state_equals_plain_on_card(dev, kernel, optim,
                                                         sdtype, D):
    rng = np.random.RandomState(D + 11)
    ids = np.minimum(rng.zipf(1.2, V) - 1, R + 3)
    args = [torch.from_numpy(x).to(dev) for x in (
        ids, rng.rand(V) > 0.1, rng.randint(-2, S + 2, V),
        rng.rand(V).astype(np.float32))]
    grad = torch.from_numpy(rng.randn(S, D).astype(np.float32)).to(dev)
    for dtype, seeds in ((torch.float32, (None,)),
                         (torch.bfloat16, (None, 4321))):
        table = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(
            dev, dtype)
        states = [torch.from_numpy(
            rng.rand(*((R,) if k == "row" else (R, D))).astype(np.float32)
        ).to(dev, sdtype) for k in tbe_backward.STATE_LAYOUTS[optim]]
        runs = []
        for seed in seeds:
            tk, sk = table.clone(), [s.clone() for s in states]
            tp, sp = table.clone(), [s.clone() for s in states]
            before = tbe.launch_counts()[kernel]
            _lowp_update(kernel, False, optim, tk, sk, args, grad, seed)
            torch.cuda.synchronize()
            assert tbe.launch_counts()[kernel] == before + 1
            _lowp_update(kernel, True, optim, tp, sp, args, grad, seed)
            assert torch.equal(tk, tp), (seed, float(
                (tk.float() - tp.float()).abs().max()))
            for a, b in zip(sk, sp):
                assert a.dtype == sdtype and torch.equal(a, b), float(
                    (a.float() - b.float()).abs().max())
            runs.append(tk)
        if len(runs) == 2:  # round to nearest once vs stochastically
            assert not torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("sdtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("kernel", UPDATES)
def test_update_low_precision_registers_on_card(dev, kernel, sdtype):
    """Every 16-bit-state instantiation builds and fits the narrow
    layout's register bound, like its f32-state one."""
    for optim in LOWP_STATEFUL:
        for dtype in (torch.float32, torch.bfloat16):
            info = tbe_backward.update_launch(kernel, optim, dtype, 128,
                                              10**6, state_dtype=sdtype)
            assert info["layout"] == "narrow"
            assert info["registers"] <= 128 and info["blocks_per_sm"] >= 2


# -- the tiered cache's IO: side-stream prefetch against the synchronous path

TIERED_ROWS, TIERED_CACHE, TIERED_D, TIERED_B = 2000, 96, 16, 32


def _tiered_world(dev, prefetch, w0):
    from torchrec_tpu_torch.models.dlrm import DLRM
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
    )
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.optim import adagrad
    from torchrec_tpu_torch.parallel.model_parallel import (
        DistributedModelParallel,
    )
    from torchrec_tpu_torch.parallel.train_pipeline import BucketingConfig
    from torchrec_tpu_torch.parallel.types import table_wise_plan
    from torchrec_tpu_torch.tiered import (
        TieredCollection,
        TieredTable,
        TieredTrainPipeline,
        opt_slot_widths,
    )

    tables = (EmbeddingBagConfig(num_embeddings=TIERED_CACHE,
                                 embedding_dim=TIERED_D, name="big",
                                 feature_names=["q"]),)
    fc = FusedOptimConfig(optim=EmbOptimType.ADAGRAD, learning_rate=0.05)
    dmp = DistributedModelParallel(
        DLRM(EmbeddingBagCollection(tables, device="meta"), 4,
             (8, TIERED_D), (8, 1)), tables, table_wise_plan(tables),
        TIERED_B, {"q": 2 * TIERED_B}, fused_config=fc,
        dense_optimizer=adagrad(0.05), device=dev)
    state = dmp.init(torch.Generator(device=dev).manual_seed(0))
    tt = TieredTable("big", TIERED_ROWS, TIERED_D, TIERED_CACHE,
                     opt_slots=opt_slot_widths(fc, TIERED_D),
                     init_fn=lambda s, e: w0[s:e], eviction_policy="lru")
    coll = TieredCollection({"big": tt}, {"q": "big"})
    pipe = TieredTrainPipeline(
        dmp, state, coll,
        BucketingConfig(kernels={"pooled": "dedup", "update": "dedup"}),
        prefetch=prefetch)
    return dmp, coll, pipe


def test_tiered_side_stream_prefetch_equals_sync_on_card(dev):
    """Ten steps of a 2,000-row table through a 96-slot cache (Zipf ids,
    two a example): the prefetch run, whose fills come from pinned
    buffers over a side stream, ends on every loss, logical row, Adagrad
    slot and dense parameter of the synchronous run, bitwise; rows were
    staged, evicted, written back and fetched again."""
    from torchrec_tpu_torch.datasets.utils import Batch
    from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor

    rng = np.random.RandomState(0)
    w0 = rng.uniform(-0.05, 0.05, (TIERED_ROWS, TIERED_D)).astype(np.float32)
    batches = []
    for _ in range(10):
        q = (rng.zipf(1.1, size=2 * TIERED_B) - 1) % TIERED_ROWS
        batches.append(Batch(
            torch.from_numpy(rng.rand(TIERED_B, 4).astype(np.float32)),
            KeyedJaggedTensor.from_lengths_packed(
                ["q"], torch.from_numpy(q.astype(np.int64)),
                torch.full((TIERED_B,), 2, dtype=torch.int32),
                caps=[2 * TIERED_B]),
            torch.from_numpy(rng.randint(0, 2, TIERED_B).astype(
                np.float32))))
    out = {}
    for prefetch in (True, False):
        dmp, coll, pipe = _tiered_world(dev, prefetch, w0)
        it = iter(batches)
        losses = [float(pipe.progress(it)["loss"]) for _ in range(10)]
        torch.cuda.synchronize()
        out[prefetch] = (losses,
                         coll.logical_table_rows(dmp, pipe.state, "big"),
                         {k: v.clone() for k, v in pipe.state["dense"].items()},
                         coll.stats.per_table["big"])
        pipe.close()
    (la, ra, da, sa), (lb, rb, db, sb) = out[True], out[False]
    assert la == lb
    assert np.array_equal(ra, rb)
    assert all(torch.equal(da[k], db[k]) for k in da)
    assert sa["staged_rows"] > 0 and sb["staged_rows"] == 0
    assert sa["writeback_rows"] > 0 and sa["eviction_count"] > 0


class _HotFn(torch.nn.Module):
    """score = sum of the hot table's pooled rows + sum of the dense
    features; the lookup on the kernel ``with_lookup_kernel`` gave it, or
    the registry's."""

    device = torch.device("cuda")

    def __init__(self, kernel=None):
        super().__init__()
        self.kernel = kernel

    def with_lookup_kernel(self, kernel):
        """This function with its lookup on ``kernel``."""
        return _HotFn(kernel)

    def forward(self, dense, kjt, caches):
        from torchrec_tpu_torch.ops.embedding_ops import (
            pooled_embedding_lookup,
            resolve_lookup_kernel,
        )

        pooled = pooled_embedding_lookup(
            caches["big"], kjt.values(), kjt.segment_ids(), kjt.total_stride,
            kernel=resolve_lookup_kernel(self.kernel))
        return pooled.sum(-1) + dense.sum(-1)


def test_fresh_adoption_on_the_card(dev, tmp_path):
    """One freshness adoption on the card: a published generation lands in
    the replica's host tier and its resident cache rows on the card, and
    a served batch launches B4 over the refreshed cache and scores the new
    rows."""
    from torchrec_tpu_torch.inference.bucketed_serving import (
        BucketedInferenceServer,
        HotRowServingCache,
    )
    from torchrec_tpu_torch.inference.freshness import (
        DeltaPublisher,
        DeltaSubscriber,
    )
    from torchrec_tpu_torch.ops import _native

    rng = np.random.RandomState(0)
    w = rng.randn(500, 16).astype(np.float32)
    hot = HotRowServingCache.from_host_weights({"big": w}, {"big": 64},
                                               {"f": "big"}, device=dev)
    srv = BucketedInferenceServer(_HotFn(), ["f"], [4], num_dense=1,
                                  max_batch_size=8, queue="python",
                                  dedup="pallas_dedup", hot_rows=hot)
    srv.warmup()
    srv.start(num_executors=1)
    try:
        ids = np.asarray([3, 17, 400], np.int64)
        srv.predict(np.zeros(1, np.float32), [ids], timeout_us=60_000_000)
        d = str(tmp_path / "deltas")
        sub = DeltaSubscriber(d, hot.tables, hot_rows=hot)
        new = rng.randn(3, 16).astype(np.float32)
        DeltaPublisher(d).publish(5, {"big": (ids, new)})
        assert sub.poll() is True
        res = dict(zip(*(a.tolist() for a in hot.tables["big"].resident_items())))
        cache = hot.device_caches()["big"].cpu().numpy()
        np.testing.assert_array_equal(cache[[res[i] for i in ids.tolist()]],
                                      new)
        before = _native.launch_counts()["dedup_pooled_lookup"]
        got = srv.predict(np.zeros(1, np.float32), [ids],
                          timeout_us=60_000_000)
        assert _native.launch_counts()["dedup_pooled_lookup"] == before + 1
        np.testing.assert_allclose(got, new.sum(), rtol=1e-5, atol=1e-5)
    finally:
        srv.stop()
