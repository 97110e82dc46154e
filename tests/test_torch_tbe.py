"""Port parity: the plain PyTorch versions of the quantized lookup kernels
(``torchrec_tpu_torch/ops/tbe.py``) against the JAX package's Pallas
kernels run in interpret mode and its XLA lookups, on the same inputs.

Tolerance ``rtol = atol = 1e-5``: XLA on the CPU may contract the JAX
side's ``q * scale + bias`` and ``acc + v * w`` into FMAs
(docs/kernels.md section 2), which the port rounds as separate
operations, so the two can differ in the last bits.

The CUDA kernels cannot run here; their input preparation and their
per-segment walk are emulated in numpy float32 (one rounding per
operation, slot order) and must equal the plain versions bit for bit —
the property ``chip_smoke.py`` checks on the card with ``torch.equal``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import embedding_ops as jeo
from torchrec_tpu.ops import pallas_tbe as jtbe
from torchrec_tpu.ops import quant_ops as jq
from torchrec_tpu_torch.ops import embedding_ops as teo
from torchrec_tpu_torch.ops import quant_ops as tq
from torchrec_tpu_torch.ops import tbe

RTOL = ATOL = 1e-5
QUANTIZE = {8: jq.quantize_rowwise_int8, 4: jq.quantize_rowwise_int4,
            2: jq.quantize_rowwise_int2}

# name -> (R, id_range, seg_range, weights kind); every case shares the
# shapes below, so each JAX reference compiles once per bit width
R, D, S, V = 64, 16, 8, 48
CASES = {
    "uniform": ((0, R), (0, S), "rand"),
    "duplicate_heavy": ((0, 4), (0, S), "rand"),
    "empty_segments": ((0, R), (2, 5), "rand"),
    "no_weights": ((0, R), (0, S), None),
    "mean": ((0, R), (0, S), "mean"),
    "ids_out_of_range": ((-5, R + 10), (0, S), "rand"),
    "bad_segments": ((0, R), (-3, S + 3), "rand"),
}


def _case(name, bits, seed=0):
    (ilo, ihi), (slo, shi), wkind = CASES[name]
    rng = np.random.RandomState(seed + 17 * bits)
    table = rng.randn(R, D).astype(np.float32)
    packed, scale, bias = (np.asarray(x) for x in QUANTIZE[bits](
        jnp.asarray(table)))
    ids = rng.randint(ilo, ihi, size=(V,)).astype(np.int32)
    segs = rng.randint(slo, shi, size=(V,)).astype(np.int32)
    if wkind == "rand":
        w = rng.rand(V).astype(np.float32)
    elif wkind == "mean":
        lengths = np.bincount(segs[(segs >= 0) & (segs < S)], minlength=S)
        w = np.asarray(jeo.mean_pooling_weights(
            jnp.asarray(segs), jnp.asarray(lengths.astype(np.int32))))
    else:
        w = None
    return packed, scale, bias, ids, segs, S, w


# jitted once per static configuration, so the cases share compilations
_pallas_q8 = jax.jit(functools.partial(
    jtbe.pallas_quantized_pooled_lookup, num_segments=S, chunk=32,
    group=8, interpret=True,
))
_xla_q8 = jax.jit(functools.partial(jq.quantized_pooled_lookup,
                                    num_segments=S))
_pallas_dedup = {
    bits: jax.jit(functools.partial(
        jtbe.pallas_ragged_dedup_quantized_lookup, num_segments=S,
        bits=bits, chunk=32, group=8, interpret=True,
    ))
    for bits in (8, 4, 2)
}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _ulp_gap(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude float order onto a monotone integer line
    ai = np.where(ai < 0, np.int64(-(2**31)) - ai, ai)
    bi = np.where(bi < 0, np.int64(-(2**31)) - bi, bi)
    return int(np.abs(ai - bi).max(initial=0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_plain_matches_pallas_and_xla(case):
    q, scale, bias, ids, segs, S, w = _case(case, 8)
    got = tbe.quant_pooled_lookup_int8(
        _t(q), _t(scale), _t(bias), _t(ids), _t(segs), S, _t(w)
    ).numpy()
    pallas = np.asarray(_pallas_q8(
        _j(q), _j(scale), _j(bias), _j(ids), _j(segs), weights=_j(w)
    ))
    # the XLA reference keeps negative segments out of segment_sum by
    # itself; ids clip inside it
    xla = np.asarray(_xla_q8(
        _j(q), _j(scale), _j(bias), _j(ids), _j(segs), weights=_j(w)
    ))
    assert got.shape == (S, q.shape[1]) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL,
                               err_msg=f"ulp gap {_ulp_gap(got, pallas)}")
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL,
                               err_msg=f"ulp gap {_ulp_gap(got, xla)}")
    print(f"{case}: int8 ulp gap vs pallas {_ulp_gap(got, pallas)}, "
          f"vs xla {_ulp_gap(got, xla)}")


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dedup_plain_matches_pallas(case, bits):
    packed, scale, bias, ids, segs, S, w = _case(case, bits)
    got = tbe.dedup_quant_pooled_lookup(
        _t(packed), _t(scale), _t(bias), _t(ids), _t(segs), S, _t(w),
        bits=bits,
    ).numpy()
    pallas = np.asarray(_pallas_dedup[bits](
        _j(packed), _j(scale), _j(bias), _j(ids), _j(segs), weights=_j(w)
    ))
    assert got.shape == (S, packed.shape[1] * 8 // bits)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL,
                               err_msg=f"ulp gap {_ulp_gap(got, pallas)}")
    print(f"{case}: int{bits} dedup ulp gap vs pallas "
          f"{_ulp_gap(got, pallas)}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_tbe_and_dedup_plain_bit_equal(case):
    q, scale, bias, ids, segs, S, w = _case(case, 8)
    args = (_t(q), _t(scale), _t(bias), _t(ids), _t(segs), S, _t(w))
    assert torch.equal(tbe.quant_pooled_lookup_int8(*args),
                       tbe.dedup_quant_pooled_lookup(*args, bits=8))


def _walk(rows_of_slot, w, offsets, D):
    """numpy float32 emulation of the kernels' per-segment walk:
    ``acc = acc + v * w`` slot by slot, one rounding per operation."""
    S = len(offsets) - 1
    out = np.zeros((S, D), np.float32)
    for s in range(S):
        acc = np.zeros((D,), np.float32)
        for i in range(offsets[s], offsets[s + 1]):
            acc = acc + rows_of_slot(i) * w[i]
        out[s] = acc
    return out


def _dequant_np(codes, s, b):
    return codes.astype(np.float32) * np.float32(s) + np.float32(b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_kernel_emulation_bit_equal(case):
    """sort_by_segment + the B3 walk (what the CUDA wrapper launches)."""
    q, scale, bias, ids, segs, S, w = _case(case, 8)
    sids, sw, offsets = tbe.sort_by_segment(
        _t(ids), _t(segs), _t(w), S, q.shape[0]
    )
    sids, sw, offsets = sids.numpy(), sw.numpy(), offsets.numpy()
    emu = _walk(lambda i: _dequant_np(q[sids[i]], scale[sids[i]],
                                      bias[sids[i]]),
                sw, offsets, q.shape[1])
    plain = tbe.quant_pooled_lookup_int8_plain(
        _t(q), _t(scale), _t(bias), _t(ids), _t(segs), S, _t(w)
    ).numpy()
    np.testing.assert_array_equal(emu, plain)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("case", ["duplicate_heavy", "ids_out_of_range",
                                  "bad_segments", "no_weights"])
def test_dedup_kernel_emulation_bit_equal(case, bits):
    """dedup_prepare_sized (the sized sort-unique) + the gather
    (unpack/dequant per distinct row) + the pool (the walk through the
    inverse index)."""
    packed, scale, bias, ids, segs, S, w = _case(case, bits)
    ukeys, suidx, sw, offsets = tbe.dedup_prepare_sized(
        _t(ids), _t(segs), _t(w), S
    )
    U = int(tbe.num_unique(ukeys))
    uids = tbe.key_rows(ukeys[:U], packed.shape[0]).numpy()
    suidx, sw, offsets = suidx.numpy(), sw.numpy(), offsets.numpy()
    valid = (segs >= 0) & (segs < S)
    assert len(uids) == len(np.unique(ids[valid]))
    codes = tbe.unpack_rows(_t(packed[uids]), bits).numpy()
    rows = np.stack([_dequant_np(codes[u], scale[r], bias[r])
                     for u, r in enumerate(uids)]) if len(uids) else None
    D = packed.shape[1] * 8 // bits
    emu = _walk(lambda i: rows[suidx[i]], sw, offsets, D)
    plain = tbe.dedup_quant_pooled_lookup_plain(
        _t(packed), _t(scale), _t(bias), _t(ids), _t(segs), S, _t(w),
        bits=bits,
    ).numpy()
    np.testing.assert_array_equal(emu, plain)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_empty_batch_pools_to_zeros(bits):
    """No ids at all (an all-empty formed batch): every segment is zero,
    through both lookups and both of the dedup preparation's outputs."""
    packed, scale, bias, _, _, S, _ = _case("uniform", bits)
    none = torch.zeros((0,), dtype=torch.int64)
    args = (_t(packed), _t(scale), _t(bias), none, none, S)
    D = packed.shape[1] * 8 // bits
    assert tbe.unpack_rows(_t(packed[:0]), bits).shape == (0, D)
    out = tbe.dedup_quant_pooled_lookup(*args, bits=bits)
    assert torch.equal(out, torch.zeros((S, D)))
    if bits == 8:
        assert torch.equal(tbe.quant_pooled_lookup_int8(*args), out)
    uids, suidx, sw, offsets = tbe.dedup_prepare(none, none, None, S,
                                                 packed.shape[0])
    assert uids.numel() == suidx.numel() == sw.numel() == 0
    assert torch.equal(offsets, torch.zeros((S + 1,), dtype=torch.int64))


def test_mean_pooling_weights_equal():
    rng = np.random.RandomState(5)
    lengths = rng.randint(0, 4, size=(6,)).astype(np.int32)
    segs = np.concatenate([np.repeat(np.arange(6), lengths),
                           np.full((5,), 6)]).astype(np.int32)
    a = np.asarray(jeo.mean_pooling_weights(jnp.asarray(segs),
                                            jnp.asarray(lengths)))
    b = teo.mean_pooling_weights(_t(segs), _t(lengths)).numpy()
    np.testing.assert_array_equal(a, b)


def test_cpu_tensors_launch_nothing():
    """The dispatch rule: CPU tensors take the plain versions, so no
    launch counter moves."""
    tbe.reset_launch_counts()
    for bits in (8, 4, 2):
        packed, scale, bias, ids, segs, S, w = _case("uniform", bits)
        args = (_t(packed), _t(scale), _t(bias), _t(ids), _t(segs), S,
                _t(w))
        if bits == 8:
            tbe.quant_pooled_lookup_int8(*args)
            tq.quantized_pooled_lookup(*args, kernel="tbe")
            tq.quantized_pooled_lookup(*args, kernel="dedup")
        tbe.dedup_quant_pooled_lookup(*args, bits=bits)
    assert tbe.launch_counts() == {
        "pooled_lookup": 0, "fused_sparse_update": 0,
        "quant_pooled_lookup_int8": 0, "dedup_quant_pooled_lookup": 0,
        "dedup_pooled_lookup": 0, "dedup_fused_sparse_update": 0,
    }


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU launches the kernel or raises;
    here (no CUDA) a meta tensor must raise, not compute."""
    meta = torch.device("meta")
    q = torch.empty((10, 8), dtype=torch.uint8, device=meta)
    f = torch.empty((10,), dtype=torch.float32, device=meta)
    i = torch.empty((4,), dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        tbe.quant_pooled_lookup_int8(q, f, f, i, i, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tbe.dedup_quant_pooled_lookup(q, f, f, i, i, 2, bits=8)


def test_wrapper_input_checks():
    q = torch.zeros((10, 8), dtype=torch.uint8)
    s = torch.ones((10,))
    ids = torch.zeros((4,), dtype=torch.int64)
    with pytest.raises(TypeError):
        tbe.quant_pooled_lookup_int8(q.float(), s, s, ids, ids, 2)
    with pytest.raises(TypeError):
        tbe.quant_pooled_lookup_int8(q, s[:5], s, ids, ids, 2)
    with pytest.raises(ValueError):
        tbe.quant_pooled_lookup_int8(q, s, s, ids, ids[:3], 2)
    with pytest.raises(ValueError):
        tbe.dedup_quant_pooled_lookup(q, s, s, ids, ids, 2, bits=3)
    with pytest.raises(ValueError):
        tq.quantized_pooled_lookup(q, s, s, ids, ids, 2, kernel="xla")
