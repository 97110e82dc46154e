"""The ``trt::`` operators (``csrc/torch_ops.cpp``, loaded by
``ops/custom_ops.py``): their schemas, and their fake kernels' outputs on
meta tensors at the serving path's group layouts (the MLPerf DLRM-v2
serving batch: 26 features, B = 256, the multi-hot caps, D = 128), which
is what ``torch.export`` traces with.  The library builds here with g++
against the CPU torch; no CUDA kernel is bound, so a call on CPU tensors
has no implementation, and the launch counters stay at zero.  The CUDA
implementations are held to their plain versions on the card
(``tests/test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest
import torch

from torchrec_tpu_torch.datasets.criteo import MLPERF_DLRM_V2_MULTI_HOT
from torchrec_tpu_torch.ops import custom_ops, tbe

META = torch.device("meta")
B, D = 256, 128
CAPS = tuple(MLPERF_DLRM_V2_MULTI_HOT)
F = len(CAPS)
V = sum(CAPS) * B

SCHEMAS = {
    "q8_pooled": "trt::q8_pooled(Tensor(a!) out, Tensor ids, Tensor? "
                 "weights, Tensor ends, Tensor[] q, Tensor[] scale, "
                 "Tensor[] bias, int[] facts) -> ()",
    "dedup_q_keys": "trt::dedup_q_keys(Tensor ids, Tensor ends, Tensor[] q, "
                    "Tensor[] scale, Tensor[] bias, int[] facts) -> Tensor",
    "dedup_q_gather": "trt::dedup_q_gather(Tensor ukeys, Tensor[] q, "
                      "Tensor[] scale, Tensor[] bias, int[] facts, int bits) "
                      "-> Tensor",
    "dedup_q_pool": "trt::dedup_q_pool(Tensor(a!) out, Tensor inv, Tensor? "
                    "weights, Tensor ends, Tensor rows, Tensor[] q, "
                    "Tensor[] scale, Tensor[] bias, int[] facts) -> ()",
    "tbe_pooled": "trt::tbe_pooled(Tensor(a!) out, Tensor table, Tensor ids, "
                  "Tensor? weights, Tensor ends, int[] facts) -> ()",
    "dedup_pooled": "trt::dedup_pooled(Tensor(a!) out, Tensor table, Tensor "
                    "ukeys, Tensor inv, Tensor weights, Tensor offsets, "
                    "int[] facts) -> ()",
}


@pytest.fixture(scope="module")
def ops():
    """The operator library, built with g++ at first use; schemas and
    fakes only (no card)."""
    return custom_ops.load_ops(bind_kernels=False)


def _group(bits):
    """One quantized group of the serving batch on meta tensors: the
    26 tables' packed rows, and the group's facts."""
    Dp = D * bits // 8
    q = [torch.empty((1000 + f, Dp), dtype=torch.uint8, device=META)
         for f in range(F)]
    scale = [torch.empty((1000 + f,), device=META) for f in range(F)]
    bias = [torch.empty((1000 + f,), device=META) for f in range(F)]
    offs = np.concatenate([[0], np.cumsum(CAPS)]) * B
    feats = [tbe.GroupFeature(q[f], scale[f], bias[f], f, f * D)
             for f in range(F)]
    return q, scale, bias, custom_ops.quant_facts(feats, offs.tolist())


def test_ops_schemas(ops):
    assert set(custom_ops.OPS) == set(SCHEMAS)
    for op, want in SCHEMAS.items():
        assert str(getattr(torch.ops.trt, op).default._schema) == want


def test_quant_facts_layout():
    feats = [tbe.GroupFeature(None, None, None, key=2, col=8, mean=True),
             tbe.GroupFeature(None, None, None, key=0, col=0)]
    assert custom_ops.quant_facts(feats, (0, 4, 10, 30)) == [
        10, 20, 2, 8, 1, 0, 4, 0, 0, 0]


def test_q8_pooled_fake_mutates_the_kt_buffer(ops):
    q, scale, bias, facts = _group(8)
    out = torch.empty((B, F * D), device=META)
    ends = torch.empty((F, B), dtype=torch.int32, device=META)
    ids = torch.empty((V,), dtype=torch.int64, device=META)
    assert torch.ops.trt.q8_pooled(out, ids, None, ends, q, scale, bias,
                                   facts) is None
    assert torch.ops.trt.q8_pooled.default._schema.arguments[0].alias_info \
        .is_write


@pytest.mark.parametrize("bits", (8, 4, 2))
def test_dedup_q_fakes_shapes(ops, bits):
    q, scale, bias, facts = _group(bits)
    ids = torch.empty((V,), dtype=torch.int64, device=META)
    ends = torch.empty((F, B), dtype=torch.int32, device=META)
    keys = torch.ops.trt.dedup_q_keys(ids, ends, q, scale, bias, facts)
    assert (keys.shape, keys.dtype, keys.device) == ((V,), torch.int64, META)
    rows = torch.ops.trt.dedup_q_gather(keys, q, scale, bias, facts, bits)
    assert (rows.shape, rows.dtype) == ((V, D), torch.float32)
    out = torch.empty((B, F * D), device=META)
    inv = torch.empty((V,), dtype=torch.int64, device=META)
    assert torch.ops.trt.dedup_q_pool(out, inv, None, ends, rows, q, scale,
                                      bias, facts) is None


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16,
                                   torch.float32))
def test_float_fakes(ops, dtype):
    out = torch.empty((B, F * D), device=META)
    table = torch.empty((5000, D), dtype=dtype, device=META)
    values = torch.empty((V,), dtype=torch.int32, device=META)
    ends = torch.empty((F, B), dtype=torch.int32, device=META)
    assert torch.ops.trt.tbe_pooled(out, table, values, None, ends,
                                    [0, CAPS[0] * B, 0, 0]) is None
    long = dict(dtype=torch.int64, device=META)
    assert torch.ops.trt.dedup_pooled(
        out, table, torch.empty((V,), **long), torch.empty((V,), **long),
        torch.empty((V,), device=META), torch.empty((F * B + 1,), **long),
        [3, 3 * D]) is None


def test_cpu_call_has_no_implementation_and_counts_nothing(ops):
    custom_ops.reset_op_launch_counts()
    q = [torch.zeros((10, 16), dtype=torch.uint8)]
    s = [torch.zeros(10)]
    with pytest.raises(NotImplementedError, match="trt::q8_pooled"):
        torch.ops.trt.q8_pooled(
            torch.zeros((8, 16)), torch.zeros(32, dtype=torch.int64), None,
            torch.zeros((1, 8), dtype=torch.int32), q, s, s, [0, 32, 0, 0, 0])
    assert custom_ops.op_launch_counts() == dict.fromkeys(custom_ops.OPS, 0)


def test_trt_op_calls_counts_direct_and_functionalized_calls(ops):
    g = torch.fx.Graph()
    out = g.placeholder("out")
    g.call_function(torch.ops.trt.tbe_pooled.default, (out,))
    g.call_function(torch.ops.trt.tbe_pooled.default, (out,))
    g.call_function(torch.ops.aten.add.Tensor, (out, out))
    from torch._higher_order_ops.auto_functionalize import (
        auto_functionalized,
    )
    g.call_function(auto_functionalized,
                    (torch.ops.trt.q8_pooled.default,))
    assert custom_ops.trt_op_calls(g) == {"tbe_pooled": 2, "q8_pooled": 1}
