"""The serving lookups as ``torch.library`` operators (``trt::``), so that
an exported program carries the port's hand-written kernels.

The schemas and the CUDA implementations are C++ (``csrc/torch_ops.cpp``,
built by ``ops/_native.py`` with g++ against libtorch); each operator
calls the C entry point of ``csrc/tbe_quant.cu``, ``tbe_float.cu`` or
``tbe_dedup.cu`` that the grouped serving wrappers of ``ops/tbe.py``
launch, on the current stream, and counts its launches in the library
(:func:`op_launch_counts`), whoever calls it: an eager wrapper or the
proxy executor of a compiled package.  No implementation is Python, so a
compiled package runs the operators without the interpreter.

:func:`load_ops` builds and loads the library and registers a fake
kernel for each operator (``torch.library.register_fake``: the output
shapes that ``torch.export`` traces with; they never run otherwise).  On
a card it also builds the kernel libraries and binds each operator's
entry point into the library (``trt_ops_bind``); without one (the CPU
tests) the schemas and fakes load and a call raises.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence

import torch

from torchrec_tpu_torch.ops import _native

_LIBRARY = "torch_ops.cpp"
# operator -> the kernel source whose C entry point of the same name it
# launches
KERNELS: Dict[str, str] = {
    "q8_pooled": "tbe_quant.cu",
    "dedup_q_keys": "tbe_quant.cu",
    "dedup_q_gather": "tbe_quant.cu",
    "dedup_q_pool": "tbe_quant.cu",
    "tbe_pooled": "tbe_float.cu",
    "dedup_pooled": "tbe_dedup.cu",
}
OPS = tuple(KERNELS)

_LOCK = threading.Lock()
_LOADED = {"fakes": False, "kernels": False}


def _register_fakes() -> None:
    def none(*args):
        return None

    for name in ("q8_pooled", "dedup_q_pool", "tbe_pooled", "dedup_pooled"):
        torch.library.register_fake(f"trt::{name}")(none)

    @torch.library.register_fake("trt::dedup_q_keys")
    def _keys(ids, ends, q, scale, bias, facts):
        return torch.empty_like(ids, dtype=torch.int64)

    @torch.library.register_fake("trt::dedup_q_gather")
    def _gather(ukeys, q, scale, bias, facts, bits):
        D = q[0].shape[1] * (8 // bits)
        return ukeys.new_empty((ukeys.shape[0], D), dtype=torch.float32)


def load_ops(bind_kernels: bool = True) -> ctypes.CDLL:
    """Build (at first use) and load the ``trt::`` operator library and
    register its fake kernels; with ``bind_kernels`` (a card) build the
    kernel libraries too and bind every operator to its kernel.  Returns
    the library; a failed build raises."""
    with _LOCK:
        lib = _native.load_library(_LIBRARY)
        if not _LOADED["fakes"]:
            _register_fakes()
            _LOADED["fakes"] = True
        if bind_kernels and not _LOADED["kernels"]:
            kernels = _native.load_libraries(tuple(set(KERNELS.values())))
            for op, source in KERNELS.items():
                addr = ctypes.cast(getattr(kernels[source], op),
                                   ctypes.c_void_p).value
                if lib.trt_ops_bind(op.encode(), addr) != 0:
                    raise RuntimeError(f"trt_ops_bind refused {op}")
            _LOADED["kernels"] = True
        return lib


def quant_facts(features: Sequence, cap_offsets: Sequence[int]) -> list:
    """The ``int[] facts`` of a quantized group: per feature its region
    (start, cap), its key, its first output column and its MEAN flag."""
    facts = []
    for f in features:
        lo, hi = cap_offsets[f.key], cap_offsets[f.key + 1]
        facts += [lo, hi - lo, f.key, f.col, int(f.mean)]
    return facts


def op_launch_counts() -> Dict[str, int]:
    """Each operator's launches since :func:`reset_op_launch_counts`, as
    the operator library counts them (eager and compiled calls alike)."""
    lib = _native.load_library(_LIBRARY)
    return {op: int(lib.trt_ops_launches(op.encode())) for op in OPS}


def reset_op_launch_counts() -> None:
    _native.load_library(_LIBRARY).trt_ops_reset_launches()


def trt_op_calls(graph: torch.fx.Graph) -> Dict[str, int]:
    """The ``trt::`` operator calls of an exported graph, by operator:
    direct calls and those wrapped by functionalization
    (``auto_functionalized``)."""
    calls: Dict[str, int] = {}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        if getattr(target, "__name__", "") in (
                "auto_functionalized", "auto_functionalized_v2"):
            target = node.args[0]
        if getattr(target, "namespace", None) == "trt":
            calls[target._opname] = calls.get(target._opname, 0) + 1
    return calls
