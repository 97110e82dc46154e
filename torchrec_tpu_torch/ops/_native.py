"""Build and load the port's CUDA kernels (``torchrec_tpu_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into
``torchrec_tpu_torch/csrc/build/`` (git-ignored), and loaded with
``ctypes``.  The two backward sources (:data:`SPLIT_SOURCES`) hold 120
kernel instantiations each; they are compiled as parts, one ``nvcc -c`` for
the entry points and one for each (table type, state type) pair of
instantiations (``-DTRTPU_PART=k``, ``csrc/backward_common.cuh``'s
``TRTPU_TYPE_PAIRS``), all started together with the other builds, then
linked into the one library.  The library name carries a hash of the
source and of the ``.cuh`` headers beside it, so an edited source never
loads a stale build.  Nothing here runs at import time: the
CPU tests import every module on a machine with no ``nvcc``.

Every kernel wrapper counts its launches here, in :data:`LAUNCHES`.

Two C++ sources link to libtorch and are built with ``g++`` beside the
kernels, all started together (:data:`TORCH_SOURCES`): ``torch_ops.cpp``,
the serving lookups as ``torch.library`` operators (loaded and bound by
``ops/custom_ops.py``), and ``host/aoti_executor.cpp``, the AOTInductor
executor and its loop.  Their flags follow the installed torch: its C++
ABI (``torch._C._GLIBCXX_USE_CXX11_ABI``), its include directories and an
rpath to its libraries; their library names hash the flags too.

The serving tier's host library (``csrc/host/*.cpp``: the batching
queue, the TCP front end and the id transformers) is C++ for the CPU,
built the same way with ``g++`` by :func:`load_host_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

import torch

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
BUILD_DIR = os.path.join(CSRC_DIR, "build")
# the C++ compiler of every host-side build: the libraries here and
# export_native's AOTInductor package, which links OpenMP.  The one on
# PATH, not $CXX: that may name a compiler that cannot link OpenMP.
CXX = "g++"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# the sources built in parts, one a (table, state) type pair of
# backward_common.cuh (:func:`type_pairs`) and one for the entry points
SPLIT_SOURCES = ("tbe_backward.cu", "tbe_dedup_backward.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_G = ctypes.POINTER(ctypes.c_longlong)
_O = ctypes.POINTER(ctypes.c_int)
# C entry points per source: name -> argtypes (every pointer and the
# stream are c_void_p, every size or flag a c_int, a slot count or row
# stride a c_longlong, every scalar hyperparameter a c_float, a grouped
# lookup's features or a float lookup's regions a host array of
# c_longlong, a launch's facts a host array of c_int; each returns
# cudaGetLastError() or 0)
_SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "tbe_quant.cu": {
        "q8_pooled": (_G, _I, _I, _I, _L, _P, _P, _P, _P, _P),
        "dedup_q_keys": (_G, _I, _I, _P, _P, _P, _L, _P),
        "dedup_q_gather": (_G, _I, _I, _I, _I, _P, _P, _L, _P),
        "dedup_q_pool": (_G, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P),
    },
    "tbe_float.cu": {
        "tbe_pooled": (_P, _P, _I, _P, _P, _I, _G, _I, _P, _I, _L, _I, _I,
                       _L, _P),
        "tbe_pooled_info": (_I, _I, _I, _I, _I, _I, _O),
    },
    "tbe_backward.cu": {
        "fused_update": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _P),
        "fused_update_info": (_I, _I, _I, _I, _I, _O),
    },
    "tbe_dedup.cu": {
        "dedup_pooled": (_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _L,
                         _P),
    },
    "tbe_dedup_backward.cu": {
        "dedup_fused_update": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I,
                               _I, _I, _I, _P),
        "dedup_fused_update_info": (_I, _I, _I, _I, _I, _O),
    },
}
# the libtorch-linked libraries: C entry point -> (argtypes, restype)
_TORCH_SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "torch_ops.cpp": {
        "trt_ops_bind": ((ctypes.c_char_p, _P), _I),
        "trt_ops_launches": ((ctypes.c_char_p,), _L),
        "trt_ops_reset_launches": ((), None),
    },
    "host/aoti_executor.cpp": {
        "trt_aoti_open": ((ctypes.c_char_p, _I, _I, _I,
                           ctypes.POINTER(ctypes.c_char_p),
                           ctypes.POINTER(_P), _O, _O,
                           ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64),
                          _P),
        "trt_aoti_last_error": ((), ctypes.c_char_p),
        "trt_aoti_run": ((_P, _P, _P, _P, _P, ctypes.c_int64),
                         ctypes.c_int64),
        "trt_aoti_run_error": ((_P,), ctypes.c_char_p),
        "trt_aoti_close": ((_P,), None),
        "trt_aoti_loop_start": ((_P, _P, _P, _P, _P), _P),
        "trt_aoti_loop_stats": ((_P, ctypes.POINTER(ctypes.c_int64)), None),
        "trt_aoti_loop_stop": ((_P,), None),
    },
}
TORCH_SOURCES = tuple(_TORCH_SIGNATURES)
SOURCES = tuple(_SIGNATURES) + TORCH_SOURCES

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# source -> {"seconds": build time (0.0 when reused), "log": nvcc output}
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from source at first use"
        )
    return path


def _torch_flags() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile, link) g++ flags of a libtorch-linked source: torch's C++
    ABI and include directories; its libraries (``torch_cuda`` too where
    torch has it) and an rpath to them."""
    root = os.path.dirname(torch.__file__)
    inc, lib = os.path.join(root, "include"), os.path.join(root, "lib")
    libs = ("-ltorch", "-ltorch_cpu", "-lc10")
    if os.path.exists(os.path.join(lib, "libtorch_cuda.so")):
        libs += ("-ltorch_cuda", "-lc10_cuda")
    return (("-O2", "-std=c++17", "-shared", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI="
             f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"-I{inc}", f"-I{os.path.join(inc, 'torch/csrc/api/include')}"),
            (f"-L{lib}", f"-Wl,-rpath,{lib}", *libs, "-lpthread"))


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    if source in TORCH_SOURCES:
        compile_flags, link_flags = _torch_flags()
        h.update(" ".join((torch.__version__, *compile_flags,
                           *link_flags)).encode())
        names = [source]
    else:
        names = [source, *sorted(n for n in os.listdir(CSRC_DIR)
                                 if n.endswith(".cuh"))]
    for name in names:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def type_pairs() -> int:
    """The number of entries of ``backward_common.cuh``'s
    ``TRTPU_TYPE_PAIRS``, the one list of the backward kernels' (table,
    state) type pairs: a split source's parts."""
    with open(os.path.join(CSRC_DIR, "backward_common.cuh")) as f:
        text = f.read()
    body = re.search(r"#define TRTPU_TYPE_PAIRS\(X\)((?:.*\\\n)*.*)", text)
    return len(re.findall(r"\bX\(\d+,", body.group(1)))


def _build_commands(source: str, out: str) -> Tuple[list, list]:
    """(the compiles, run together, the link after them or none) that build
    ``source`` into ``out``: nvcc for a kernel source, in parts for one of
    :data:`SPLIT_SOURCES`; g++ for a libtorch-linked one."""
    src = os.path.join(CSRC_DIR, source)
    if source in TORCH_SOURCES:
        compile_flags, link_flags = _torch_flags()
        return [[CXX, *compile_flags, "-o", out, src, *link_flags]], []
    if source not in SPLIT_SOURCES:
        return [[_nvcc(), *NVCC_FLAGS, "-o", out, src]], []
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    parts = type_pairs()
    objs = [f"{out}.{k}.o" for k in range(parts + 1)]
    compiles = [[_nvcc(), *flags, "-c", "-o", objs[0], src]] + [
        [_nvcc(), *flags, "-c", f"-DTRTPU_PART={k}", "-o", objs[k + 1], src]
        for k in range(parts)]
    return compiles, [_nvcc(), "-shared", "-o", out, *objs]


def load_libraries(sources: Sequence[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile the ``csrc/`` sources that have no current build, every
    compiler process (``nvcc`` for a kernel source or one part of a split
    one, ``g++`` for a :data:`TORCH_SOURCES` one) started together, a split
    source linked once its parts are done, then load each library with
    every entry point's ``argtypes``/``restype`` declared (loading
    ``torch_ops.cpp`` registers its operators).  Returns source -> library;
    raises after every build has ended if one failed.  A source's
    ``BUILD_INFO`` seconds run from the start to its library."""
    with _LOCK:
        todo = [s for s in sources if s not in _LIBS]
        paths = {s: _library_path(s) for s in todo}
        missing = [s for s in todo if not os.path.exists(paths[s])]
        for s in todo:
            if s not in missing:
                BUILD_INFO[s] = {"seconds": 0.0, "log": ""}
        # every compiler is found (or its absence raises) before anything
        # is written or started
        tmps = {s: f"{paths[s]}.{os.getpid()}.tmp" for s in missing}
        cmds = {s: _build_commands(s, tmps[s]) for s in missing}
        if missing:
            os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = {s: [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in compiles]
                 for s, (compiles, _) in cmds.items()}
        failed = []
        for s, running in procs.items():
            logs, ok = [], True
            for proc in running:
                log, _ = proc.communicate()
                logs.append(log)
                if proc.returncode != 0:
                    ok = False
                    failed.append(f"{os.path.basename(proc.args[0])} failed "
                                  f"on {s} (exit {proc.returncode}):\n{log}")
            link = cmds[s][1]
            if ok and link:
                done = subprocess.run(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                logs.append(done.stdout)
                if done.returncode != 0:
                    ok = False
                    failed.append(f"nvcc failed linking {s} (exit "
                                  f"{done.returncode}):\n{done.stdout}")
                for obj in link[4:]:
                    if os.path.exists(obj):
                        os.remove(obj)
            BUILD_INFO[s] = {"seconds": time.perf_counter() - t0,
                             "log": "".join(logs)}
            if ok:
                os.replace(tmps[s], paths[s])
        if failed:
            raise RuntimeError("\n".join(failed))
        for s in todo:
            lib = ctypes.CDLL(paths[s])
            for name, sig in _signatures(s).items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(sig[0]), sig[1]
            _LIBS[s] = lib
        return {s: _LIBS[s] for s in sources}


def _signatures(source: str) -> Dict[str, Tuple]:
    """C entry point -> (argtypes, restype) of one source's library."""
    if source in TORCH_SOURCES:
        return _TORCH_SIGNATURES[source]
    return {name: (argtypes, ctypes.c_int)
            for name, argtypes in _SIGNATURES[source].items()}


def load_library(source: str) -> ctypes.CDLL:
    """:func:`load_libraries` for one source."""
    return load_libraries((source,))[source]


# ---------------------------------------------------------------------------
# the host library: the serving tier's batching queue, TCP front end and id
# transformers (C++ for the CPU, built with g++)
# ---------------------------------------------------------------------------

HOST_DIR = os.path.join(CSRC_DIR, "host")
HOST_SOURCES = ("batching_queue.cpp", "serving_server.cpp",
                "id_transformer.cpp", "mp_id_transformer.cpp",
                "lfu_id_transformer.cpp")
# -Bsymbolic: the library's own calls (the TCP server's into the queue)
# bind inside it, whatever else the process has loaded
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wl,-Bsymbolic")

_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
_P64 = ctypes.POINTER(ctypes.c_int64)
_PF = ctypes.POINTER(ctypes.c_float)
_TRANSFORM = ((_P, _P64, _I64, _P64, _P64, _P64, _P64), _I64)
# C entry point -> (argtypes, restype)
_HOST_SIGNATURES: Dict[str, Tuple] = {
    "trt_bq_create": ((_I, _I64, _I, _I), _P),
    "trt_bq_destroy": ((_P,), None),
    "trt_bq_enqueue": ((_P, _PF, _P64, ctypes.POINTER(ctypes.c_int32)), _U64),
    "trt_bq_dequeue_batch": ((_P, _I64, ctypes.POINTER(_U64), _PF, _P64,
                              _P64, ctypes.POINTER(ctypes.c_int32)), _I),
    "trt_bq_post_result": ((_P, _U64, _PF, _I), None),
    "trt_bq_wait_result": ((_P, _U64, _I64, _PF, _I), _I),
    "trt_bq_shutdown": ((_P,), None),
    "trt_bq_pending": ((_P,), _I),
    "trt_bq_outstanding": ((_P,), _I64),
    "trt_srv_create": ((_P, _I, _I, ctypes.POINTER(ctypes.c_int32), _I64),
                       _P),
    "trt_srv_start": ((_P, _I), _I),
    "trt_srv_stop": ((_P,), None),
    "trt_srv_quiesce": ((_P, _I64), _I),
    "trt_srv_destroy": ((_P,), None),
    "trt_srv_port": ((_P,), _I),
    "trt_idt_create": ((_I64,), _P),
    "trt_idt_destroy": ((_P,), None),
    "trt_idt_transform": _TRANSFORM,
    "trt_idt_size": ((_P,), _I64),
    "trt_mpidt_create": ((_I64, _I), _P),
    "trt_mpidt_destroy": ((_P,), None),
    "trt_mpidt_transform": _TRANSFORM,
    "trt_mpidt_size": ((_P,), _I64),
    "trt_lfu_create": ((_I64, _I, ctypes.c_double), _P),
    "trt_lfu_destroy": ((_P,), None),
    "trt_lfu_transform": _TRANSFORM,
    "trt_lfu_size": ((_P,), _I64),
}
_HOST_LIB = []  # the loaded library, once


def _host_library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in HOST_SOURCES:
        with open(os.path.join(HOST_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtrt_host_{h.hexdigest()[:16]}.so")


def load_host_library() -> ctypes.CDLL:
    """Build the host library from ``csrc/host/*.cpp`` with ``g++`` at
    first use (into ``csrc/build/``, named by a hash of the sources and
    flags), load it and declare every entry point.  Processes that build
    at once take turns on a lock file and write through a temporary name,
    so none loads a half-written library.  A failed build raises."""
    import fcntl

    with _LOCK:
        if _HOST_LIB:
            return _HOST_LIB[0]
        path = _host_library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(os.path.join(BUILD_DIR, "host.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    tmp = f"{path}.{os.getpid()}.tmp"
                    cmd = [CXX, *GXX_FLAGS, "-o", tmp,
                           *(os.path.join(HOST_DIR, s) for s in HOST_SOURCES),
                           "-lpthread"]
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"g++ failed on the host library (exit "
                            f"{proc.returncode}): {' '.join(cmd)}\n"
                            f"{proc.stderr}")
                    os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _HOST_LIB.append(lib)
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


# ---------------------------------------------------------------------------
# launch counts, shared by every kernel wrapper
# ---------------------------------------------------------------------------

# table dtype -> the ``dtype`` code of the float kernels' C entry points:
# the fused updates (B2, B6) take FLOAT_DTYPES, the float pooled lookups
# (B1, B4) LOOKUP_DTYPES, for tables and outputs
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the fused updates' optimizer-state element types
STATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LOOKUP_DTYPES = {**FLOAT_DTYPES, torch.float16: 2}

LAUNCHES: Dict[str, int] = {
    "pooled_lookup": 0,
    "fused_sparse_update": 0,
    "quant_pooled_lookup_int8": 0,
    "dedup_quant_pooled_lookup": 0,
    "dedup_pooled_lookup": 0,
    "dedup_fused_sparse_update": 0,
}
_LAUNCH_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counts."""
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def count_launch(name: str) -> None:
    """Add one to a kernel's launch count (its wrapper calls this right
    after each launch, and nowhere else)."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
