"""Build and load the port's CUDA kernels (``torchrec_tpu_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into
``torchrec_tpu_torch/csrc/build/`` (git-ignored), and loaded with
``ctypes``.  The library name carries a hash of the source and of the
``.cuh`` headers beside it, so an edited source never loads a stale
build.  Nothing here runs at import time: the
CPU tests import every module on a machine with no ``nvcc``.

Every kernel wrapper counts its launches here, in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

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
        "tbe_pooled": (_P, _P, _I, _P, _P, _I, _G, _I, _P, _I, _L, _I, _P),
        "tbe_pooled_info": (_I, _I, _I, _I, _I, _O),
    },
    "tbe_backward.cu": {
        "fused_update": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P),
        "fused_update_info": (_I, _I, _I, _I, _O),
    },
    "tbe_dedup.cu": {
        "dedup_pooled": (_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _P),
    },
    "tbe_dedup_backward.cu": {
        "dedup_fused_update": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I,
                               _I, _I, _P),
        "dedup_fused_update_info": (_I, _I, _I, _I, _O),
    },
}
SOURCES = tuple(_SIGNATURES)

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


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def load_libraries(sources: Sequence[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile the ``csrc/`` sources that have no current build, one
    ``nvcc`` per source, all started together, then load each library with
    every entry point's ``argtypes``/``restype`` declared.  Returns
    source -> library; raises after every build has ended if one
    failed."""
    with _LOCK:
        todo = [s for s in sources if s not in _LIBS]
        paths = {s: _library_path(s) for s in todo}
        missing = [s for s in todo if not os.path.exists(paths[s])]
        for s in todo:
            if s not in missing:
                BUILD_INFO[s] = {"seconds": 0.0, "log": ""}
        if missing:
            nvcc = _nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
        builds = {}
        for s in missing:
            tmp = f"{paths[s]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, s)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            builds[s] = (proc, tmp, time.perf_counter())
        failed = []
        for s, (proc, tmp, t0) in builds.items():
            log, _ = proc.communicate()
            BUILD_INFO[s] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {s} (exit {proc.returncode}):"
                              f"\n{log}")
            else:
                os.replace(tmp, paths[s])
        if failed:
            raise RuntimeError("\n".join(failed))
        for s in todo:
            lib = ctypes.CDLL(paths[s])
            for name, argtypes in _SIGNATURES[s].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[s] = lib
        return {s: _LIBS[s] for s in sources}


def load_library(source: str) -> ctypes.CDLL:
    """:func:`load_libraries` for one source."""
    return load_libraries((source,))[source]


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


# ---------------------------------------------------------------------------
# launch counts, shared by every kernel wrapper
# ---------------------------------------------------------------------------

# table dtype -> the ``dtype`` code of the float kernels' C entry points
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
