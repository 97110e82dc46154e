"""Build and load the port's CUDA kernels (``torchrec_tpu_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into
``torchrec_tpu_torch/csrc/build/`` (git-ignored), and loaded with
``ctypes``.  The library name carries a hash of the source, so an edited
source never loads a stale build.  Nothing here runs at import time: the
CPU tests import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

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
# C entry points per source: name -> argtypes (every pointer and the
# stream are c_void_p, every size a c_int; each returns cudaGetLastError())
_SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "tbe_quant.cu": {
        "tbe_q8_pooled": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
        "dedup_q_gather": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "dedup_pool": (_P, _P, _P, _P, _P, _I, _I, _P),
    },
}

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


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and return the loaded library
    with every entry point's ``argtypes``/``restype`` declared."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        stem = os.path.splitext(source)[0]
        so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        info: Dict[str, object] = {"seconds": 0.0, "log": ""}
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True, check=False,
            )
            info = {
                "seconds": time.perf_counter() - t0,
                "log": proc.stdout + proc.stderr,
            }
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{info['log']}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        BUILD_INFO[source] = info
        _LIBS[source] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
