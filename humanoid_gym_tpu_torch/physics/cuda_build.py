"""Build and load the port's CUDA kernels (csrc/) with nvcc and ctypes.

The sources compile into one shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`),
built at first use into `build/kernels/` at the repo root and named by a
hash of the sources, so an edited source never loads a stale build.
Every pointer and the stream pass as `ctypes.c_void_p`; each C entry returns
`cudaGetLastError()` and the caller raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from .. import HGT_ROOT_DIR

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("mega.cu", "solve.cuh")
BUILD_DIR = os.path.join(HGT_ROOT_DIR, "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelLibrary:
    """The loaded library, its build record, and the model constants last
    uploaded to its __constant__ memory."""

    def __init__(self, lib: ctypes.CDLL, path: str, build_seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.uploaded_consts: bytes | None = None
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hgt_set_model.argtypes = [vp, ci]
        lib.hgt_set_model.restype = ci
        lib.hgt_const_count.argtypes = []
        lib.hgt_const_count.restype = ci
        lib.hgt_mega_step.argtypes = [vp, vp, ci, cf, ci, ci, cf, vp]
        lib.hgt_mega_step.restype = ci
        lib.hgt_solve.argtypes = [vp] * 11 + [ci, ci, vp]
        lib.hgt_solve.restype = ci


_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build_library() -> KernelLibrary:
    """Compile (once per source hash) and load the kernel library."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libhgt_kernels_{h.hexdigest()[:16]}.so")
    log = ""
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, "mega.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, path)
    seconds = time.perf_counter() - t0
    return KernelLibrary(ctypes.CDLL(path), path, seconds, log)


def kernel_library() -> KernelLibrary:
    """The process's kernel library, built and loaded at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build_library()
    return _LIBRARY


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
