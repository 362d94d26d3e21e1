"""Build and load the port's CUDA kernels (csrc/) with nvcc and ctypes.

Each `.cu` source compiles into its own shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`), all compilers started together, at first use into `build/kernels/`
at the repo root; a library is named by a hash of its sources, so an edited
source never loads a stale build.
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
# library name -> (the .cu to compile, the headers it includes)
SOURCES = {
    "mega": ("mega.cu", "solve.cuh", "apgd.cuh"),
    "dense": ("dense_solve.cu", "apgd.cuh", "bulk_copy.cuh"),
    "stamp": ("stamp.cu",),
    "patches": ("terrain_patches.cu",),
    "rewards": ("rewards.cu",),
}
BUILD_DIR = os.path.join(HGT_ROOT_DIR, "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelLibrary:
    """The loaded libraries (`lib`: mega.cu, `dense`: dense_solve.cu,
    `stamp`: stamp.cu, `patches`: terrain_patches.cu, `rewards`: rewards.cu)
    and their build record."""

    def __init__(self, lib: ctypes.CDLL, dense: ctypes.CDLL, stamp: ctypes.CDLL,
                 patches: ctypes.CDLL, rewards: ctypes.CDLL, paths: dict, build_seconds: float,
                 log: str):
        self.lib = lib
        self.dense = dense
        self.stamp = stamp
        self.patches = patches
        self.rewards = rewards
        self.paths = paths
        self.build_seconds = build_seconds
        self.log = log
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hgt_const_count.argtypes = []
        lib.hgt_const_count.restype = ci
        lib.hgt_mega_step.argtypes = [vp, vp, vp, ci, cf, ci, ci, cf, vp]
        lib.hgt_mega_step.restype = ci
        lib.hgt_mega_step_terrain.argtypes = [vp, vp, vp, vp, ci, cf, ci, ci, cf, cf, cf, cf, cf,
                                              vp]
        lib.hgt_mega_step_terrain.restype = ci
        lib.hgt_solve.argtypes = [vp] * 11 + [ci, ci, vp]
        lib.hgt_solve.restype = ci
        dense.hgt_apgd.argtypes = [vp] * 9 + [ci, ci, vp]
        dense.hgt_apgd.restype = ci
        dense.hgt_fused_dense.argtypes = [vp] * 12 + [ci, ci, vp]
        dense.hgt_fused_dense.restype = ci
        stamp.hgt_stamp_launch.argtypes = [vp, ci, vp]
        stamp.hgt_stamp_launch.restype = ci
        patches.hgt_terrain_patches.argtypes = [vp, ci, vp, ci, vp, vp, ci, ci, cf, cf, cf, cf,
                                                vp, ci, vp]
        patches.hgt_terrain_patches.restype = ci
        rewards.hgt_rewards.argtypes = [vp, vp, vp, vp, ci, vp]
        rewards.hgt_rewards.restype = ci


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
    """Compile (once per source hash, one nvcc per library, all running at
    the same time) and load the kernel libraries."""
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for name, files in SOURCES.items():
        h = hashlib.sha256()
        for fname in files:
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(f.read())
        paths[name] = os.path.join(BUILD_DIR, f"libhgt_{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(paths[name]):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{paths[name]}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, files[0])]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    log, failed = "", []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name][0]} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    return KernelLibrary(ctypes.CDLL(paths["mega"]), ctypes.CDLL(paths["dense"]),
                         ctypes.CDLL(paths["stamp"]), ctypes.CDLL(paths["patches"]),
                         ctypes.CDLL(paths["rewards"]), paths, seconds, log)


def kernel_library() -> KernelLibrary:
    """The process's kernel library, built and loaded at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build_library()
    return _LIBRARY


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
