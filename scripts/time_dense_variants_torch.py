"""Time the designs that were tried and dropped for the two dense
contact-solve kernels beside the shipped one, on one card in one run.

Each variant is the shipped `csrc/dense_solve.cu` with a few lines replaced
(the replacement must apply, or the script stops); every variant is built by
its own nvcc, all started together, into `build/variants/`. Then, in two
rounds over all variants, each is held against the plain versions at 4096
envs, 8 iterations, and timed with 8 and with 0 iterations (CUDA events around
50 launches queued behind a spin kernel). The header note of
`dense_solve.cu` and PERF.md quote these lines. Needs a CUDA card and nvcc.
Run from the repo root:

    python scripts/time_dense_variants_torch.py [variant ...]
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "humanoid_gym_tpu_torch", "csrc")
HEADERS = ("apgd.cuh", "bulk_copy.cuh")
OUT = os.path.join(ROOT, "build", "variants")


def sub(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise ValueError(f"the shipped source no longer holds exactly once: {old[:70]!r}")
    return s.replace(old, new)


def between(s: str, start: str, end: str, new: str) -> str:
    return s[:s.index(start)] + new + s[s.index(end):]


def apgd_direct(s: str, small: bool = False) -> str:
    """hgt_apgd_kernel without a stage: each lane reads its two rows straight
    from device memory, 16 bytes a load; `small` also drops the stage's
    shared memory."""
    s = sub(s, "        hgt_mbarrier_wait(bar, parity);\n        parity ^= 1u;\n", "")
    s = sub(s, "reinterpret_cast<const float4*>(stage + r0 * HGT_NR);",
            "reinterpret_cast<const float4*>(A + (size_t)e * DS_A_FLOATS + r0 * HGT_NR);")
    s = sub(s, "reinterpret_cast<const float4*>(stage + (v1 ? r1 : r0) * HGT_NR);",
            "reinterpret_cast<const float4*>(A + (size_t)e * DS_A_FLOATS + (v1 ? r1 : r0) * HGT_NR);")
    s = sub(s, "const float4 f = row0[q], g = row1[q], sc",
            "const float4 f = __ldg(row0 + q), g = __ldg(row1 + q), sc")
    s = sub(s, "        if (lane == 0 && e + stride < n)\n            hgt_bulk_copy(stage, "
               "A + (size_t)(e + stride) * DS_A_FLOATS, DS_A_FLOATS * 4, bar);\n", "")
    s = sub(s, "        hgt_mbarrier_init(bar);\n        hgt_bulk_copy(stage, A + (size_t)e * "
               "DS_A_FLOATS, DS_A_FLOATS * 4, bar);\n", "")
    if small:
        for name, old, new in (("AP_SM_Y", 3600, 0), ("AP_SM_X", 3664, 64), ("AP_SM_S", 3728, 128),
                               ("AP_WARP_FLOATS", 3792, 192)):
            s = sub(s, f"#define {name} {old}", f"#define {name} {new}")
    return s


def shape(warps: int, blocks: int):
    """Another block shape / residency for both kernels."""
    def patch(s: str) -> str:
        s = sub(s, "#define DS_MIN_BLOCKS 3 ", f"#define DS_MIN_BLOCKS {blocks} ")
        s = sub(s, "#define DS_WARPS 4 ", f"#define DS_WARPS {warps} ")
        return sub(s, "#define AP_HEAD_FLOATS 8 ", f"#define AP_HEAD_FLOATS {4 * ((2 * warps + 3) // 4)} ")
    return patch


def fused_persistent(s: str) -> str:
    """hgt_fused_dense_kernel with persistent warps (grid of 132 x DS_MIN_BLOCKS)."""
    s = sub(s, "    const int e = blockIdx.x * DS_WARPS + warp;\n    if (e >= n) return;  // whole warps "
               "leave; the kernel has no block-wide barrier\n    float* sm = smem + warp * FD_WARP_FLOATS;",
            "    float* sm = smem + warp * FD_WARP_FLOATS;\n    for (int e = blockIdx.x * DS_WARPS + warp; "
            "e < n; e += gridDim.x * DS_WARPS) {")
    s = sub(s, "    if (v1) lam_out[(size_t)e * HGT_NR + r1] = lam1 * s1;\n}\n\n// Raise the kernel",
            "    if (v1) lam_out[(size_t)e * HGT_NR + r1] = lam1 * s1;\n    __syncwarp();\n    }\n}\n\n"
            "// Raise the kernel")
    return sub(s, "    const int grid = (n + DS_WARPS - 1) / DS_WARPS;\n    hgt_fused_dense_kernel<<<",
               "    int grid = (n + DS_WARPS - 1) / DS_WARPS;\n    if (grid > 132 * DS_MIN_BLOCKS) grid = "
               "132 * DS_MIN_BLOCKS;\n    hgt_fused_dense_kernel<<<")


def fused_shared_pair_table(s: str) -> str:
    """The Gram pairs' table filled into shared memory by every block at run
    time (a loop per thread and a block-wide barrier), as solve.cuh does once
    per 16 envs x 10 substeps."""
    s = sub(s, "    const int e = blockIdx.x * DS_WARPS + warp;\n    if (e >= n) return;  // whole warps "
               "leave; the kernel has no block-wide barrier\n    float* sm = smem + warp * FD_WARP_FLOATS;",
            "    unsigned char* pairs = reinterpret_cast<unsigned char*>(smem);\n"
            "    for (int t = threadIdx.x; t < hgt_npair<HgtNoZeros>(); t += blockDim.x) {\n"
            "        int p = hgt_pair<HgtNoZeros>(t);\n"
            "        pairs[2 * t] = (unsigned char)(p >> 5);\n"
            "        pairs[2 * t + 1] = (unsigned char)(p & 31);\n    }\n    __syncthreads();\n"
            "    const int e = blockIdx.x * DS_WARPS + warp;\n    if (e >= n) return;\n"
            "    float* sm = smem + 88 + warp * FD_WARP_FLOATS;")
    s = sub(s, "hgt_pair_table<HgtNoZeros>.rc, b0, b1, lane, slot);", "pairs, b0, b1, lane, slot);")
    return sub(s, "const size_t bytes = sizeof(float) * DS_WARPS * FD_WARP_FLOATS;",
               "const size_t bytes = sizeof(float) * (88 + DS_WARPS * FD_WARP_FLOATS);")


def fused_two_pass(s: str) -> str:
    """The A build row by row: all of a0, then all of a1."""
    return between(s, "#pragma unroll\n    for (int c = 0; c < HGT_NR; ++c) {\n        a0[c] =",
                   "    // ---- APGD ----",
                   "#pragma unroll\n    for (int c = 0; c < HGT_NR; ++c)\n"
                   "        a0[c] = hgt_dot18(b0, Bs + c * FD_BS) + (c == r0 ? reg : 0.0f);\n"
                   "#pragma unroll\n    for (int c = 0; c < HGT_NR; ++c)\n"
                   "        a1[c] = hgt_dot18(b1, Bs + c * FD_BS) + (c == r1 ? reg : 0.0f);\n\n")


def fused_four_sums(s: str) -> str:
    """Four partial sums per entry of A instead of two."""
    s = sub(s, "    float acc0 = 0.0f, acc1 = 0.0f;\n", "    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;\n")
    s = sub(s, "        acc0 += b[4 * q + 2] * f.z;\n        acc1 += b[4 * q + 3] * f.w;\n",
            "        acc2 += b[4 * q + 2] * f.z;\n        acc3 += b[4 * q + 3] * f.w;\n")
    return sub(s, "    return acc0 + acc1;\n", "    return (acc0 + acc1) + (acc2 + acc3);\n")


VARIANTS = {
    "shipped": lambda s: s,
    "apgd_direct_loads": apgd_direct,
    "apgd_direct_loads_small_smem": lambda s: apgd_direct(s, small=True),
    "blocks_2warps_x6": shape(2, 6),
    "blocks_6warps_x2": shape(6, 2),
    "blocks_4warps_x2_8_warps_per_sm": shape(4, 2),
    "fused_persistent": fused_persistent,
    "fused_shared_pair_table": fused_shared_pair_table,
    "fused_two_pass_a_build": fused_two_pass,
    "fused_four_partial_sums": fused_four_sums,
}


def patched_sources(names=None) -> dict:
    """name -> the variant's dense_solve.cu; raises where a replacement no
    longer applies to the shipped source."""
    with open(os.path.join(CSRC, "dense_solve.cu")) as f:
        base = f.read()
    return {name: VARIANTS[name](base) for name in (names or VARIANTS)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from humanoid_gym_tpu_torch.physics import cuda_build as CB, solve as SV
    from humanoid_gym_tpu_torch.physics.kinematics import use_full_f32_matmul

    use_full_f32_matmul()
    procs = {}
    for name, src in patched_sources(sys.argv[1:]).items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for h in HEADERS:
            with open(os.path.join(CSRC, h)) as f, open(os.path.join(d, h), "w") as g:
                g.write(f.read())
        with open(os.path.join(d, "dense_solve.cu"), "w") as g:
            g.write(src)
        cmd = [CB._nvcc(), *CB.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "dense_solve.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(f"[{name}] nvcc failed:\n{log[-3000:]}", flush=True)
            return 1
        print(f"[{name}] " + CS._ptxas_summary(log), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.hgt_apgd.argtypes, lib.hgt_apgd.restype = [vp] * 9 + [ci, ci, vp], ci
        lib.hgt_fused_dense.argtypes, lib.hgt_fused_dense.restype = [vp] * 12 + [ci, ci, vp], ci
        libs[name] = lib

    dev = torch.device("cuda")
    c = CS._setup(dev)
    n, iters = CS.N_ENVS, c.iters
    st1, tgt = CS._one_step_in(c, n)
    apgd_in = CS._apgd_operands(c, st1, tgt)
    fused_in = [t.contiguous() for t in CS._fused_operands(c, st1, tgt)]
    lam4 = torch.empty((n, 60), device=dev)
    q3, lam3 = torch.empty((n, 18), device=dev), torch.empty((n, 60), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lam4_p = SV.apgd_solve_kernel_plain(*apgd_in, iterations=iters)
    q3_p, lam3_p = SV.fused_dense_solve_plain(*fused_in, iterations=iters)

    def apgd(lib, it):
        CB.check(lib.hgt_apgd(*[t.data_ptr() for t in apgd_in], lam4.data_ptr(), n, it, stream),
                 "hgt_apgd launch")

    def fused(lib, it):
        CB.check(lib.hgt_fused_dense(*[t.data_ptr() for t in fused_in], q3.data_ptr(),
                                     lam3.data_ptr(), n, it, stream), "hgt_fused_dense launch")

    print(f"card: {CS._card_line()} | {n} envs, {iters} iterations", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            for t in (lam4, q3, lam3):
                t.fill_(float("nan"))
            apgd(lib, iters)
            fused(lib, iters)
            torch.cuda.synchronize()
            e4 = CS._maxerr(lam4, lam4_p)
            e3 = max(CS._maxerr(q3, q3_p), CS._maxerr(lam3, lam3_p))
            if not (e4 <= 2e-3 and e3 <= 5e-4):
                raise AssertionError(f"{name} disagrees with the plain versions: {e4}, {e3}")
            t4 = [CS._time_ms(lambda: apgd(lib, it), reps=50, warmup=3) for it in (iters, 0)]
            t3 = [CS._time_ms(lambda: fused(lib, it), reps=50, warmup=3) for it in (iters, 0)]
            print(f"round {rnd} [{name}] hgt_apgd_kernel {t4[0]:.4f} ms (0 iterations {t4[1]:.4f}) "
                  f"err {e4:.2e} | hgt_fused_dense_kernel {t3[0]:.4f} ms (0 iterations {t3[1]:.4f}) "
                  f"err {e3:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
