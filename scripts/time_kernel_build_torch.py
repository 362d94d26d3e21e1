"""Time the nvcc build of the port's CUDA kernels three ways.

  1. each `.cu` of `cuda_build.SOURCES` alone, one after the other;
  2. one nvcc call that compiles every `.cu` into a single library;
  3. one nvcc per `.cu`, all started together (what `cuda_build` does).

Prints one line per build and a JSON summary. Needs nvcc (the CUDA
toolkit), no card. Run from the repo root:

    python scripts/time_kernel_build_torch.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from humanoid_gym_tpu_torch.physics import cuda_build as CB  # noqa: E402


def _run(cmds):
    """Start every command, wait for all; seconds until the last one ended."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    seconds = time.perf_counter() - t0
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            print(f"nvcc failed ({p.returncode}):\n{out[-2000:]}", flush=True)
    return seconds, all(p.returncode == 0 for p in procs)


def main() -> int:
    nvcc = CB._nvcc()
    flags = [f for f in CB.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    srcs = {name: os.path.join(CB.CSRC_DIR, files[0]) for name, files in CB.SOURCES.items()}
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        cmd = lambda out, *cu: [nvcc, *flags, "-o", os.path.join(tmp, out), *cu]  # noqa: E731
        for name, cu in srcs.items():
            s, ok = _run([cmd(f"alone_{name}.so", cu)])
            result[f"alone_{name}_s"] = s if ok else None
            print(f"{os.path.basename(cu)} alone: {s:.1f} s (ok {ok})", flush=True)
        s, ok = _run([cmd("single.so", *srcs.values())])
        result["one_call_one_library_s"] = s if ok else None
        print(f"one nvcc call, one library: {s:.1f} s (ok {ok})", flush=True)
        s, ok = _run([cmd(f"par_{name}.so", cu) for name, cu in srcs.items()])
        result["parallel_one_library_each_s"] = s if ok else None
        print(f"one nvcc per source, started together: {s:.1f} s (ok {ok})", flush=True)
    result["cpu_count"] = os.cpu_count()
    print(json.dumps({"kernel_build_seconds": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
