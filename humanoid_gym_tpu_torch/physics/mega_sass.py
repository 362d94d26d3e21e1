"""Hold the flat mega kernel's machine code against another source tree's.

    python -m humanoid_gym_tpu_torch.physics.mega_sass --base <dir>

`<dir>` holds another version's `mega.cu`, `solve.cuh` and `apgd.cuh` (for
example `git archive <commit> humanoid_gym_tpu_torch/csrc` unpacked there).
Both `mega.cu` are compiled for sm_90a to cubins (`nvcc -cubin -Xptxas -v`,
the flags of physics/cuda_build.py), both nvcc started together, and dumped
with `cuobjdump -sass`. The flat kernel of each (a function named
`hgt_mega_kernel`, the `<false>` instance where the source is a template) is
compared instruction by instruction with addresses and encodings stripped.
Prints both ptxas lines, the instruction counts, the number of
instructions that differ at the same position, and an aligned diff
(`difflib`): how many instructions the two share in matching runs and each
run that one side replaces, inserts or deletes, so that a change confined
to one place (a different load of the model constants) reads as that.
Needs the CUDA toolkit (the GPU machine).
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile

from .cuda_build import CSRC_DIR, _nvcc


def _cubin(src_dir: str, out: str) -> subprocess.Popen:
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
           "-Xptxas", "-v", "-o", out, os.path.join(src_dir, "mega.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sass_functions(dump: str) -> dict[str, list[str]]:
    """Each function of `cuobjdump -sass` output: its instructions,
    addresses and encodings stripped."""
    funcs, name = {}, None
    for ln in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            ins = re.sub(r"/\*[^*]*\*/", "", ln).strip()
            if ins and not ins.startswith(".") and ins != "{" and ins != "}":
                funcs[name].append(ins)
    return funcs


def mega_kernel_name(names, terrain: bool = False) -> str:
    """The one function of `names` that is the flat (`hgt_mega_kernel<false>`,
    or a plain `hgt_mega_kernel`) or the terrain (`<true>`: `ILb1E` in the
    mangled name) mega kernel."""
    found = [f for f in names if "hgt_mega_kernel" in f and ("ILb1E" in f) == terrain]
    if len(found) != 1:
        kind = "terrain" if terrain else "flat"
        raise RuntimeError(f"expected one {kind} hgt_mega_kernel, found {found}")
    return found[0]


def cuobjdump_sass(binary: str) -> str:
    """`cuobjdump -sass` of a cubin or of a shared library holding one."""
    return subprocess.run([os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", binary],
                          capture_output=True, text=True, check=True).stdout


def flat_kernel_sass(cubin: str) -> list[str]:
    """The flat mega kernel's instructions, addresses and encodings stripped."""
    funcs = sass_functions(cuobjdump_sass(cubin))
    return funcs[mega_kernel_name(funcs)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, help="directory with the other mega.cu and headers")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="hgt_sass_") as tmp:
        runs = {"base": (args.base, os.path.join(tmp, "base.cubin")),
                "here": (CSRC_DIR, os.path.join(tmp, "here.cubin"))}
        procs = {k: _cubin(src, out) for k, (src, out) in runs.items()}
        sass = {}
        for k, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {runs[k][0]}:\n{log}")
            lines = [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
                     if "registers" in ln or "stack frame" in ln]
            print(f"{k}: {' | '.join(lines)}")
            sass[k] = flat_kernel_sass(runs[k][1])
    a, b = sass["base"], sass["here"]
    differ = sum(1 for x, y in zip(a, b) if x != y) + abs(len(a) - len(b))
    print(f"flat hgt_mega_kernel: {len(a)} instructions in the base, {len(b)} here; "
          f"{differ} differ" + (" (identical)" if differ == 0 else ""))
    if differ:
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                print(f"first difference at instruction {i}: base `{x}` here `{y}`")
                break
        ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
        same = sum(i2 - i1 for tag, i1, i2, _, _ in ops if tag == "equal")
        edits = [op for op in ops if op[0] != "equal"]
        print(f"aligned: {same} instructions in matching runs, {len(edits)} edits "
              f"({sum(i2 - i1 for _, i1, i2, _, _ in edits)} base instructions replaced or deleted, "
              f"{sum(j2 - j1 for _, _, _, j1, j2 in edits)} instructions here replaced or inserted)")
        for tag, i1, i2, j1, j2 in edits[:12]:
            print(f"  {tag} base[{i1}:{i2}] -> here[{j1}:{j2}]: "
                  f"{' ; '.join(a[i1:i2][:3])} -> {' ; '.join(b[j1:j2][:3])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
