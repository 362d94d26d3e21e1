"""Instruction census of the mega kernel's machine code (SASS), by opcode and
by source line.

The counterpart of scripts/kernel_census.py, which counts the leaf jaxpr
equations of one substep of the TPU kernel in interpret mode. The port
counts the SASS of the kernel that runs: `csrc/mega.cu` is compiled to a
cubin for sm_90a with the production flags of physics/cuda_build.py plus
`-lineinfo` and disassembled with the toolkit's `nvdisasm
--print-line-info-inline`; each instruction of `hgt_mega_kernel<false>` (B1)
or `<true>` (B1t) is attributed to its innermost `file:line` of the
kernel's sources (the solve in `solve.cuh` and the warp helpers in
`apgd.cuh` are inlined into the kernel; a shuffle that the toolkit's header
inlines goes to the kernel line that calls it, and the per-file totals also
name the header). The count must equal that of the same function in the production
library (`cuobjdump -sass` of the library the port loads), which shows the
census reads the kernel that runs. The census is static: a loop body
counts once, however often it runs.

The parsers take the tools' text, so the tests feed them fixtures. Needs
the CUDA toolkit (`nvcc`, `nvdisasm`, `cuobjdump`): the GPU machine.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from collections import Counter

from .cuda_build import CSRC_DIR, NVCC_FLAGS, _nvcc, kernel_library
from .mega_sass import cuobjdump_sass, mega_kernel_name, sass_functions

# the kernel's sources: an instruction attributed to a line of one of these
# counts as attributed
KERNEL_FILES = ("mega.cu", "solve.cuh", "apgd.cuh")

_SECTION = re.compile(r"^//-+ (\S+)\s+-+\s*$")
_TEXT_LABEL = re.compile(r"^\.text\.(\S+):\s*$")
_LINE_INFO = re.compile(r'^\s*//## File "([^"]+)", line (\d+)')
_INSTR = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;?\s*$")


def parse_nvdisasm(text: str) -> dict[str, list[tuple[str, str, str]]]:
    """Each function of `nvdisasm --print-line-info-inline` output: its
    instructions in order as (instruction, innermost "file:line", innermost
    "file:line" of the kernel's sources), files by base name, "?" where
    there is none. A run of `//## File` comments before an instruction
    names the innermost location first, then the call sites it was inlined
    into, outward; each instruction keeps the locations of the last run
    before it. An instruction inlined from a toolkit header (a shuffle of
    sm_30_intrinsics.hpp) thus has that header as its innermost location and
    the kernel line that calls it as its kernel location."""
    funcs: dict[str, list[tuple[str, str, str]]] = {}
    name, chain, in_run = None, [], False
    for ln in text.splitlines():
        if _SECTION.match(ln):
            name = None
            continue
        m = _TEXT_LABEL.match(ln)
        if m:
            name, chain, in_run = m.group(1), [], False
            funcs[name] = []
            continue
        if name is None:
            continue
        m = _LINE_INFO.match(ln)
        if m:
            if not in_run:
                chain = []
            chain.append(f"{os.path.basename(m.group(1))}:{m.group(2)}")
            in_run = True
            continue
        in_run = False
        m = _INSTR.match(ln)
        if m and m.group(1):
            own = [w for w in chain if w.rsplit(":", 1)[0] in KERNEL_FILES]
            funcs[name].append((m.group(1), chain[0] if chain else "?", own[0] if own else "?"))
    return funcs


def opcode(instruction: str) -> str:
    """The opcode of a SASS instruction, predicate and modifiers stripped:
    `@!P0 BRA ...` -> `BRA`, `FFMA.FTZ R1, ...` -> `FFMA`, `LDS.U.128` -> `LDS`."""
    words = instruction.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else "?"


def summarise(instrs: list[tuple[str, str, str]], opcodes: int = 12, lines: int = 20) -> dict:
    """Totals of one function's `parse_nvdisasm` list: the count, the top
    opcodes, the top lines of the kernel's sources, the count per file of
    the kernel's sources and per innermost file (toolkit headers
    included), and the share of instructions attributed to a line of the
    kernel's sources."""
    by_op = Counter(opcode(i) for i, _, _ in instrs)
    by_line = Counter(k for _, _, k in instrs)
    attributed = len(instrs) - by_line.get("?", 0)
    return {
        "instructions": len(instrs),
        "attributed_share": attributed / len(instrs) if instrs else 0.0,
        "top_opcodes": by_op.most_common(opcodes),
        "top_lines": by_line.most_common(lines),
        "per_file": dict(Counter(k.rsplit(":", 1)[0] for _, _, k in instrs).most_common()),
        "per_innermost_file": dict(Counter(w.rsplit(":", 1)[0] for _, w, _ in instrs).most_common()),
    }


def _lineinfo_cubin(out: str) -> subprocess.Popen:
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_nvcc(), *flags, "-cubin", "-lineinfo", "-o", out, os.path.join(CSRC_DIR, "mega.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def mega_census(opcodes: int = 12, lines: int = 20) -> dict:
    """The census of both mega kernels: {"flat": ..., "terrain": ...}, each
    `summarise`'s dict plus its mangled name and the instruction count of
    the same function in the production library (`production_instructions`)."""
    nvdisasm = os.path.join(os.path.dirname(_nvcc()), "nvdisasm")
    with tempfile.TemporaryDirectory(prefix="hgt_census_") as tmp:
        cubin = os.path.join(tmp, "mega_lineinfo.cubin")
        proc = _lineinfo_cubin(cubin)
        production = sass_functions(cuobjdump_sass(kernel_library().paths["mega"]))
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -lineinfo failed on mega.cu:\n{log}")
        text = subprocess.run([nvdisasm, "--print-line-info-inline", cubin],
                              capture_output=True, text=True, check=True).stdout
    funcs = parse_nvdisasm(text)
    out = {}
    for key, terrain in (("flat", False), ("terrain", True)):
        name = mega_kernel_name(funcs, terrain)
        out[key] = dict(summarise(funcs[name], opcodes, lines), function=name,
                        production_instructions=len(production[mega_kernel_name(production, terrain)]))
    return out
