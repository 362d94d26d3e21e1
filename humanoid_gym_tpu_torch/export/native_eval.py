"""Python front end of the native (C++) batch sim2sim evaluator.

Port of humanoid_gym_tpu/export/native_eval.py. It compiles the repo's
`native/sim2sim_eval.cpp` with the flags of `native/Makefile` (linking the
libmujoco inside the `mujoco` Python package) into
`build/native/hgt_sim2sim_eval`, and runs parallel MuJoCo rollouts of an
exported `policy.bin`: the eval farm (~40x the single-threaded Python
sim2sim loop). It writes nothing under `native/`; the build goes to a
temporary file that is renamed into place, so concurrent callers never see
a half-written binary. MuJoCo runs on the host's CPU.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile
from typing import List, Optional

from .. import HGT_ROOT_DIR

SOURCE = os.path.join(HGT_ROOT_DIR, "native", "sim2sim_eval.cpp")
BINARY = os.path.join(HGT_ROOT_DIR, "build", "native", "hgt_sim2sim_eval")
# native/Makefile: CXXFLAGS ?= -O2 -std=c++17 -Wall -pthread
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-pthread")


def _mujoco_paths():
    """(package dir, its libmujoco.so.*) of the installed `mujoco` package."""
    import glob

    import mujoco

    pkg = os.path.dirname(mujoco.__file__)
    libs = sorted(glob.glob(os.path.join(pkg, "libmujoco.so.*")))
    if not libs:
        raise FileNotFoundError(f"no libmujoco.so.* in {pkg}")
    return pkg, libs


def ensure_built() -> str:
    """Compile the evaluator unless a binary newer than its source exists;
    returns its path."""
    if os.path.exists(BINARY) and os.path.getmtime(BINARY) >= os.path.getmtime(SOURCE):
        return BINARY
    pkg, libs = _mujoco_paths()
    os.makedirs(os.path.dirname(BINARY), exist_ok=True)
    tmp = f"{BINARY}.tmp{os.getpid()}"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, f"-I{pkg}/include", "-o", tmp, SOURCE,
           *libs, f"-Wl,-rpath,{pkg}"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the native evaluator failed:\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, BINARY)
    return BINARY


def _mujoco3_compat_xml(model_path: str) -> str:
    """Write a MuJoCo-3.x-compatible copy of a 2.3-era MJCF (same fixes as
    export/sim2sim.py:_load_mj_model) and return its path."""
    xml = open(model_path).read()
    xml = re.sub(r'\s*sensornoise="[^"]*"', "", xml)
    xml = re.sub(r"\s*iterations='[^']*'", "", xml)
    m = re.search(r'meshdir="([^"]*)"', xml)
    if m:
        absdir = os.path.normpath(
            os.path.join(os.path.dirname(os.path.abspath(model_path)), m.group(1))
        )
        xml = xml.replace(m.group(0), f'meshdir="{absdir}"')
    fd, out = tempfile.mkstemp(suffix=".xml")
    with os.fdopen(fd, "w") as f:
        f.write(xml)
    return out


def run_eval_farm(
    model_path: str,
    policy_bin: str,
    rollouts: int = 8,
    duration: float = 10.0,
    threads: Optional[int] = None,
    vx: float = 0.4,
    vy: float = 0.0,
    dyaw: float = 0.0,
    seed: int = 0,
) -> dict:
    """Returns {"rollouts": [...], "summary": {...}}."""
    binary = ensure_built()
    xml = _mujoco3_compat_xml(model_path)
    cmd = [
        binary,
        "--model", xml,
        "--policy", policy_bin,
        "--rollouts", str(rollouts),
        "--duration", str(duration),
        "--vx", str(vx),
        "--vy", str(vy),
        "--dyaw", str(dyaw),
        "--seed", str(seed),
    ]
    if threads:
        cmd += ["--threads", str(threads)]
    try:
        out = subprocess.run(cmd, check=True, capture_output=True, text=True)
    finally:
        os.unlink(xml)
    rolls: List[dict] = []
    summary = {}
    for line in out.stdout.splitlines():
        rec = json.loads(line)
        if rec.get("summary"):
            summary = rec
        else:
            rolls.append(rec)
    return {"rollouts": rolls, "summary": summary}
