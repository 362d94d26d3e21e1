"""What the benchmark loads: no JAX and no JAX package anywhere, and in the
reference nothing of the port. Top-level names are compared whole (the
port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(d):
    for dirpath, _, files in os.walk(d):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_sources_import_no_jax():
    for path in _sources(BENCH):
        names = set(_top_level_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "humanoid_gym_tpu"}, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "humanoid_gym_tpu_torch" not in set(_top_level_imports(path)), path


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=600)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_loaded_modules():
    harness = _loaded_after("import benchmark.run, benchmark.program, benchmark.correct, "
                            "benchmark.devtrace, benchmark.census, benchmark.reference.follow\n"
                            "import humanoid_gym_tpu_torch.registry, "
                            "humanoid_gym_tpu_torch.runner.on_policy_runner")
    assert not harness & {"jax", "jaxlib", "flax", "humanoid_gym_tpu"}
    reference = _loaded_after("import benchmark.reference.follow")
    assert not reference & {"jax", "jaxlib", "flax", "humanoid_gym_tpu", "humanoid_gym_tpu_torch"}
