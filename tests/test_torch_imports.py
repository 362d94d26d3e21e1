"""The PyTorch port, its scripts (scripts/*_torch.py), its examples (examples/*_torch.py) and
chip_smoke.py import no JAX, no flax, no optax and nothing of the JAX package. The scan reads each source's import statements
with `ast` (a substring match would trip on humanoid_gym_tpu_torch)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "humanoid_gym_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "humanoid_gym_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for sub in ("scripts", "examples"):
        out += [os.path.join(ROOT, sub, f) for f in sorted(os.listdir(os.path.join(ROOT, sub)))
                if f.endswith("_torch.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_scan_covers_the_port():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names
    assert "scripts/train_torch.py" in names
    assert "humanoid_gym_tpu_torch/runner/on_policy_runner.py" in names
    assert "humanoid_gym_tpu_torch/physics/mega.py" in names
    for f in ("__init__.py", "primitives.py", "terrain.py"):
        assert f"humanoid_gym_tpu_torch/terrain/{f}" in names
    for f in ("export/__init__.py", "export/policy_export.py", "envs/joint.py", "config/xbots.py",
              "utils/scale_urdf.py"):
        assert f"humanoid_gym_tpu_torch/{f}" in names
    for f in ("export/sim2sim.py", "export/video.py", "export/live_viewer.py",
              "export/native_eval.py", "physics/mjcf_export.py", "utils/play_logger.py",
              "utils/calculate_gait.py", "utils/roofline.py"):
        assert f"humanoid_gym_tpu_torch/{f}" in names
    for f in ("play", "sim2sim", "view", "eval_hfield", "robustness_curve", "gen_xbots_mjcf",
              "plot_curves", "learn_profile", "kernel_census", "scaling_bench", "config4_dryrun",
              "roofline"):
        assert f"scripts/{f}_torch.py" in names
    for f in ("utils/platform.py", "physics/sass_census.py", "physics/mega_sass.py"):
        assert f"humanoid_gym_tpu_torch/{f}" in names
    assert "examples/minimal_train_loop_torch.py" in names
    assert len(names) > 15


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import humanoid_gym_tpu_torch.physics\nfrom humanoid_gym_tpu.physics import step\n")
    found = [m for m in _imported_modules(str(p)) if m.split(".")[0] in FORBIDDEN]
    assert found == ["humanoid_gym_tpu.physics"]
