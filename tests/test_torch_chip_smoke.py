"""chip_smoke.py's parts that need no card: its refusal to run without one,
the operation counts behind the kernels' bounds, and the keys of the
per-kernel records."""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [(), ("--kernels-only",)], ids=["all-phases", "kernels-only"])
def test_without_a_card_exits_nonzero_and_prints_no_result(args):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = subprocess.run([sys.executable, SCRIPT, *args], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode not in (0, None)
    assert run.stdout.strip() == ""
    assert "CUDA card" in run.stderr


def test_operation_counts_behind_the_bounds(smoke):
    """The bounds count the function's work, not the kernels' loop nests:
    linear in substeps and iterations, the executed counts never below
    them, and the figures the kernel table quotes for 10 substeps of 8
    iterations."""
    per_iter = smoke.solve_ops(9) - smoke.solve_ops(8)
    assert per_iter > 0 and smoke.solve_ops(8) - smoke.solve_ops(0) == 8 * per_iter
    per_sub = smoke.mega_ops(2, 8) - smoke.mega_ops(1, 8)
    assert smoke.mega_ops(10, 8) == smoke.mega_ops(0, 8) + 10 * per_sub
    assert per_sub > smoke.solve_ops(8)
    assert 9.0e5 < smoke.mega_ops(10, 8) < 1.0e6
    assert smoke.solve_ops_executed(8) >= smoke.solve_ops(8)
    assert smoke.mega_ops_executed(10, 8) >= smoke.mega_ops(10, 8)
    assert smoke.fused_dense_ops(8) == 181554
    # executed: A in full (each lane two whole rows), the Gram matrix by its 171 pairs
    assert smoke.fused_dense_ops(8, executed=True) == 263787 - (18 * 18 - 171) * (2 * 60 + 1)
    t, by = smoke._bound_ms(4096 * 4 * 256, 4096 * smoke.mega_ops(10, 8))
    assert by == "operations" and abs(t - 0.05906) < 1e-4
    # the terrain variant: the flat launch's work plus the terrain work,
    # linear in substeps, a few percent more; still bound by operations
    extra = smoke.mega_terrain_ops(10, 8) - smoke.mega_ops(10, 8)
    assert 0.01 * smoke.mega_ops(10, 8) < extra < 0.05 * smoke.mega_ops(10, 8)
    per_sub_t = smoke.mega_terrain_ops(2, 8) - smoke.mega_terrain_ops(1, 8)
    assert smoke.mega_terrain_ops(10, 8) == smoke.mega_terrain_ops(0, 8) + 10 * per_sub_t
    t, by = smoke._bound_ms(4096 * 4 * (120 + 208 + 136), 4096 * smoke.mega_terrain_ops(10, 8))
    assert by == "operations" and t > 0.05906


def test_kernel_records_hold_only_measured_keys_and_the_bound():
    """Every `records[...] = dict(...)` of the script carries the contract's
    keys and no other: what the run measured, plus `bound_ms` / `bound_by`."""
    allowed = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"}
    tree = ast.parse(open(SCRIPT).read(), filename=SCRIPT)
    found = 0
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "records"):
            continue
        call = node.value
        assert isinstance(call, ast.Call) and getattr(call.func, "id", None) == "dict"
        assert {k.arg for k in call.keywords} == allowed, ast.unparse(node.targets[0])
        found += 1
    assert found == 5


def test_dense_variant_patches_apply_to_the_shipped_source():
    """scripts/time_dense_variants_torch.py rebuilds the designs that were
    tried and dropped by replacing lines of csrc/dense_solve.cu: every
    replacement still applies, and each variant differs from the shipped
    source."""
    path = os.path.join(ROOT, "scripts", "time_dense_variants_torch.py")
    spec = importlib.util.spec_from_file_location("dense_variants_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sources = mod.patched_sources()
    shipped = open(os.path.join(mod.CSRC, "dense_solve.cu")).read()
    assert sources["shipped"] == shipped and len(sources) >= 8
    others = [src for name, src in sources.items() if name != "shipped"]
    assert all(src != shipped for src in others) and len(set(others)) == len(others)
    for header in mod.HEADERS:
        assert os.path.exists(os.path.join(mod.CSRC, header))


def test_kernels_line_has_the_terrain_variant():
    """The `kernels` line lists five kernels, the terrain variant among them
    with the TPU kernel it replaces, and its launches come from phase 9."""
    src = open(SCRIPT).read()
    assert src.count('route="cuda"') == 5
    assert 'replaces="humanoid_gym_tpu/physics/mega_kernel.py:560"' in src
    assert 'launches=launches_terrain["mega_terrain"]' in src
    assert "_phase4t_mega_terrain(c, records)" in src and "_phase9_terrain_path(card)" in src


def test_ptxas_summary_names_both_instantiations(smoke):
    """ptxas names the two instantiations of hgt_mega_kernel by their
    mangled template arguments; the summary tells them apart."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z15hgt_mega_kernelILb0EEvPKfS1_Pfiffiif9MgTerrain' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _Z15hgt_mega_kernelILb0EEv",
        "    112 bytes stack frame, 108 bytes spill stores, 108 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 416 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z15hgt_mega_kernelILb1EEvPKfS1_Pfiffiif9MgTerrain' "
        "for 'sm_90a'",
        "    200 bytes stack frame, 190 bytes spill stores, 190 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 416 bytes cmem[0]",
    ])
    out = smoke._ptxas_summary(log)
    assert "hgt_mega_kernel<false>: Used 64 registers" in out and "112 bytes stack" in out
    assert "hgt_mega_kernel<true>: Used 64 registers" in out and "200 bytes stack" in out
