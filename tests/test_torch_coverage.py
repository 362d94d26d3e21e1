"""The port's coverage of the JAX package, read from both packages' sources.

Every module of `humanoid_gym_tpu/` has its counterpart file in
`humanoid_gym_tpu_torch/`, every public top-level name of it has a
counterpart (the same name, or a declared move, rename or non-port, each
with its reason), every script, example and root program has its `_torch`
counterpart, both registries hold the same tasks (the port's own tasks
declared in PORT_ONLY_TASKS, each with its reason), and every Pallas kernel of
the JAX package has its hand-written CUDA kernel, named in chip_smoke.py's
`kernels` line with a pointer into the function it replaces and in
PERF.md's kernel table.

The sources are read as text with `ast`: nothing of JAX or of the JAX
package is imported. The self-tests at the end run the checks on altered
copies to show that each one fails when the coverage it holds is broken.
"""

import ast
import os
import re
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "humanoid_gym_tpu")
PORT_PKG = os.path.join(ROOT, "humanoid_gym_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
PERF = os.path.join(ROOT, "PERF.md")

# JAX module -> the port module that holds its counterparts, where the paths differ
MODULE_MAP = {
    "physics/pallas_solver.py": "physics/solve.py",
    "physics/mega_kernel.py": "physics/mega.py",
}

# (JAX module, name) -> (port module, reason): the name lives under the same name elsewhere
MOVED = {
    ("physics/step.py", "pd_torques"): (
        "physics/mega.py", "the mega path's plain step and the substep path share one PD law"),
}

# (JAX module, name) -> (port module, target, reason); a target with a "/" is a
# directory the port module builds into
RENAMED = {
    ("physics/kinematics.py", "f32_matmul"): (
        "physics/kinematics.py", "use_full_f32_matmul", "sets torch's float32 matmul precision"),
    ("utils/platform.py", "apply_platform_env"): (
        "utils/platform.py", "resolve_device", "a device argument replaces JAX_PLATFORMS"),
    ("utils/roofline.py", "HBM_BW"): (
        "utils/roofline.py", "PEAK_BYTES_PER_S", "the H100's HBM rate, not the TPU's"),
    ("utils/roofline.py", "MXU_BF16_PEAK"): (
        "utils/roofline.py", "PEAK_BF16_FLOPS", "the H100's bf16 tensor-core peak"),
    ("utils/roofline.py", "VPU_F32_PEAK"): (
        "utils/roofline.py", "PEAK_F32_FLOPS", "the H100's float32 peak outside the tensor cores"),
    ("utils/roofline.py", "physics_vregs_per_step"): (
        "utils/roofline.py", "physics_issue_per_step", "warp issue slots instead of TPU vregs"),
    ("export/native_eval.py", "NATIVE_DIR"): (
        "export/native_eval.py", "build/native", "the evaluator builds under build/, not native/"),
    ("physics/mega_kernel.py", "make_contact_xy_batched"): (
        "physics/mega.py", "make_contact_xy", "XLA code, not Pallas: batched by torch itself"),
    ("physics/pallas_solver.py", "apgd_solve_pallas"): (
        "physics/solve.py", "apgd_solve_kernel", "the Hopper kernel's wrapper (B4)"),
    ("physics/pallas_solver.py", "fused_solve_pallas"): (
        "physics/solve.py", "fused_dense_solve", "the Hopper kernel's wrapper (B3)"),
    ("physics/pallas_solver.py", "make_apgd_batched"): (
        "physics/solve.py", "apgd_solve_kernel", "the wrapper takes the batch: no vmap rule"),
    ("physics/pallas_solver.py", "make_fused_batched"): (
        "physics/solve.py", "fused_dense_solve", "the wrapper takes the batch: no vmap rule"),
}

# (JAX module, names, reason): names the port does without
NOT_PORTED = [
    ("terrain/terrain.py", ("make_tile_gather", "make_tile_height_fn"),
     "the TPU's one-hot row-gather layout; the port gathers directly"),
    ("parallel/mesh.py", ("make_env_mesh", "env_sharding", "replicated_sharding",
                          "shard_env_axis"),
     "GSPMD sharding: a rank's tensors are its shard"),
    ("parallel/multihost.py", ("assemble_global", "local_env_shard", "host_sharded_env_state"),
     "GSPMD global arrays: a rank's tensors are its shard"),
    ("physics/pallas_solver.py", ("set_solver_mesh", "get_solver_mesh"),
     "the solver's shard_map mesh; a CUDA launch takes the rank's rows"),
    ("physics/pallas_solver.py", ("ENV_TILE", "NVP"),
     "TPU tile padding of the env and velocity axes"),
    ("physics/mega_kernel.py", ("C_COFF", "C_INERTIA", "C_JDAMP", "C_JFRIC", "C_KD", "C_KP",
                                "C_LOW", "C_MASS", "C_ROWS", "C_TLIM", "C_UP", "C_VLIM", "LS",
                                "TILE_ENVS"),
     "the TPU kernel's constant slab and tile; the CUDA kernel takes a packed constant blob"),
    ("physics/mega_kernel.py", ("v3", "v_add", "v_sub", "v_scale", "v_dot", "v_cross", "m_vec",
                                "mT_vec", "m_mul", "m_transpose", "sym_add", "sym_vec",
                                "sym_from_m3", "const_v3", "const_m3", "const_v3_pair",
                                "const_m3_pair", "unpair", "unpair_v3", "unpair_m3"),
     "vreg helpers over (8, 128) tiles; a warp keeps an env in shared memory"),
]

# tasks the port registers and the JAX package does not -> the reason
PORT_ONLY_TASKS = {
    "humanoid_ppo_lstm": "rsl_rl's recurrent actor-critic; the JAX package has no recurrent policy",
}

# each Pallas kernel body -> its Hopper kernel; `smoke` is the first word of
# its entry's name in chip_smoke.py's kernels line
KERNELS = {
    "B1": dict(jax=("physics/mega_kernel.py", "_build_mega_kernel"),
               cuda=("csrc/mega.cu", "hgt_mega_kernel", "__global__"),
               smoke="hgt_mega_kernel", perf="hgt_mega_kernel<false>"),
    "B1t": dict(jax=("physics/mega_kernel.py", "_build_mega_kernel"),
                cuda=("csrc/mega.cu", "hgt_mega_kernel", "__global__"),
                smoke="hgt_mega_kernel<true>", perf="hgt_mega_kernel<true>"),
    "B2": dict(jax=("physics/pallas_solver.py", "_fused_core_opt"),
               cuda=("csrc/solve.cuh", "hgt_solve_env", "__device__"),
               smoke="hgt_solve_env", perf="hgt_solve_env"),
    "B3": dict(jax=("physics/pallas_solver.py", "_fused_kernel"),
               cuda=("csrc/dense_solve.cu", "hgt_fused_dense_kernel", "__global__"),
               smoke="hgt_fused_dense_kernel", perf="hgt_fused_dense_kernel"),
    "B4": dict(jax=("physics/pallas_solver.py", "_apgd_kernel"),
               cuda=("csrc/dense_solve.cu", "hgt_apgd_kernel", "__global__"),
               smoke="hgt_apgd_kernel", perf="hgt_apgd_kernel"),
}

# (JAX module, function) of every `pallas_call`, one entry a call
PALLAS_SITES = [
    ("physics/mega_kernel.py", "_mega_call"),
    ("physics/pallas_solver.py", "apgd_solve_pallas"),
    ("physics/pallas_solver.py", "fused_solve_pallas"),
]


# ---- reading the sources ----

def _modules(pkg):
    out = []
    for dirpath, _, files in os.walk(pkg):
        out += [os.path.relpath(os.path.join(dirpath, f), pkg) for f in files if f.endswith(".py")]
    return sorted(out)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _public_names(path):
    """The module body's top-level def, class and assigned names that do not
    start with `_` (a name it imports is defined elsewhere)."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def _joins_path(path, parts):
    """Whether a call in the module passes the path's parts as consecutive
    string arguments (`os.path.join(ROOT, "build", "native", ...)`)."""
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Call):
            args = [a.value if isinstance(a, ast.Constant) else None for a in node.args]
            if any(args[i:i + len(parts)] == parts for i in range(len(args))):
                return True
    return False


def _target_exists(port_pkg, module, target):
    path = os.path.join(port_pkg, module)
    if not os.path.exists(path):
        return False
    if "/" in target:
        return _joins_path(path, target.strip("/").split("/"))
    return target in _public_names(path)


def _missing_names(module, jax_pkg=JAX_PKG, port_pkg=PORT_PKG):
    """The JAX module's public names with no counterpart in the port, each
    with what was looked for."""
    port_mod = os.path.join(port_pkg, MODULE_MAP.get(module, module))
    have = _public_names(port_mod) if os.path.exists(port_mod) else set()
    skipped = {n for mod, names, _ in NOT_PORTED if mod == module for n in names}
    missing = []
    for name in sorted(_public_names(os.path.join(jax_pkg, module))):
        if name in skipped:
            continue
        if (module, name) in MOVED:
            home = MOVED[module, name][0]
            if not _target_exists(port_pkg, home, name):
                missing.append(f"{name} (moved to {home})")
        elif (module, name) in RENAMED:
            home, target, _ = RENAMED[module, name]
            if not _target_exists(port_pkg, home, target):
                missing.append(f"{name} (renamed {target} in {home})")
        elif name not in have:
            missing.append(name)
    return missing


def _pallas_sites(jax_pkg=JAX_PKG):
    """(module, innermost enclosing function) of every `pallas_call` call."""
    sites = []
    for module in _modules(jax_pkg):
        tree = _tree(os.path.join(jax_pkg, module))
        defs = [n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if "pallas_call" not in (getattr(node.func, "attr", None),
                                     getattr(node.func, "id", None)):
                continue
            around = [d for d in defs if d.lineno <= node.lineno <= d.end_lineno]
            inner = max(around, key=lambda d: d.lineno).name if around else "<module>"
            sites.append((module, inner))
    return sorted(sites)


def _function_span(path, name):
    spans = [(n.lineno, n.end_lineno) for n in ast.walk(_tree(path))
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name]
    assert len(spans) == 1, f"{os.path.basename(path)} defines {name} {len(spans)} times"
    return spans[0]


def _smoke_kernels(smoke=SMOKE):
    """chip_smoke.py's `kernels = [dict(...), ...]` as dicts of their
    constant keywords."""
    found = []
    for node in ast.walk(_tree(smoke)):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "kernels" and isinstance(node.value, ast.List)):
            found.append([{k.arg: k.value.value for k in call.keywords
                           if k.arg and isinstance(k.value, ast.Constant)}
                          for call in node.value.elts])
    assert len(found) == 1, f"chip_smoke.py assigns `kernels` {len(found)} times"
    return found[0]


def _perf_kernel_rows(perf=PERF):
    """PERF.md's kernel table: first cell -> the row."""
    with open(perf) as f:
        text = f.read()
    start = text.index("### Kernel table")
    rows = {}
    for line in text[start:].splitlines()[1:]:
        if line.startswith("### "):
            break
        if line.startswith("|"):
            rows[line.split("|")[1].strip()] = line
    return rows


def _cuda_defines(path, symbol, qualifier):
    """Whether the source, its comments cut, defines `symbol` as a
    `qualifier` (`__global__` or `__device__`) function."""
    with open(path) as f:
        src = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
    return re.search(rf"{qualifier}[^;{{}}]*\b{symbol}\s*\(", src) is not None


def _kernel_problems(kid, jax_pkg=JAX_PKG, port_pkg=PORT_PKG, smoke=SMOKE, perf=PERF):
    row = KERNELS[kid]
    jax_mod, jax_fn = row["jax"]
    src, symbol, qualifier = row["cuda"]
    problems = []
    if not _cuda_defines(os.path.join(port_pkg, src), symbol, qualifier):
        problems.append(f"{src} defines no {qualifier} {symbol}")
    entries = [e for e in _smoke_kernels(smoke) if e.get("name", "").split()[0] == row["smoke"]]
    if len(entries) != 1:
        problems.append(f"chip_smoke.py's kernels line has {len(entries)} entries for {kid}")
    for e in entries:
        if e.get("source") != f"humanoid_gym_tpu_torch/{src}":
            problems.append(f"{kid}'s entry names source {e.get('source')!r}")
        file, _, line = e.get("replaces", "").rpartition(":")
        if file != f"humanoid_gym_tpu/{jax_mod}" or not line.isdigit():
            problems.append(f"{kid}'s entry replaces {e.get('replaces')!r}, "
                            f"not a line of {jax_mod}")
            continue
        lo, hi = _function_span(os.path.join(jax_pkg, jax_mod), jax_fn)
        if not lo <= int(line) <= hi:
            problems.append(f"{kid}'s replaces= line {line} lies outside {jax_fn} "
                            f"({jax_mod}:{lo}-{hi})")
    perf_row = _perf_kernel_rows(perf).get(kid)
    if perf_row is None or row["perf"] not in perf_row:
        problems.append(f"PERF.md's kernel table has no row {kid} naming {row['perf']}")
    return problems


def _registered(path):
    return [n.args[0].value for n in ast.walk(_tree(path))
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "register"
            and n.args and isinstance(n.args[0], ast.Constant)]


def _entry_points():
    pairs = [(f"{d}/{f}", f"{d}/{f[:-3]}_torch.py")
             for d in ("scripts", "examples") for f in sorted(os.listdir(os.path.join(ROOT, d)))
             if f.endswith(".py") and not f.endswith("_torch.py")]
    return pairs + [("bench.py", "bench_torch.py"), ("__graft_entry__.py", "graft_entry_torch.py")]


# ---- the checks ----

JAX_MODULES = _modules(JAX_PKG)


def test_the_scan_sees_both_packages():
    assert len(JAX_MODULES) >= 40 and "physics/mega_kernel.py" in JAX_MODULES
    assert len(_modules(PORT_PKG)) >= len(JAX_MODULES)
    assert len(_entry_points()) >= 15
    assert len(_smoke_kernels()) == len(KERNELS)  # no kernel in the kernels line but the rows


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_has_its_port_file(module):
    port = MODULE_MAP.get(module, module)
    assert os.path.exists(os.path.join(PORT_PKG, port)), (
        f"humanoid_gym_tpu/{module} has no counterpart humanoid_gym_tpu_torch/{port}")


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_names_have_counterparts(module):
    missing = _missing_names(module)
    assert not missing, (f"humanoid_gym_tpu/{module}: no counterpart in humanoid_gym_tpu_torch/"
                         f"{MODULE_MAP.get(module, module)} for {missing}; port them, or declare "
                         f"them in MOVED, RENAMED or NOT_PORTED with a reason")


@pytest.mark.parametrize("jax_file, port_file", _entry_points(), ids=lambda p: p)
def test_entry_point_has_its_port(jax_file, port_file):
    assert os.path.exists(os.path.join(ROOT, port_file)), f"{jax_file} has no {port_file}"


def test_both_registries_hold_the_same_tasks():
    jax_tasks = _registered(os.path.join(JAX_PKG, "registry.py"))
    port_tasks = _registered(os.path.join(PORT_PKG, "registry.py"))
    assert len(jax_tasks) == len(set(jax_tasks)) >= 10
    assert not set(PORT_ONLY_TASKS) & set(jax_tasks)
    assert all(PORT_ONLY_TASKS.values())
    assert sorted(port_tasks) == sorted(jax_tasks + list(PORT_ONLY_TASKS))


def test_every_pallas_call_site_is_known():
    """(a): a `pallas_call` the table does not know is a kernel to port."""
    assert _pallas_sites() == sorted(PALLAS_SITES)
    assert {fn for _, fn in PALLAS_SITES} == {"_mega_call", "apgd_solve_pallas",
                                             "fused_solve_pallas"}


@pytest.mark.parametrize("kid", sorted(KERNELS))
def test_kernel_row_is_ported_and_recorded(kid):
    """(b) the CUDA symbol is defined in its source; (c) chip_smoke.py's
    kernels line has one entry for the row, its replaces= line inside the
    JAX function that holds the kernel body; (d) PERF.md's kernel table has
    the row."""
    problems = _kernel_problems(kid)
    assert not problems, problems


def _exception_cases():
    cases = [(f"moved:{mod}:{name}", mod, (name,), home, name, reason)
             for (mod, name), (home, reason) in MOVED.items()]
    cases += [(f"renamed:{mod}:{name}", mod, (name,), home, target, reason)
              for (mod, name), (home, target, reason) in RENAMED.items()]
    cases += [(f"not_ported:{mod}:{names[0]}", mod, names, None, None, reason)
              for mod, names, reason in NOT_PORTED]
    return [pytest.param(*case[1:], id=case[0]) for case in cases]


@pytest.mark.parametrize("module, names, home, target, reason", _exception_cases())
def test_declared_exception_is_live(module, names, home, target, reason):
    """Each declared exception has its reason, names a public name the JAX
    module still has and the port module lacks, and its target exists."""
    assert reason.strip() and "\n" not in reason
    jax_names = _public_names(os.path.join(JAX_PKG, module))
    port_mod = os.path.join(PORT_PKG, MODULE_MAP.get(module, module))
    port_names = _public_names(port_mod)
    for name in names:
        assert name in jax_names, f"{module} has no {name} any more: drop the entry"
        assert name not in port_names, f"the port's {MODULE_MAP.get(module, module)} has {name}"
    if home is not None:
        assert _target_exists(PORT_PKG, home, target), f"{home} has no {target}"


# ---- self-tests: each check fails on a copy that breaks what it holds ----

def _copy_sources(pkg, dst):
    shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.pyc"))
    return str(dst)


def _delete_def(path, name):
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    node = next(n for n in _tree(path).body if getattr(n, "name", None) == name)
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    with open(path, "w") as f:
        f.writelines(lines[:first - 1] + lines[node.end_lineno:])


def test_names_check_catches_a_deleted_counterpart(tmp_path):
    port = _copy_sources(PORT_PKG, tmp_path / "humanoid_gym_tpu_torch")
    assert _missing_names("physics/mega_kernel.py", port_pkg=port) == []
    assert _missing_names("physics/step.py", port_pkg=port) == []
    _delete_def(os.path.join(port, "physics", "mega.py"), "make_mega_step_batched")
    _delete_def(os.path.join(port, "physics", "mega.py"), "pd_torques")
    assert _missing_names("physics/mega_kernel.py", port_pkg=port) == ["make_mega_step_batched"]
    assert _missing_names("physics/step.py", port_pkg=port) == [
        "pd_torques (moved to physics/mega.py)"]


def test_pallas_check_catches_a_fourth_site(tmp_path):
    jax = _copy_sources(JAX_PKG, tmp_path / "humanoid_gym_tpu")
    assert _pallas_sites(jax) == sorted(PALLAS_SITES)
    with open(os.path.join(jax, "physics", "step.py"), "a") as f:
        f.write("\n\ndef _probe_kernel_call(x):\n    return pl.pallas_call(None, out_shape=x)(x)\n")
    assert _pallas_sites(jax) == sorted(PALLAS_SITES + [("physics/step.py", "_probe_kernel_call")])


def test_kernel_check_catches_a_stale_replaces_pointer(tmp_path):
    with open(SMOKE) as f:
        src = f.read()
    good = 'replaces="humanoid_gym_tpu/physics/pallas_solver.py:60"'
    assert src.count(good) == 1
    solver = os.path.join(JAX_PKG, "physics", "pallas_solver.py")
    wrapper = _function_span(solver, "apgd_solve_pallas")[0]
    stale = tmp_path / "chip_smoke.py"
    stale.write_text(src.replace(good, good.replace(":60", f":{wrapper}")))
    assert _kernel_problems("B4", smoke=str(stale)) == [
        f"B4's replaces= line {wrapper} lies outside _apgd_kernel (physics/pallas_solver.py:60-"
        f"{_function_span(solver, '_apgd_kernel')[1]})"]
    assert _kernel_problems("B3", smoke=str(stale)) == []
