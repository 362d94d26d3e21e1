"""A cell, a configuration and a per-layer metric are found by name as
files: added in a copy of the benchmark, with no edit of its code; so is
the reference module a configuration names, which judges its cell and
counts its nets. The configuration's policy and algorithm keys are held
to the program's train config."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _copy_benchmark(root):
    """BENCHMARK.json and the benchmark's files, without its tests, in
    `root`."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)


def _load_run(root):
    spec = importlib.util.spec_from_file_location("bench_run_copy",
                                                  os.path.join(root, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_cell_config_and_metric_are_found_as_files(tmp_path):
    root = str(tmp_path)
    _copy_benchmark(root)
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "configs", "xbotl_flat.json")) as f:
        cfg = dict(json.load(f), name="xbotl_flat_copy")
    with open(os.path.join(bench_dir, "configs", "xbotl_flat_copy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "workloads", "flat_8192.json"), "w") as f:
        json.dump({"config": "xbotl_flat_copy", "envs_per_robot": [8192], "why": "x", "who": "x",
                   "limits": {}}, f)
    with open(os.path.join(bench_dir, "metrics", "doubled_setup_s.py"), "w") as f:
        f.write("def read(ctx):\n    return 2 * ctx['setup_s']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "doubled_setup_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "x", "moves": "setup_s",
                               "workloads": ["flat_8192"]})

    run = _load_run(root)
    wl, cfg = run.load_workload("flat_8192")
    assert wl["envs_per_robot"] == [8192] and cfg["name"] == "xbotl_flat_copy"
    names = [m["name"] for m in run.cell_metrics(bench, "flat_8192", True)]
    assert names == ["doubled_setup_s"]  # the others list the cells they read in
    e2e = [m["name"] for m in run.cell_metrics(bench, "flat_8192", False)]
    assert e2e == ["env_steps_per_s", "peak_mem_gib", "setup_s"]
    assert "doubled_setup_s" not in [m["name"] for m in run.cell_metrics(bench, "flat_4096", True)]
    assert run.metric_reader("doubled_setup_s")({"setup_s": 1.5}) == 3.0


def test_every_listed_metric_and_cell_has_its_files():
    from benchmark import correct

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    run = _load_run(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    for w in bench["workloads"]:
        wl, cfg = run.load_workload(w["name"])
        assert wl["config"] == w["config"] == cfg["name"]
        assert set(wl["limits"]) >= set(correct.NUMBERS)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    root = str(tmp_path)
    _copy_benchmark(root)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flat_4096", "--seed",
                        "1", "--seconds", "1", "--trace", "0", "--cpu-rehearsal"], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_verdict_limits():
    """A number over its limit fails, one at a null limit is not judged,
    and one the limits do not name fails."""
    from benchmark import correct

    assert correct.verdict({"nets_gap": 0.01}, {"nets_gap": 0.02})[0] is True
    assert correct.verdict({"nets_gap": 0.03}, {"nets_gap": 0.02})[0] is False
    assert correct.verdict({"loss_gap": 5.0}, {"loss_gap": None})[0] is True
    assert correct.verdict({"loss_gap": 0.0}, {})[0] is False
    assert correct.verdict({"nets_gap": float("nan")}, {"nets_gap": 0.02})[0] is False


STUB = '''"""A reference module a configuration names: follow's, marked."""
import sys

from .follow import Reference as _Follow

STEPS = {steps}


class Reference(_Follow):
    def __init__(self, *args, **kw):
        print("stub reference judges this run", file=sys.stderr)
        super().__init__(*args, **kw)


def net_flops(cfg, envs):
    return 7 * envs
'''


def _stub_cell(root, module, steps, cell):
    """A stub reference module `benchmark/reference/<module>.py` that
    follows `steps` env steps, a configuration (xbotl_flat's, with its
    policy and algorithm keys) that names it, and a cell of it."""
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "reference", f"{module}.py"), "w") as f:
        f.write(STUB.format(steps=steps))
    with open(os.path.join(bench_dir, "configs", "xbotl_flat.json")) as f:
        cfg = json.load(f)
    cfg.update(name=f"xbotl_flat_{module}", reference=module,
               policy={"actor_hidden_dims": [512, 256, 128], "init_noise_std": 1.0},
               algorithm={"clip_param": 0.2, "estimator_slice": [199, 202]})
    with open(os.path.join(bench_dir, "configs", f"{cfg['name']}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "workloads", "flat_4096.json")) as f:
        wl = dict(json.load(f), config=cfg["name"])
    with open(os.path.join(bench_dir, "workloads", f"{cell}.json"), "w") as f:
        json.dump(wl, f)


@pytest.fixture
def stub_tree(tmp_path):
    """A copied benchmark with two cells of new configurations: `flat_stub`,
    judged by `stub_ref` (STEPS = 3, as follow's), and `flat_two`, by
    `stub_two` (STEPS = 2)."""
    root = str(tmp_path)
    _copy_benchmark(root)
    _stub_cell(root, "stub_ref", 3, "flat_stub")
    _stub_cell(root, "stub_two", 2, "flat_two")
    return root


def _in_tree(root, code):
    """The last line of `code` run in `root` with only the copy importable
    as `benchmark`, as JSON."""
    p = subprocess.run([sys.executable, "-c", "import sys\nsys.path.insert(0, '.')\n" + code],
                       cwd=root, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_configuration_names_its_reference_and_census(stub_tree):
    """The copy's run.py loads the stub's module for the stub's
    configuration, and the census counts its nets by the stub's
    `net_flops`; a stub that follows 2 steps is refused."""
    got = _in_tree(stub_tree, """
import json
from benchmark import census, run
from benchmark.reference import stub_ref
wl, cfg = run.load_workload("flat_stub")
mod = run.reference_module(cfg)
cfg = dict(cfg, steps_per_env=60)
phys = 60 * census.physics_call(4096, False, 10, 8)[0] + 4096 * 60 * census.GAE_OPS_PER_SAMPLE
try:
    run.reference_module(run.load_workload("flat_two")[1])
    refused = ""
except RuntimeError as e:
    refused = str(e)
print(json.dumps({"module": mod.__name__, "reference": mod.Reference is stub_ref.Reference,
                  "census": census.nets_census(cfg) is stub_ref.net_flops,
                  "least": census.iteration_least_s(cfg, wl["envs_per_robot"]),
                  "want": phys / census.PEAK_F32_FLOPS + 7 * 4096 / census.PEAK_BF16_FLOPS,
                  "file": stub_ref.__file__, "refused": refused}))
""")
    assert got["module"] == "benchmark.reference.stub_ref" and got["reference"] and got["census"]
    assert got["file"].startswith(stub_tree)
    assert got["least"] == got["want"]
    assert "STEPS = 2" in got["refused"]


def test_a_reference_with_other_steps_is_refused_before_the_window(stub_tree):
    """run.py refuses the STEPS = 2 stub before it drives the program: the
    copy holds no program, so a refusal any later would name the missing
    package instead."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flat_two", "--seed",
                        "1", "--seconds", "1", "--trace", "0", "--cpu-rehearsal"], cwd=stub_tree,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "STEPS = 2" in p.stderr and "humanoid_gym_tpu_torch" not in p.stderr


def test_a_cell_is_judged_by_the_module_its_configuration_names(stub_tree):
    """A CPU rehearsal of the stub's cell in the copy, the rest of the repo
    linked beside it: the stub's Reference judges the run, and the
    configuration's policy and algorithm keys pass the program's check."""
    for name in os.listdir(ROOT):
        if name not in ("benchmark", "BENCHMARK.json", ".git"):
            os.symlink(os.path.join(ROOT, name), os.path.join(stub_tree, name))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flat_stub", "--seed",
                        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0", "--cpu-rehearsal"],
                       cwd=stub_tree, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "stub reference judges this run" in p.stderr
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["workload"] == "flat_stub@cpu-rehearsal" and d["correct"] is True


def _task_cfgs(task="humanoid_ppo"):
    from humanoid_gym_tpu_torch import registry

    spec = registry.get_task(task)
    return spec.make_env_cfg(), spec.make_train_cfg()


@pytest.mark.parametrize("group,key,value,raises", [
    ("policy", "actor_hidden_dims", [512, 256, 128], False),
    ("algorithm", "estimator_slice", [199, 202], False),
    ("policy", "actor_hidden_dims", [512, 256, 64], True),
    ("algorithm", "clip_param", 0.3, True),
    ("policy", "rnn_hidden_size", 64, True),
    ("algorithm", "num_learning_steps", 8, True),
])
def test_check_config_holds_the_policy_and_algorithm_keys(group, key, value, raises):
    """A key of the file's `policy` / `algorithm` object passes where the
    program's train config holds the same value, and raises where it holds
    another or no such attribute."""
    from benchmark import program, run

    cfg = run.load_json(run.BENCH_DIR, "configs", "xbotl_flat.json")
    env_cfg, train_cfg = _task_cfgs()
    program.check_config(cfg, env_cfg, train_cfg)
    cfg[group] = {key: value}
    if raises:
        with pytest.raises(RuntimeError, match=f"{group}.{key}"):
            program.check_config(cfg, env_cfg, train_cfg)
    else:
        program.check_config(cfg, env_cfg, train_cfg)
