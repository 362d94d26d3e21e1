"""A cell, a configuration and a per-layer metric are found by name as
files: added in a copy of the benchmark, with no edit of its code."""

import importlib.util
import json
import os
import shutil

from conftest import ROOT


def _load_run(root):
    spec = importlib.util.spec_from_file_location("bench_run_copy",
                                                  os.path.join(root, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_cell_config_and_metric_are_found_as_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
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
    import subprocess
    import sys

    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
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
