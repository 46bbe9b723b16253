"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and ``BENCHMARK.json`` entries alone: in a copy of the
benchmark, the harness finds and runs them, and no file that was there
changes. The real command refuses to run without a card."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.tests import tiny

NEW_READER = '''"""Windows a second of the untraced window (a test reader)."""


def read(ctx):
    return ctx.window.units / ctx.window.seconds
'''


def _digests(root):
    """The benchmark's files (``BENCHMARK.json`` gains entries, so it is left out)."""
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_portbench_new_files_are_found(tmp_path):
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    harness = tmp_path / "portbench"
    config = json.loads((harness / "configs" / "hypelcnn480.json").read_text())
    config["params"]["spatial_hierarchy_level"] = 2
    (harness / "configs" / "hypelcnn480_l2.json").write_text(json.dumps(config))
    traffic = json.loads((harness / "traffic" / "sweep.json").read_text())
    (harness / "traffic" / "sweep_r4.json").write_text(json.dumps({**traffic, "batch_rows": 4}))
    (harness / "metrics" / "windows_per_s.sweep.py").write_text(NEW_READER)
    (harness / "limits" / "hypelcnn480_l2.sweep_r4.json").write_text(
        (harness / "limits" / "hypelcnn480.sweep.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "hypelcnn480_l2",
                             "file": "portbench/configs/hypelcnn480_l2.json"})
    bench["workloads"].append({"name": "hypelcnn480_l2.sweep_r4", "config": "hypelcnn480_l2",
                               "traffic": "sweep_r4", "chips": 1, "why": "a test cell"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "sweep_pixels_per_s":
            metric["workloads"].append("hypelcnn480_l2.sweep_r4")
    bench["per_layer"].append({"name": "windows_per_s.sweep", "unit": "windows/s",
                               "better": "higher", "source": "host_clock", "layer": "device",
                               "moves": "sweep_pixels_per_s",
                               "workloads": ["hypelcnn480_l2.sweep_r4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = tiny.run("hypelcnn480_l2.sweep_r4", root=tmp_path)
    traced = tiny.run("hypelcnn480_l2.sweep_r4", root=tmp_path, trace=True)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"sweep_pixels_per_s", "setup_s"}
    assert traced["metrics"]["windows_per_s.sweep"]["value"] > 0  # the new reader, found
    assert traced["metrics"]["windows_per_s.sweep"]["unit"] == "windows/s"
    after = _digests(tmp_path)
    assert {p: d for p, d in after.items() if p in before} == before


def test_portbench_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hypelcnn480.sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""


def test_portbench_refuses_without_the_program(tmp_path):
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {key: value for key, value in os.environ.items() if key != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dualcnn.sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""
