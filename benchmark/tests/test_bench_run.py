"""The run command: no result without the cards a cell asks for, nothing of
JAX loaded by a run, and a cell added as files picked up without an edit."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ROOT = harness.ROOT


def run_cmd(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run")
    proc = run_cmd("--workload", "nerf_blender.train", "--seed", str(2 ** 31 + 7),
                   "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_unknown_cell_refused():
    proc = run_cmd("--workload", "no_such.cell", "--seed", "1", "--seconds", "1")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A checkout with only BENCHMARK.json and benchmark/ has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = run_cmd("--workload", "nerf_blender.train", "--seed", "3", "--seconds", "1",
                   cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_cell_added_as_files(tmp_path, tiny):
    """A new cell, its traffic file and a new metric's reader, added to a copy
    of the benchmark: the harness runs it and reads the metric unedited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    cell = "nerf_blender.render_small"
    workload = json.loads((bench / "workloads" / "nerf_blender.render_exact.json").read_text())
    workload["traffic"].update(tiny["nerf_blender.render_exact"]["traffic"])
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(workload))
    (bench / "metrics" / "frames_read.render.py").write_text(
        "def read(run):\n    return run.readings.get('frames')\n")
    man = harness.manifest()
    man["workloads"].append({"name": cell, "config": "nerf_blender", "traffic": "render_small",
                             "chips": 1, "why": "a stub"})
    for m in man["end_to_end"]:
        if "nerf_blender.render_exact" in m.get("workloads", []):
            m["workloads"].append(cell)
    man["per_layer"].append({"name": "frames_read.render", "unit": "frames", "better": "higher",
                             "source": "host_clock", "layer": "render path",
                             "moves": "render_rays_per_s", "workloads": [cell]})
    overrides = {"config": tiny["nerf_blender.render_exact"]["config"]}
    run = harness.run_cell(cell, 11, 0.3, True, torch.device("cpu"), overrides,
                           bench_dir=bench)
    out = harness.result_line(run, man, cell, {"platform": "cpu", "count": 1}, bench_dir=bench)
    assert out["metrics"]["frames_read.render"]["value"] == run.attempted > 0
    run.trace = False
    out = harness.result_line(run, man, cell, {"platform": "cpu", "count": 1}, bench_dir=bench)
    assert set(out["metrics"]) == {"setup_s", "render_rays_per_s", "frame_p95_ms"}
    assert list(out)[-1] == "checks" and out["correct"]
