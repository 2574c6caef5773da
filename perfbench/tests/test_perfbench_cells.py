"""Cells found by name: a configuration, a traffic mix and a metric added
as files, and one ``workloads`` entry, run without an edit to the harness."""

import json
import os
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import REPO

CELLS = ("trba-tiny.recognize-tiny", "east-tiny.train-tiny")
E2E = {CELLS[0]: {"words_per_s", "recognize_p95_ms", "setup_s"},
       CELLS[1]: {"train_samples_per_s", "setup_s"}}


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_added_by_files_alone_runs_and_is_correct(tiny_root, name):
    cell = harness.load_cell(tiny_root, name, 2**31 + 99, 0.5, False, "cpu")
    out = harness.run(cell, time.perf_counter())
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == E2E[name]
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert res["device"]["platform"] == "cpu"


def test_a_metric_added_by_a_file_is_read_in_the_traced_run(tiny_root):
    (tiny_root / "perfbench" / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "bench", "moves": "words_per_s",
                               "workloads": [CELLS[0]]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tiny_root, CELLS[0], 3, 0.5, True, "cpu")
    res = harness.run(cell, time.perf_counter())["result"]
    # device metrics read nothing from a CPU trace, and are left out of the line
    assert res["metrics"] == {"calls_traced": {"value": float(cell.traffic["trace_calls"]),
                                               "unit": "calls"}}
    assert res["correct"] is True


def _run_py(cwd, env_extra):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **env_extra}
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "trba-full.recognize-b512",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_py_without_a_card_prints_no_result():
    proc = _run_py(REPO, {})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_py_in_a_folder_of_the_benchmark_alone_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
