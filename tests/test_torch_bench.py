"""The port's measuring tools on the CPU: the bench and the serving bench in
smoke mode (``MANUSCRIPT_TPU_BENCH_SMOKE=1``, tiny shapes, subprocesses),
the kernel build cache, and the kernels' FLOP and byte counts against hand
counts. Only the card gives the bench's numbers; here the harness runs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from manuscript_tpu_torch.ops import _build
from manuscript_tpu_torch.ops import attention_step as k1
from manuscript_tpu_torch.ops import quad_iou as k2
from manuscript_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parent.parent
# the metrics of the JAX bench's smoke run, in its order (quality needs the card)
SMOKE_METRICS = [
    "e2e_pipeline_pages_per_sec", "fused_device_only_pages_per_sec", "e2e_greedy_pages_per_sec",
    "e2e_devicecrop_pages_per_sec", "fused_single_page_latency_s", "fused_program_mfu",
    "fused_e2e_mfu", "trba_greedy_crops_per_sec", "east_standalone_pages_per_sec",
    "fused_vs_host_box_f1", "fused_crop_psnr_db", "fused_crop_scale2_psnr_db",
    "batched_100page_pages_per_sec", "east_sam_train_steps_per_sec", "east_train_step_mfu",
    "trba_train_steps_per_sec", "trba_train_step_mfu", "serve_pages_per_sec",
    "serve_latency_p50_s", "serve_latency_p99_s", "e2e_pipeline_pages_per_sec_last",
]


def _run(args, env=None, timeout=300):
    # one intra-op thread: beside the suite's other workers, torch's OpenMP
    # threads spin against theirs and the smoke run slowed ~20×
    env = dict(os.environ, MANUSCRIPT_TPU_BENCH_SMOKE="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", **(env or {}))
    env.pop("MANUSCRIPT_TPU_KERNEL_CACHE", None)
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def _lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def test_smoke_bench_prints_the_jax_metrics_primary_first():
    root_raw = (ROOT / "bench_raw.json").read_bytes()
    raw_path = ROOT / "build" / "bench_torch_raw.json"
    before = raw_path.stat().st_mtime_ns if raw_path.exists() else None
    lines = _lines(_run(["-m", "manuscript_tpu_torch", "bench"]))
    assert [ln["metric"] for ln in lines] == SMOKE_METRICS
    jax_bench = (ROOT / "bench.py").read_text()
    for ln in lines:
        assert f'"{ln["metric"]}"' in jax_bench, ln["metric"]
        assert np.isfinite(ln["value"]) and ln["device"] == "cpu" and ln["smoke"] is True
    assert lines[0]["unit"] == "pages/s" and "vs_baseline" in lines[0]
    for ln in lines:
        if ln["metric"].endswith("_mfu"):
            assert ln["unit"] == "fraction_of_h100_bf16_dense_peak" and 0 < ln["value"] <= 1.05
    # the raw timings land in build/, never in the JAX bench's file
    assert (ROOT / "bench_raw.json").read_bytes() == root_raw
    assert raw_path.stat().st_mtime_ns != before
    raw = json.loads(raw_path.read_text())
    assert raw["channel_folded"] is False and raw["flops_per_page"] > 0
    assert len(raw["fused_batch_s"]) == 3 and raw["quality_skipped"] == "smoke mode"


def test_smoke_perf_gate_line():
    out = _run(["-m", "manuscript_tpu_torch.bench", "--perf-gate"])
    gate = [ln for ln in out.splitlines() if ln.startswith("PERF_GATE ")]
    assert len(gate) == 1
    got = json.loads(gate[0][len("PERF_GATE "):])
    assert set(got) == {"device_only_pages_per_sec", "program_mfu", "flops_per_page",
                        "word_capacity", "backend", "device", "smoke"}
    assert got["backend"] == "cpu" and got["word_capacity"] == 16
    assert got["device_only_pages_per_sec"] > 0 and 0 < got["program_mfu"] <= 1.05


def test_smoke_serve_bench_npy():
    lines = {ln["metric"]: ln for ln in _lines(_run(
        ["-m", "manuscript_tpu_torch.serve_bench", "--codec", "npy", "--seconds", "3"]))}
    assert {"serve_requests_per_sec", "serve_pages_per_sec", "serve_latency_p50_s",
            "serve_latency_p90_s", "serve_latency_p99_s", "serve_errors"} <= set(lines)
    assert lines["serve_errors"]["value"] == 0 and lines["serve_pages_per_sec"]["value"] > 0
    assert 1 <= lines["serve_pages_per_sec"]["mean_batch_fill"] <= 4
    assert (lines["serve_latency_p50_s"]["value"] <= lines["serve_latency_p90_s"]["value"]
            <= lines["serve_latency_p99_s"]["value"])


def test_compile_cache_resolution(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "cache_dir", None)
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.enable_compile_cache(None) is None
    assert _build.build_dir() == _build.BUILD_DIR
    assert compile_cache.enable_compile_cache(str(tmp_path / "default")) == str(tmp_path / "default")
    assert _build.build_dir() == tmp_path / "default"
    assert _build.library_path("lanms").parent == tmp_path / "default"
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env"))
    assert compile_cache.enable_compile_cache(str(tmp_path / "default")) == str(tmp_path / "env")
    assert _build.build_dir() == tmp_path / "env"
    # a directory that cannot be made warns and leaves the build where it was
    (tmp_path / "file").write_text("")
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "file" / "cache"))
    with pytest.warns(RuntimeWarning, match="kernel cache disabled"):
        assert compile_cache.enable_compile_cache(None) is None
    assert _build.build_dir() == tmp_path / "env"


_LOAD = (
    "import json; from manuscript_tpu_torch.utils.compile_cache import enable_compile_cache;"
    "from manuscript_tpu_torch.ops import _build; where = enable_compile_cache();"
    "seconds = _build.build(['lanms']); lib = _build.library('lanms');"
    "print(json.dumps({'cache': where, 'seconds': seconds, 'loaded': lib._name}))"
)


def test_host_lanms_builds_into_the_cache_and_loads_from_it(tmp_path):
    cache = tmp_path / "cache"
    env = dict(os.environ, MANUSCRIPT_TPU_KERNEL_CACHE=str(cache))
    first = subprocess.run([sys.executable, "-c", _LOAD], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    got = json.loads(first.stdout)
    assert got["cache"] == str(cache) and set(got["seconds"]) == {"lanms"}
    assert Path(got["loaded"]).parent == cache and Path(got["loaded"]).name.startswith("liblanms-")
    # a second process with no compiler on PATH: nothing to build, the cached library loads
    env["PATH"] = str(tmp_path / "empty")
    second = subprocess.run([sys.executable, "-c", _LOAD], cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    again = json.loads(second.stdout)
    assert again["seconds"] == {} and again["loaded"] == got["loaded"]


def test_k1_cost_against_a_hand_count():
    # words 2, beam 4 (R = 8), T 5, H 64, E 32, 3 distinct tokens
    flops, nbytes = k1.step_cost(2, 8, 5, 64, 32, 3)
    per_row = (2 * 64 * 64            # proj_h = h @ W_h2h
               + 3 * 5 * 64 + 5 * 5   # tanh(proj_enc + proj_h) · w_score, softmax
               + 2 * 5 * 32           # context
               + 2 * 32 * 256 + 2 * 64 * 256  # ctx @ W_ih[:E], h @ W_hh
               + 16 * 64)             # gates and state
    assert flops == 8 * per_row == 8 * 59_673
    floats = (2 * 5 * (32 + 64)       # enc and proj_enc of both words
              + 2 * 8 * 64 + 8        # h, c, the tokens
              + 64 * 64 + 2 * 64      # W_h2h, b_h2h, w_score
              + (32 + 3 + 64) * 256   # W_ih[:E], the 3 token rows, W_hh
              + 256                   # bias
              + 2 * 8 * 64)           # h', c'
    assert nbytes == 4 * floats


def test_k2_costs_against_hand_counts():
    assert k2.gather_cost(100, 40, 25, 2) == (25 * 860, 100 * 32 + 40 * 12 + 2 * 4)
    assert k2.matrix_cost(3, 5) == (15 * 860, 8 * 32 + 15 * 4)
    import torch

    assert k2.call_flops(40) == 40 * 860
    assert k2.call_flops(40, torch.tensor(7, dtype=torch.int32)) == 7 * 860
    assert k2.call_flops(40, torch.tensor([3, 30], dtype=torch.int32)) == (3 + 20) * 860
