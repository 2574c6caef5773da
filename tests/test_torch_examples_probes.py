"""The port's benchmarks and probes on the CPU in their smoke mode
(``MANUSCRIPT_TPU_BENCH_SMOKE=1``, tiny shapes; ``examples/torch_port/``):
each prints JSON lines whose numbers are finite and which name the device.
Only the card gives their times; here the harness runs, and the wrappers
take their plain twins, so the kernel rows agree with the twins exactly."""

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch_port"
SCRIPTS = ["nms_bench", "kernel_bench", "native_stage_probe", "fused_profile",
           "east_stage_probe", "stem_probe", "int8_probe"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: beside the suite's other workers, torch's
    OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_port_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numbers(value):
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return
    if isinstance(value, (int, float)):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from numbers(v)
    elif isinstance(value, list):
        for v in value:
            yield from numbers(v)


def smoke_lines(name, monkeypatch, capsys):
    monkeypatch.setenv("MANUSCRIPT_TPU_BENCH_SMOKE", "1")
    load(name).main(["--cpu"])
    lines = [json.loads(t) for t in capsys.readouterr().out.splitlines() if t.startswith("{")]
    assert lines, name
    for line in lines:
        assert line["device"] == "cpu", line
        assert all(math.isfinite(v) for v in numbers(line)), line
    return lines


def test_nms_bench_routes_agree(monkeypatch, capsys):
    lines = smoke_lines("nms_bench", monkeypatch, capsys)
    assert [ln["n_candidates"] for ln in lines] == [128, 256]
    for ln in lines:
        assert ln["host_boxes"] == ln["scan_boxes"] == ln["parallel_boxes"] > 0
        assert min(ln["host_cpp_ms"], ln["device_scan_ms"], ln["device_parallel_ms"]) > 0


def test_kernel_bench_rows_match_their_twins(monkeypatch, capsys):
    lines = smoke_lines("kernel_bench", monkeypatch, capsys)
    assert [ln["kernel"] for ln in lines] == [
        "attention_step", "attention_step", "quad_iou_gather", "quad_iou_matrix",
        "lanms_merge_scan", "lanms_merge_scan", "trba_greedy_decode", "multi_tensor_perturb",
        "multi_tensor_restore", "multi_tensor_update"]
    assert [ln.get("field") for ln in lines if ln["kernel"] == "lanms_merge_scan"] == [
        "words", "one chain"]
    for ln in lines:
        assert ln["route"] == "plain" and ln["max_abs_err"] == 0.0
        assert ln["ms"] > 0 and ln["plain_ms"] > 0 and ln["bound_ms"] > 0
        assert ln["bound_by"] in ("bytes", "operations")


def test_native_stage_probe_reads_every_stage(monkeypatch, capsys):
    lines = smoke_lines("native_stage_probe", monkeypatch, capsys)
    assert lines[0]["pages"] == 4 and lines[0]["pages_per_sec"] > 0
    assert [ln["stage"] for ln in lines[1:]] == ["prep", "detect", "crops", "recognize", "finish"]


def test_fused_profile_splits_the_page_program(monkeypatch, capsys):
    lines = smoke_lines("fused_profile", monkeypatch, capsys)
    stages = ["fused.east_forward", "fused.decode", "fused.nms", "fused.postprocess",
              "trba.encode", "trba.decode", "crops", "page_program"]
    for mode in ("beam", "greedy"):
        rows = [ln for ln in lines if ln.get("mode") == mode]
        assert [ln["stage"] for ln in rows] == stages
        assert all(ln["host_ms"] > 0 for ln in rows if ln["stage"] != "crops")
        total = rows[-1]["host_ms"]  # each line rounded to 1e-4 ms
        assert sum(ln["host_ms"] for ln in rows[:-1]) == pytest.approx(total, abs=1e-3)


def test_east_stage_probe_covers_the_forward(monkeypatch, capsys):
    lines = smoke_lines("east_stage_probe", monkeypatch, capsys)
    assert [ln["stage"] for ln in lines] == ["stem", "layer1", "layer2", "layer3", "layer4",
                                             "decoder", "heads", "rest", "forward"]
    assert all(ln["host_ms"] > 0 for ln in lines if ln["stage"] != "rest")
    # each line rounded to 1e-4 ms
    assert sum(ln["host_ms"] for ln in lines[:-1]) == pytest.approx(lines[-1]["host_ms"], abs=1e-3)


def test_stem_probe_space_to_depth_is_exact(monkeypatch, capsys):
    lines = smoke_lines("stem_probe", monkeypatch, capsys)
    assert lines[0]["check"] == "s2d_equivalence" and lines[0]["rel_err"] < 1e-5
    assert [ln["program"] for ln in lines[1:]] == [
        "stem_conv_7x7s2", "stem_conv_s2d_4x4s1", "east_forward_full"]


def test_stem_space_to_depth_matches_the_jax_fold():
    """The port's NCHW fold gives the JAX probe's NHWC kernel fold."""
    import numpy as np

    probe = load("stem_probe")
    k = np.random.default_rng(3).standard_normal((64, 3, 7, 7)).astype(np.float32)
    folded = probe.fold_kernel(torch.from_numpy(k)).numpy()  # (O, 4C, 4, 4)
    k8 = np.pad(k.transpose(2, 3, 1, 0), ((1, 0), (1, 0), (0, 0), (0, 0)))  # HWIO, 8×8
    want = k8.reshape(4, 2, 4, 2, 3, 64).transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 12, 64)
    np.testing.assert_array_equal(folded, want.transpose(3, 2, 0, 1))


def test_int8_probe_times_every_shape(monkeypatch, capsys):
    lines = smoke_lines("int8_probe", monkeypatch, capsys)
    assert len(lines) == 8 and lines[-1]["shape"] == "matmul256"
    assert all(ln["bf16_gemm_ms"] > 0 and ln["int8_gemm_ms"] > 0 for ln in lines)


@pytest.mark.parametrize("name", SCRIPTS)
def test_without_cpu_flag_a_script_needs_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(name).main([])
