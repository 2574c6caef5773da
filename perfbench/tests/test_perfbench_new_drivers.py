"""The drivers ``recognize_lines`` (TrOCR) and ``trba_train`` and the
readers of TrOCR's regions and of TRBA's training step's, on the CPU at tiny sizes: each cell added by
data files runs, is correct under the real configurations' limits, and a
planted fault or control fails them; the counts; the readers on a written
trace, and on a trace without the regions."""

import json
import time

import pytest

from perfbench import counts_trba_train, counts_trocr, trace
from perfbench.harness import TraceContext, load_cell, load_module, run
from perfbench.tests.conftest import REPO, _write, make_root
from perfbench.tests.test_perfbench_spans import _kernel, _launch
from perfbench.tests.test_perfbench_trace import _x

TROCR_TINY = {
    "encoder": {"image_size": 32, "patch_size": 8, "hidden_size": 32, "num_hidden_layers": 1,
                "num_attention_heads": 4, "intermediate_size": 64},
    "decoder": {"d_model": 32, "decoder_layers": 1, "decoder_attention_heads": 4, "decoder_ffn_dim": 64,
                "vocab_size": 200, "max_position_embeddings": 16, "cross_attention_hidden_size": 32},
    "max_length": 6, "beam_size": 3,
}
LINES_TINY = {"batch_size": 3, "lines": 7, "line_h": 16, "line_w": 64, "warmup_calls": 1, "check_lines": 4,
              "trace_calls": 2}
TRAIN_TINY = {"batch_size": 4, "batches": 2, "check_steps": 2, "trace_calls": 2}
CELLS = ("trocr-tiny.lines-tiny", "trba-tiny.train-b4")


def _root(tmp_path):
    root = make_root(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "trocr-base-handwritten.json").read_text())
    for group in ("encoder", "decoder"):
        cfg[group].update(TROCR_TINY[group])
    cfg.update({k: v for k, v in TROCR_TINY.items() if k not in ("encoder", "decoder")})
    _write(pb / "configs" / "trocr-tiny.json", cfg)
    for name, base, tiny in (("lines-tiny", "recognize-lines-b128", LINES_TINY),
                             ("train-b4", "train-b192", TRAIN_TINY)):
        traffic = json.loads((pb / "traffic" / f"{base}.json").read_text())
        traffic.update(tiny)
        _write(pb / "traffic" / f"{name}.json", traffic)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "trocr-tiny", "source": "https://huggingface.co/microsoft/trocr-base-handwritten",
                             "file": "perfbench/configs/trocr-tiny.json", "reduced": ["encoder", "decoder"],
                             "why": "tiny TrOCR for the CPU tests"})
    bench["workloads"] += [
        {"name": CELLS[0], "config": "trocr-tiny", "traffic": "lines-tiny", "chips": 1, "why": "CPU test"},
        {"name": CELLS[1], "config": "trba-tiny", "traffic": "train-b4", "chips": 1, "why": "CPU test"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for full, tiny in zip(("trocr-base-handwritten.recognize-lines-b128", "trba-full.train-b192"), CELLS):
            if full in m.get("workloads", []):
                m["workloads"].append(tiny)
    _write(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture
def root(tmp_path):
    return _root(tmp_path)


E2E = {CELLS[0]: {"words_per_s", "recognize_p95_ms", "setup_s"},
       CELLS[1]: {"train_samples_per_s", "setup_s"}}


@pytest.mark.parametrize("name", CELLS)
def test_a_new_cell_runs_and_is_correct_under_the_real_limits(root, name):
    cell = load_cell(root, name, 2**31 + 101, 0.5, False, "cpu")
    res = run(cell, time.perf_counter())["result"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == E2E[name]
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name, variant, fails", [
    (CELLS[0], "bfloat16", "logit_gap"),
    (CELLS[1], "half_batch", "loss_gap"),
    (CELLS[1], "reference_bf16", "witness_grad_gap"),
    (CELLS[1], "cnn_grad_scaled", "witness_grad_gap"),
])
def test_a_control_fails_the_check(root, name, variant, fails):
    cell = load_cell(root, name, 2**31 + 103, 0.3, False, "cpu", variant)
    driver = load_module(cell.file("drivers", f"{cell.traffic['driver']}.py"))
    session = driver.setup(cell)
    if getattr(session, "runs_window", True):
        session.call()
    session.free()
    numbers = {n: (v, lim) for n, v, lim in session.check().numbers}
    assert numbers[fails][0] > numbers[fails][1]


def test_a_traced_run_of_the_trocr_cell_reads_nothing_from_a_cpu_trace(root):
    cell = load_cell(root, CELLS[0], 5, 0.5, True, "cpu")
    res = run(cell, time.perf_counter())["result"]
    assert res["metrics"] == {} and res["correct"] is True


def test_the_counts_at_the_published_widths():
    cfg = json.loads((REPO / "perfbench" / "configs" / "trocr-base-handwritten.json").read_text())
    assert counts_trocr.encode_flops(cfg) == pytest.approx(111e9, rel=0.01)
    assert 128 * counts_trocr.cross_kv_flops(cfg) == pytest.approx(2.79e12, rel=0.01)
    steps = sum(counts_trocr.step_flops(cfg, 512, t) for t in range(32))
    assert steps == pytest.approx(7.95e12, rel=0.01)
    assert counts_trocr.call_flops(128, cfg) == pytest.approx(14.2e12 + 2.79e12 + steps, rel=0.01)
    assert counts_trocr.step_weight_bytes(cfg) == pytest.approx(0.91e9, rel=0.01)
    least, n = counts_trocr.steps_least_ms(cfg, 128)
    assert n == 32 and 32 * 3.5 < least < 32 * 4.0  # FLOP-bound: ~3.7 ms a step at 67 TFLOP/s
    trba = json.loads((REPO / "perfbench" / "configs" / "trba-full.json").read_text())
    assert counts_trba_train.train_step_flops(2, trba) == 2 * counts_trba_train.train_step_flops(1, trba)


# One call: encode, a decode with its cross keys and values and two steps;
# the card idles from 130 to 150 inside the decode.
TROCR = {"traceEvents": [
    _x("bench.window", "user_annotation", 0, 300),
    _x("trocr.recognize", "user_annotation", 5, 280),
    _x("trocr.encode", "user_annotation", 10, 50),
    _x("trocr.decode", "user_annotation", 70, 200),
    _x("trocr.cross_kv", "user_annotation", 72, 10),
    _x("trocr.step", "user_annotation", 90, 30),
    _x("trocr.step", "user_annotation", 160, 100),
    _launch(20, 1), _kernel("gemm", 20, 40, 1),
    _launch(75, 2), _kernel("gemm", 75, 25, 2),
    _launch(95, 3), _kernel("gemm", 100, 20, 3),
    _launch(100, 4), _kernel("softmax", 120, 10, 4),
    _launch(165, 5), _kernel("gemm", 150, 100, 5),
]}


def _ctx(doc, calls, cell=None, counts=None):
    tr = trace.load(doc)
    start, end = tr.window("bench.window")
    return TraceContext(cell, tr, start, end, calls, counts or {})


def _read(name, ctx):
    return load_module(REPO / "perfbench" / "metrics" / f"{name}.py").read(ctx)


@pytest.mark.parametrize("name, want", [
    ("trocr_encode_ms", 40 / 1e3),
    ("trocr_decode_ms", (25 + 20 + 10 + 100) / 1e3),
    ("trocr_decode_idle_ms", (200 - 25 - 20 - 10 - 100) / 1e3),  # [70, 270] less the union
    ("trocr_step_launches", 3 / 2),
])
def test_a_trocr_metric_from_a_written_trace(name, want):
    assert _read(name, _ctx(TROCR, calls=1)) == pytest.approx(want)


def test_the_step_roofline_is_the_least_time_over_the_steps_device_time():
    cfg = json.loads((REPO / "perfbench" / "configs" / "trocr-base-handwritten.json").read_text())
    cell = type("Cell", (), {"config": cfg})()
    least, n = counts_trocr.steps_least_ms(cfg, 128)
    got = _read("trocr_step_roofline", _ctx(TROCR, 1, cell, {"lines": 128}))
    assert got == pytest.approx(100 * (least * 2 / n) / ((20 + 10 + 100) / 1e3))


@pytest.mark.parametrize("name", ["trocr_encode_ms", "trocr_decode_ms", "trocr_decode_idle_ms",
                                  "trocr_step_launches", "trocr_step_roofline"])
def test_a_trace_without_trocrs_regions_or_the_card_reads_nothing(name):
    old = {"traceEvents": [e for e in TROCR["traceEvents"]
                           if e["cat"] != "user_annotation" or not e["name"].startswith("trocr.")]}
    cpu = {"traceEvents": [e for e in TROCR["traceEvents"] if e["cat"] not in ("kernel", "cuda_runtime")]}
    for doc in (old, cpu):
        assert _read(name, _ctx(doc, 1, None, {"lines": 128})) is None


# Two TRBA training steps: a forward, a backward launched by autograd's
# worker (thread 2), an optimizer of two launches; the card idles 25 of the
# optimizer's 70 a step.
TRBA_TRAIN = {"traceEvents": [
    _x("bench.window", "user_annotation", 0, 700),
    *[e for at in (0, 330) for e in (
        _x("trba.forward", "user_annotation", at + 10, 90),
        _x("trba.backward", "user_annotation", at + 100, 130),
        _x("trba.optimizer", "user_annotation", at + 230, 70),
        _x("autograd::engine::evaluate_function: ConvolutionBackward0", "cpu_op", at + 110, 100, tid=2),
        _launch(at + 20, at + 1), _kernel("conv_fwd", at + 20, 60, at + 1),
        _launch(at + 120, at + 2, tid=2), _kernel("conv_bwd", at + 120, 100, at + 2),
        _launch(at + 235, at + 3), _kernel("adam", at + 235, 15, at + 3),
        _launch(at + 260, at + 4), _kernel("adam", at + 270, 30, at + 4),
    )],
]}


@pytest.mark.parametrize("name, want", [
    ("trba_pass_ms", (60 + 100) / 1e3),
    ("trba_optimizer_ms", (15 + 30) / 1e3),
    ("trba_optimizer_launches_per_step", 2),
    ("trba_optimizer_idle_ms", (70 - 15 - 30) / 1e3),  # [230, 300] less [235, 250] and [270, 300]
])
def test_a_trba_training_metric_from_a_written_trace(name, want):
    assert _read(name, _ctx(TRBA_TRAIN, calls=2)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["trba_pass_ms", "trba_optimizer_ms", "trba_optimizer_launches_per_step",
                                  "trba_optimizer_idle_ms"])
def test_a_trace_without_trbas_training_regions_or_the_card_reads_nothing(name):
    old = {"traceEvents": [e for e in TRBA_TRAIN["traceEvents"]
                           if e["cat"] != "user_annotation" or not e["name"].startswith("trba.")]}
    cpu = {"traceEvents": [e for e in TRBA_TRAIN["traceEvents"] if e["cat"] not in ("kernel", "cuda_runtime")]}
    for doc in (old, cpu):
        assert _read(name, _ctx(doc, 2)) is None
