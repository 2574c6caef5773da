"""The port's command line (``python -m manuscript_tpu_torch``): the cases of
``tests/test_cli.py`` with fake backends put in place of the Pipeline/EAST/
TRBA constructors, the page JSON equal to the JAX package's for the same
Page, and the parts that wait for later refused by the parser."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import manuscript_tpu_torch.__main__ as cli
from manuscript_tpu.types import Block as JBlock
from manuscript_tpu.types import Page as JPage
from manuscript_tpu.types import Word as JWord
from manuscript_tpu_torch.types import Block, Page, Word

ROOT = Path(__file__).resolve().parent.parent


def _fake_page(types=(Page, Block, Word)):
    P, B, W = types
    return P(blocks=[B(words=[W(polygon=[(1, 1), (9, 1), (9, 5), (1, 5)], detection_confidence=0.9,
                                text="hello", recognition_confidence=0.8)])])


@pytest.fixture
def image_file(tmp_path):
    p = tmp_path / "page.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(p)
    return str(p)


class FakePipe:
    def __init__(self, **kw):
        self.kw = kw
        self.batches = []

    def predict(self, image, vis=False, profile=False):
        return _fake_page()

    def process_batch(self, images, profile=False):
        self.batches.append(len(images))
        return [_fake_page() for _ in images]

    def get_text(self, page):
        return "hello"


def test_ocr_command_writes_the_jax_packages_json(monkeypatch, image_file, tmp_path):
    seen = {}
    monkeypatch.setattr("manuscript_tpu_torch.Pipeline",
                        lambda **kw: seen.setdefault("p", FakePipe(**kw)))
    out_json = tmp_path / "r.json"
    cli.main(["ocr", image_file, "--out", str(out_json), "--max-words", "32"])
    data = json.loads(out_json.read_text())
    assert data["text"] == "hello"
    assert data["page"] == json.loads(json.dumps(_fake_page((JPage, JBlock, JWord)).model_dump()))
    assert seen["p"].kw == dict(mode="beam", batch_pages=4, max_words=32, crop_scale=1,
                                crop_source="native", mesh=None)


def test_ocr_command_multi_image_batches(monkeypatch, capsys, image_file, tmp_path):
    """Several images ride process_batch; --out gets one file per image,
    indexed when two inputs share a stem."""
    pipes = []
    monkeypatch.setattr("manuscript_tpu_torch.Pipeline",
                        lambda **kw: pipes.append(FakePipe(**kw)) or pipes[-1])
    cli.main(["ocr", image_file, image_file, "--mode", "greedy"])
    assert pipes[-1].batches == [2]
    assert capsys.readouterr().out.count("hello") == 2
    other = tmp_path / "b" / "page.png"  # the same stem in another folder
    other.parent.mkdir()
    other.write_bytes(Path(image_file).read_bytes())
    cli.main(["ocr", image_file, str(other), "--out", str(tmp_path / "r.json")])
    assert sorted(p.name for p in tmp_path.glob("r.*.json")) == ["r.page.0.json", "r.page.1.json"]


def test_detect_command(monkeypatch, capsys, image_file, tmp_path):
    seen = {}

    class FakeEAST:
        def __init__(self, **kw):
            seen.update(kw)

        def predict(self, image, vis=False, profile=False):
            return {"page": _fake_page(), "vis_image": None}

    import manuscript_tpu_torch.detectors as d

    monkeypatch.setattr(d, "EAST", FakeEAST)
    cli.main(["detect", image_file, "--thresh", "0.8", "--out", str(tmp_path / "b.json")])
    assert "1 words" in capsys.readouterr().out
    assert seen == dict(weights_path=None, target_size=1280, score_thresh=0.8)
    assert json.loads((tmp_path / "b.json").read_text())["blocks"][0]["words"][0]["text"] == "hello"


def test_recognize_command(monkeypatch, capsys, image_file):
    class FakeTRBA:
        def __init__(self, **kw):
            pass

        def predict(self, images, batch_size=32, mode="beam", beam_size=8):
            return [{"text": "word", "confidence": 0.75} for _ in images]

    import manuscript_tpu_torch.recognizers as r

    monkeypatch.setattr(r, "TRBA", FakeTRBA)
    cli.main(["recognize", image_file, "--mode", "greedy"])
    out = capsys.readouterr().out
    assert "word" in out and "0.7500" in out


@pytest.mark.parametrize("argv", [["nonsense"]])
def test_unknown_or_unported_commands_exit(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)


@pytest.mark.parametrize("command", ["ocr", "serve"])
def test_n_devices_builds_a_mesh(monkeypatch, image_file, command):
    """--n-devices N hands the Pipeline a data mesh over the first N cards
    (as tests/test_cli.py::test_ocr_n_devices_builds_mesh); the default
    builds none. Two cards are faked: this machine has none."""
    import manuscript_tpu_torch.serve as serve

    import torch

    pipes = []
    monkeypatch.setattr("manuscript_tpu_torch.Pipeline",
                        lambda **kw: pipes.append(FakePipe(**kw)) or pipes[-1])

    class FakeServer:
        def __init__(self, pipe, **kw):
            self.port, self.batch_pages = 0, 4

        def serve_forever(self):
            pass

    monkeypatch.setattr(serve, "OCRServer", FakeServer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    argv = [command] + ([image_file] if command == "ocr" else [])
    cli.main(argv)
    assert pipes[-1].kw["mesh"] is None
    cli.main(argv + ["--n-devices", "2"])
    mesh = pipes[-1].kw["mesh"]
    assert mesh.shape == {"data": 2, "model": 1}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="requested 3 devices but only 2 available"):
        cli.main(argv + ["--n-devices", "3"])


def test_bench_command_runs_the_ports_bench(monkeypatch):
    """``bench`` runs manuscript_tpu_torch/bench.py's main (the bench itself
    runs in tests/test_torch_bench.py)."""
    from manuscript_tpu_torch import bench

    calls = []
    monkeypatch.setattr(bench, "main", lambda: calls.append("main"))
    monkeypatch.setattr(bench, "perf_gate", lambda: calls.append("perf_gate"))
    cli.main(["bench"])
    assert calls == ["main"]


def test_sweep_report_command(tmp_path, capsys):
    from manuscript_tpu_torch.utils.sweep import Study, sweep_report

    Study({"a": ("float", 0.0, 1.0), "m": ("cat", ["x", "y"])}, storage=str(tmp_path / "s.json"),
          n_warmup=1).optimize(lambda p: p["a"], 3)
    cli.main(["sweep-report", str(tmp_path / "s.json"), "--out", str(tmp_path / "r.html")])
    out = capsys.readouterr().out
    assert out == sweep_report(tmp_path / "s.json") + "\n" and "3 trials" in out
    assert "Best trial" in (tmp_path / "r.html").read_text()


def test_main_enables_the_kernel_cache(monkeypatch, tmp_path):
    """Every command starts with MANUSCRIPT_TPU_KERNEL_CACHE's directory as
    the kernels' build directory."""
    from manuscript_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "cache_dir", None)
    monkeypatch.setenv("MANUSCRIPT_TPU_KERNEL_CACHE", str(tmp_path / "kernels"))
    Path(tmp_path / "s.json").write_text('{"direction": "maximize", "trials": []}')
    cli.main(["sweep-report", str(tmp_path / "s.json")])
    assert _build.build_dir() == tmp_path / "kernels" and (tmp_path / "kernels").is_dir()


def test_module_runs_as_a_program():
    out = subprocess.run([sys.executable, "-m", "manuscript_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for command in ("ocr", "detect", "recognize", "serve", "bench", "sweep-report"):
        assert command in out.stdout
