"""The port's example scripts of inference on the CPU
(``examples/torch_port/``): ``parity_check`` against both fixtures that the
JAX package committed, and the user demos on tiny synthetic pages and crops
with the committed micro checkpoints. Each script's ``main(argv)`` runs in
this process with ``--cpu``; without it a script needs a card and raises."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from manuscript_tpu_torch import Pipeline
from manuscript_tpu_torch.ops.image import encode_png
from manuscript_tpu_torch.utils.synthetic import build_word_dataset, render_page

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch_port"
FIXTURES = {9100: ROOT / "examples" / "parity_fixture.json",
            9200: ROOT / "examples" / "parity_fixture_beam.json"}


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


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three rendered pages as PNG files and 24 word crops with labels."""
    root = tmp_path_factory.mktemp("demo_data")
    rng = np.random.default_rng(100)
    pages = []
    for i in range(3):
        page, _ = render_page(rng)
        path = root / f"page{i}.png"
        path.write_bytes(encode_png(page))
        pages.append(str(path))
    tsv, img_dir = build_word_dataset(root / "words", n=24, seed=4)
    return {"pages": pages, "tsv": tsv, "crops": img_dir}


@pytest.mark.parametrize("seed", sorted(FIXTURES))
def test_parity_check_reproduces_the_jax_fixture(seed, capsys):
    """Every fixture word matched at IoU ≥ 0.7 and every text equal: 24/24
    greedy at capacity 64, 28/28 beam at auto capacity."""
    pc = load("parity_check")
    status = pc.main(["--cpu", "--quality", "--synthetic", str(seed),
                      "--fixture", str(FIXTURES[seed])])
    out = capsys.readouterr().out
    n = len(json.loads(FIXTURES[seed].read_text())["words"])
    assert status == 0, out
    assert re.search(rf"boxes: {n} matched / {n} fixture \(IoU>=0.7 F1=1.000\)", out), out
    assert f"texts: {n}/{n} exact" in out and "PARITY OK" in out and "differs" not in out
    assert n == {9100: 24, 9200: 28}[seed]


@pytest.mark.parametrize("fixture", [None, *FIXTURES.values()], ids=["default", "greedy", "beam"])
def test_write_fixture_refuses_the_committed_fixtures(fixture):
    before = {p: p.read_bytes() for p in FIXTURES.values()}
    argv = ["--cpu", "--quality", "--synthetic", "9100", "--write-fixture"]
    with pytest.raises(SystemExit) as err:
        load("parity_check").main(argv + ([] if fixture is None else ["--fixture", str(fixture)]))
    assert err.value.code == 2
    assert {p: p.read_bytes() for p in FIXTURES.values()} == before


def test_written_fixture_checks_against_itself(tmp_path, capsys):
    pc = load("parity_check")
    path = tmp_path / "mine.json"
    assert pc.main(["--cpu", "--quality", "--synthetic", "9300", "--write-fixture",
                    "--fixture", str(path), "--mode", "beam", "--max-words", "auto"]) == 0
    written = json.loads(path.read_text())
    assert written["mode"] == "beam" and written["max_words"] == "auto" and written["words"]
    assert pc.main(["--cpu", "--quality", "--synthetic", "9300", "--fixture", str(path)]) == 0
    assert "PARITY OK" in capsys.readouterr().out


def test_pipeline_infer_draws_and_reads_the_page(data, tmp_path, capsys):
    out = tmp_path / "vis.png"
    page = load("pipeline_infer").main([data["pages"][0], "--cpu", "--quality", "--out", str(out)])
    words = [w for b in page.blocks for w in b.words]
    assert len(words) >= 20 and sum(bool(w.text) for w in words) >= 20
    assert out.exists() and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    text = capsys.readouterr().out
    assert "device: cpu" in text and words[0].text in text


def test_east_infer_prints_the_stage_timings(data, tmp_path, capsys):
    out = tmp_path / "east.png"
    result = load("east_infer").main([data["pages"][1], "--cpu", "--quality", "--out", str(out)])
    n = sum(len(b.words) for b in result["page"].blocks)
    assert n >= 20 and out.exists()
    text = capsys.readouterr().out
    assert f"detected {n} words; stages (host clock) on cpu: prep" in text and "lanms" in text


def test_trba_infer_times_both_decodes(data, capsys):
    rates = load("trba_infer").main([str(Path(data["crops"]) / "*.png"), "--cpu", "--quality"])
    assert set(rates) == {"greedy", "beam"} and all(r > 0 for r in rates.values())
    assert capsys.readouterr().out.count("crops/s on cpu") == 2


def test_batch_infer_reads_every_page(data, capsys):
    pages = load("batch_infer").main([*data["pages"], "--cpu", "--quality"])
    assert len(pages) == 3
    assert all(sum(len(b.words) for b in p.blocks) >= 20 for p in pages)
    assert "3 pages in" in capsys.readouterr().out
    globbed = load("batch_infer").main(["--glob", str(Path(data["pages"][0]).parent / "*.png"),
                                        "--cpu", "--quality"])
    assert [Pipeline.get_text(p) for p in globbed] == [Pipeline.get_text(p) for p in pages]


def test_trba_metrics_scores_the_micro_recognizer(data, capsys):
    metrics = load("trba_metrics").main([data["tsv"], data["crops"], "--cpu", "--quality"])
    assert metrics["accuracy"] >= 0.8 and metrics["cer"] <= 0.1 and metrics["fps"] > 0
    assert "Accuracy:" in capsys.readouterr().out


def test_decode_sweep_stores_its_study(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("N_TRIALS", "3")
    best = load("decode_sweep").main([data["tsv"], data["crops"], "--cpu", "--quality"])
    assert 0.8 <= best["value"] <= 1.0 and set(best["params"]) == {
        "mode", "beam_size", "alpha", "temperature"}
    assert (tmp_path / "decode_sweep_study.json").exists()


@pytest.mark.parametrize("name,argv", [
    ("parity_check", ["--quality", "--synthetic", "9100"]),
    ("pipeline_infer", ["page.png", "--quality"]),
    ("east_infer", ["page.png", "--quality"]),
    ("trba_infer", ["*.png", "--quality"]),
    ("batch_infer", ["page.png", "--quality"]),
    ("trba_metrics", ["labels.tsv", "images", "--quality"]),
    ("decode_sweep", ["labels.tsv", "images", "--quality"]),
])
def test_without_cpu_flag_a_script_needs_the_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(name).main(argv)
