"""``examples/torch_port/make_quality_ckpt.py`` on the CPU at tiny size: the
test (not the script) shrinks its dataset builders, its TRBA config and its
evaluation to a few pages and crops and one EAST epoch. The script writes
only inside its workdir, prints its evaluations beside the JAX-trained
pair's numbers, and ``EAST``/``TRBA`` load the checkpoints it wrote."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "examples" / "torch_port" / "make_quality_ckpt.py"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: beside the suite's other workers, torch's
    OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load():
    spec = importlib.util.spec_from_file_location("torch_port_make_quality_ckpt", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshot(root: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_make_quality_ckpt_writes_only_its_workdir(tmp_path, monkeypatch, capsys):
    mq = load()
    words, pages = mq.build_word_dataset, mq.build_page_dataset
    monkeypatch.setattr(mq, "build_word_dataset", lambda root, n, seed: words(root, n=24, seed=seed))
    monkeypatch.setattr(mq, "build_page_dataset",
                        lambda root, n_pages, seed: pages(root, n_pages=8 if n_pages > 12 else 2,
                                                          seed=seed))
    monkeypatch.setattr(mq, "TRBA_CONFIG", dict(mq.TRBA_CONFIG, epochs=1, batch_size=8))
    monkeypatch.setattr(mq, "EVAL_PAGES", 1)
    monkeypatch.setenv("QUALITY_EAST_EPOCHS", "1")
    monkeypatch.chdir(tmp_path)
    watched = [ROOT / "manuscript_tpu", ROOT / "manuscript_tpu_torch" / "configs", ROOT / "examples"]
    before = {d: _snapshot(d) for d in watched}

    results = mq.main([str(tmp_path / "work"), "--cpu"])

    assert {d: _snapshot(d) for d in watched} == before
    written = {p.relative_to(tmp_path).parts[0] for p in tmp_path.rglob("*")}
    assert written == {"work"}
    out_dir = tmp_path / "work" / "quality"
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "east_micro.json", "east_micro.msgpack", "trba_micro.msgpack"]
    meta = json.loads((out_dir / "east_micro.json").read_text())
    assert meta["backbone"] == "resnet50-micro" and meta["score_thresh"] in (
        0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    assert set(results) == {"fused greedy", "fused beam", "fused beam crop_scale=2",
                            "classic host crops"}
    printed = capsys.readouterr().out
    assert printed.count("JAX-trained pair") == 3

    from manuscript_tpu_torch import EAST, TRBA

    east = EAST(out_dir / "east_micro.msgpack", device="cpu", backbone="resnet50-micro",
                target_size=512)
    trba = TRBA(out_dir / "trba_micro.msgpack", device="cpu")
    assert east.backbone == "resnet50-micro" and trba.model.decoder.h2h_kernel.shape == (64, 64)
