"""The port's training examples on the CPU at tiny size
(``examples/torch_port/``): ``train_synthetic`` on a few words,
``train_at_scale`` in its smoke mode (``MANUSCRIPT_TPU_BENCH_SMOKE=1``) with
its descent and resume checks passing
(``test_torch_examples_quality.py`` has ``make_quality_ckpt``). Each
script's ``main(argv)`` runs in this process with ``--cpu``."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch_port"


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


def test_train_synthetic_trains_and_checkpoints(tmp_path):
    out = load("train_synthetic").main([str(tmp_path / "run"), "--words", "24", "--epochs", "1",
                                        "--cpu"])
    assert 0.0 <= out["val_acc"] <= 1.0 and out["val_loss"] == out["val_loss"]
    ckpts = Path(out["exp_dir"]) / "checkpoints"
    assert (ckpts / "last.msgpack").exists() and (ckpts / "last_state.msgpack").exists()


def test_train_at_scale_smoke_descends_and_resumes(monkeypatch, capsys):
    monkeypatch.setenv("MANUSCRIPT_TPU_BENCH_SMOKE", "1")
    assert load("train_at_scale").main(["--cpu"]) == 0
    lines = {ln["metric"]: ln for ln in map(json.loads, (
        t for t in capsys.readouterr().out.splitlines() if t.startswith("{")))}
    assert lines["train_at_scale_env"]["steps"] == 12
    for part in ("east", "trba"):
        assert lines[f"{part}_scale_train"]["steps_per_sec"] > 0
        loss = lines[f"{part}_scale_loss"]
        assert loss["descended"] and loss["resumed_ok"], loss
        assert loss["loss_last"] < loss["loss_first"]
    assert lines["train_at_scale_result"] == {"metric": "train_at_scale_result", "ok": True,
                                              "device": "cpu"}


@pytest.mark.parametrize("name,argv", [
    ("train_synthetic", ["run"]),
    ("train_at_scale", []),
    ("make_quality_ckpt", ["work"]),
])
def test_without_cpu_flag_a_script_needs_the_card(name, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(name).main(argv)
