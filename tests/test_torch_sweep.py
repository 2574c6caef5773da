"""The port's hyperparameter search (``manuscript_tpu_torch/utils/sweep.py``)
against the JAX package's: the same seed and objective give the same trials,
each package resumes the other's storage, and the reports are equal."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from manuscript_tpu import __main__ as jcli
from manuscript_tpu.utils import sweep as jsweep
from manuscript_tpu_torch.utils import sweep

ROOT = Path(__file__).resolve().parent.parent
SPACE = {
    "mode": ("cat", ["greedy", "beam"]),
    "beam_size": ("int", 2, 12),
    "alpha": ("float", 0.0, 1.0),
    "temperature": ("float", 0.7, 2.0),
    "lr": ("float", 1e-5, 1e-1, "log"),
}


def objective(p):
    """A smooth, seed-free objective over every kind of parameter."""
    return (
        (0.3 if p["mode"] == "beam" else 0.0)
        - (p["beam_size"] - 8) ** 2 / 50
        - (p["alpha"] - 0.9) ** 2
        - (p["temperature"] - 1.7) ** 2
        - (np.log10(p["lr"]) + 3) ** 2 / 10
    )


@pytest.mark.parametrize("sampler", ["tpe", "guided"])
@pytest.mark.parametrize("direction", ["maximize", "minimize"])
def test_same_seed_gives_the_same_trials(sampler, direction):
    studies = [mod.Study(SPACE, direction=direction, seed=3, n_warmup=6, sampler=sampler)
               for mod in (jsweep, sweep)]
    best = [s.optimize(objective, 20) for s in studies]
    assert [t["params"] for t in studies[1].trials] == [t["params"] for t in studies[0].trials]
    assert [t["value"] for t in studies[1].trials] == [t["value"] for t in studies[0].trials]
    assert best[1]["number"] == best[0]["number"] and best[1]["params"] == best[0]["params"]
    assert studies[1].summary() == studies[0].summary()


@pytest.mark.parametrize("suffix", [".json", ".db"])
def test_a_jax_study_resumes_in_the_port(tmp_path, suffix):
    written = tmp_path / f"jax{suffix}"
    jsweep.Study(SPACE, storage=written, direction="minimize", seed=1, n_warmup=4).optimize(
        lambda p: -objective(p), 9)
    copy = tmp_path / f"copy{suffix}"
    shutil.copy(written, copy)
    # a bare reopen reads the stored direction back, as the JAX Study does
    port, jax_again = sweep.Study(SPACE, storage=copy, seed=1), jsweep.Study(SPACE, storage=written, seed=1)
    assert port.direction == jax_again.direction == "minimize"
    assert port.trials == jax_again.trials and len(port.trials) == 9
    port.optimize(lambda p: -objective(p), 4)
    jax_again.optimize(lambda p: -objective(p), 4)
    assert [t["number"] for t in port.trials] == list(range(13))
    assert [t["params"] for t in port.trials] == [t["params"] for t in jax_again.trials]
    assert sweep.load_study(copy)[0][:9] == jsweep.load_study(written)[0][:9]


@pytest.mark.parametrize("suffix", [".json", ".db"])
def test_sweep_report_text_equals_the_jax_report(tmp_path, suffix):
    storage = tmp_path / f"s{suffix}"
    sweep.Study(SPACE, storage=storage, seed=5, n_warmup=3).optimize(objective, 7)
    html = tmp_path / "port.html"
    text = sweep.sweep_report(storage, out_html=html)
    assert text == jsweep.sweep_report(storage, out_html=tmp_path / "jax.html")
    assert "7 trials" in text and "best:" in text and "categorical means: mode:" in text
    page = html.read_text()
    assert page == (tmp_path / "jax.html").read_text()
    assert "<svg" in page and "Best trial" in page and "value vs alpha" in page
    assert sweep.sweep_report(tmp_path / f"none{suffix}") == jsweep.sweep_report(
        tmp_path / f"none{suffix}")


def test_the_cli_sweep_report_prints_what_the_jax_cli_prints(tmp_path, capsys):
    storage = tmp_path / "study.db"
    sweep.Study(SPACE, storage=storage, seed=2, n_warmup=2).optimize(objective, 5)
    jcli.main(["sweep-report", str(storage), "--out", str(tmp_path / "jax.html")])
    want = capsys.readouterr().out
    out = subprocess.run(
        [sys.executable, "-m", "manuscript_tpu_torch", "sweep-report", str(storage),
         "--out", str(tmp_path / "port.html")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout == want and "5 trials" in want
    assert (tmp_path / "port.html").read_text() == (tmp_path / "jax.html").read_text()
