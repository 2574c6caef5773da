"""Fixtures of the benchmark's CPU tests: a checkout in a temporary folder
with cells at tiny sizes, which the harness finds and runs on the CPU."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
os.environ.setdefault("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
os.environ.setdefault("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", "1")

TRBA_TINY = {"cnn_stage_plan": "micro", "cnn_out_channels": 128, "img_h": 32, "img_w": 128,
             "hidden_size": 64, "max_length": 25, "beam_size": 3}
EAST_TINY = {"backbone": "resnet50-micro", "target_size": 128, "batch_size": 2}
RECOGNIZE_TINY = {"batch_size": 6, "strips": 18, "warmup_calls": 1, "check_strips": 8, "trace_calls": 2}
TRAIN_TINY = {"pages": 6, "line_height": [8, 14], "word_width": [12, 40], "gap": [4, 10],
              "trace_calls": 2}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1, ensure_ascii=False))


def make_root(tmp: Path, limits=None) -> Path:
    """A checkout in ``tmp``: a copy of ``perfbench/`` with the cells
    ``trba-tiny.recognize-tiny`` and ``east-tiny.train-tiny`` added by data
    files and a ``BENCHMARK.json`` of their own, with ``limits`` (name →
    limit) over the configurations' own."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    for name, base, tiny, fam in (("trba-tiny", "trba-full", TRBA_TINY, "trba"),
                                  ("east-tiny", "east-r101", EAST_TINY, "east")):
        cfg = json.loads((pb / "configs" / f"{base}.json").read_text())
        cfg.update(tiny)
        cfg["limits"] = {k: (limits or {}).get(k, v) for k, v in cfg["limits"].items()}
        _write(pb / "configs" / f"{name}.json", cfg)
        bench["configs"].append({"name": name, "source": "https://github.com/olegiy/manuscript-ocr",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": sorted(tiny), "why": f"tiny {fam} for the CPU tests"})
    for name, base, tiny in (("recognize-tiny", "recognize-b512", RECOGNIZE_TINY),
                             ("train-tiny", "train-b3", TRAIN_TINY)):
        traffic = json.loads((pb / "traffic" / f"{base}.json").read_text())
        traffic.update(tiny)
        _write(pb / "traffic" / f"{name}.json", traffic)
    r, e = "trba-tiny.recognize-tiny", "east-tiny.train-tiny"
    bench["workloads"] += [
        {"name": r, "config": "trba-tiny", "traffic": "recognize-tiny", "chips": 1, "why": "CPU test"},
        {"name": e, "config": "east-tiny", "traffic": "train-tiny", "chips": 1, "why": "CPU test"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for full, tiny in (("trba-full.recognize-b512", r), ("east-r101.train-b3", e)):
            if full in m.get("workloads", []):
                m["workloads"].append(tiny)
    _write(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA card, or a skip: the decision is made here, at run time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
