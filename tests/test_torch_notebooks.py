"""The port's notebooks (``notebooks/torch_port/``) and example scripts
(``examples/torch_port/``): every notebook is valid nbformat 4, committed
without outputs, its code compiles, its first cell sets ``DEVICE = "cuda"``,
and each JAX notebook has a counterpart by name; no script and no notebook
imports JAX, flax or the JAX package; and the three inference notebooks run
cell by cell on the CPU (``DEVICE = "cpu"``), one namespace each, in a
temporary directory."""

import ast
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_NB = ROOT / "notebooks" / "torch_port"
NOTEBOOKS = sorted(PORT_NB.glob("*.ipynb"))
SCRIPTS = sorted((ROOT / "examples" / "torch_port").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "manuscript_tpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: beside the suite's other workers, torch's
    OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def code_cells(path: Path):
    nb = json.loads(path.read_text())
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def imported(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_every_jax_notebook_has_a_port():
    jax_names = {p.name for p in (ROOT / "notebooks").glob("*.ipynb")}
    assert len(jax_names) == 5
    assert jax_names == {p.name for p in NOTEBOOKS}


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_valid_and_without_outputs(path):
    nb = json.loads(path.read_text())
    assert nb["nbformat"] >= 4
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert cells and all(c["outputs"] == [] and c["execution_count"] is None for c in cells)
    sources = code_cells(path)
    for i, src in enumerate(sources):
        compile(src, f"{path.name}[{i}]", "exec")
    assert 'DEVICE = "cuda"' in sources[0]
    assert not any("TPU" in "".join(c["source"]) for c in nb["cells"]), path.name


@pytest.mark.parametrize("path", SCRIPTS + NOTEBOOKS, ids=lambda p: p.name)
def test_port_example_imports_no_jax(path):
    sources = code_cells(path) if path.suffix == ".ipynb" else [path.read_text()]
    mods = [m for src in sources for m in imported(src)]
    assert mods, path.name
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, (path.name, bad)


def test_every_jax_example_has_a_port_or_a_reason():
    """The JAX package's scripts, each ported by name but for two: the
    Pallas bench is ``kernel_bench``, and ``_timing``/``serve_bench`` are
    not ported (the README's table gives the reasons)."""
    jax_scripts = {p.stem for p in (ROOT / "examples").glob("*.py")}
    port = {p.stem for p in SCRIPTS}
    assert port == (jax_scripts - {"pallas_bench", "_timing", "serve_bench"}) | {"kernel_bench"}
    readme = (ROOT / "README.md").read_text()
    for name in ("_timing.py", "serve_bench.py"):
        assert f"`examples/{name}`" in readme


@pytest.mark.parametrize("name", ["quickstart", "detector_inference", "detector_latency"])
def test_inference_notebook_runs_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    namespace = {"__name__": "__main__"}
    for i, src in enumerate(code_cells(PORT_NB / f"{name}.ipynb")):
        if i == 0:
            src = src.replace('DEVICE = "cuda"', 'DEVICE = "cpu"')
        exec(compile(src, f"{name}[{i}]", "exec"), namespace)
    assert namespace["DEVICE"] == "cpu"
    assert (tmp_path / "notebook_work" / "page0.png").exists()
