"""The port's own docs as tests, on the CPU: every python block of
``docs/torch_port/*.md`` and of the README's port section parses; the CPU
quick start of ``docs/torch_port/DEPLOYMENT.md`` runs end to end on the
committed micro checkpoints; and every third-party package that
``manuscript_tpu_torch/`` imports, at module level or inside a function, is
named in ``pyproject.toml``'s ``dependencies`` or its ``torch`` extra.
(``tests/test_docs.py`` covers ``docs/*.md``, the README and the root
``DEPLOYMENT.md`` for the JAX package.)"""

import ast
import re
import sys
import tomllib
from collections import Counter
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_DOCS = sorted((ROOT / "docs" / "torch_port").glob("*.md"))
FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)
# an import name → its distribution's name, where they differ
DISTRIBUTIONS = {"PIL": "pillow", "cv2": "opencv-python-headless"}


def readme_port_section() -> str:
    text = (ROOT / "README.md").read_text()
    start = text.index("\n## PyTorch / H100 port\n")
    return text[start:text.index("\n## ", start + 1)]


def python_blocks():
    sources = [(p.name, p.read_text()) for p in PORT_DOCS]
    sources.append(("README.md (port)", readme_port_section()))
    return [pytest.param(code, id=f"{name}#{i}")
            for name, text in sources for i, code in enumerate(FENCE.findall(text))]


def test_the_port_docs_exist():
    assert [p.name for p in PORT_DOCS] == ["API.md", "DEPLOYMENT.md"]
    assert "docs/torch_port/" in readme_port_section()


@pytest.mark.parametrize("code", python_blocks())
def test_python_block_parses(code):
    ast.parse(code)


def test_cpu_quick_start_runs(capsys):
    """The quick start as written: the micro checkpoints on the CPU, one
    held-out synthetic page, ``Pipeline.predict``, the text printed."""
    text = (ROOT / "docs" / "torch_port" / "DEPLOYMENT.md").read_text()
    quick = [code for code in FENCE.findall(text) if 'load_quality_models("cpu")' in code]
    assert len(quick) == 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scope = {}
        exec(compile(quick[0], "DEPLOYMENT.md", "exec"), scope)
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out.strip()
    assert printed and printed == scope["pipe"].get_text(scope["page"])
    truth = Counter(w["text"] for w in scope["words"])
    assert sum((Counter(printed.split()) & truth).values()) >= 0.8 * sum(truth.values())


def _third_party_imports():
    """(import name, at module level) of every import in the port."""
    found = set()
    for path in (ROOT / "manuscript_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        top = set()
        stack = list(tree.body)
        while stack:  # statements outside every function and class body
            node = stack.pop()
            top.add(id(node))
            if isinstance(node, (ast.If, ast.Try)):
                stack += node.body + node.orelse + getattr(node, "finalbody", [])
                stack += [s for h in getattr(node, "handlers", []) for s in h.body]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                name = name.split(".")[0]
                if name not in sys.stdlib_module_names and name != "manuscript_tpu_torch":
                    found.add((name, id(node) in top))
    return found


def test_every_third_party_import_is_declared():
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]
    declared = {re.split(r"[<>=!~\[; ]", d, maxsplit=1)[0].lower()
                for d in project["dependencies"] + project["optional-dependencies"]["torch"]}
    found = _third_party_imports()
    assert {name for name, at_top in found if at_top} == {"numpy", "torch"}
    for name, _ in found:
        assert DISTRIBUTIONS.get(name, name).lower() in declared, name
    # the extra adds nothing that the JAX package's list already names
    assert not set(project["optional-dependencies"]["torch"]) & set(project["dependencies"])
