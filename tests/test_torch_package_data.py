"""An installed port holds every file that its code opens at run time: the
package-data globs of ``pyproject.toml`` match each source that
``ops/_build.py`` builds, the reference numbers that ``utils/quality.py``
reads, and the data files of ``utils/synthetic.py``."""

import fnmatch
import tomllib
from pathlib import Path

import pytest

from manuscript_tpu_torch.ops import _build
from manuscript_tpu_torch.utils import quality, synthetic, weights

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "manuscript_tpu_torch"


def globs():
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    return config["tool"]["setuptools"]["package-data"]["manuscript_tpu_torch"]


def opened_files():
    files = [_build._source(n) for n in _build.SOURCES]
    files += [quality.QUALITY_REFERENCE, synthetic.GLYPHS, weights.PINNED_HASHES_FILE]
    return files


@pytest.mark.parametrize("path", opened_files(), ids=lambda p: p.name)
def test_package_data_holds_the_file(path):
    rel = path.relative_to(PACKAGE).as_posix()
    assert any(fnmatch.fnmatch(rel, g) for g in globs()), (rel, globs())


def test_the_host_lanms_and_the_reference_numbers_are_package_data():
    matched = {p.relative_to(PACKAGE).as_posix() for g in globs() for p in PACKAGE.glob(g)}
    assert {"csrc/lanms.cpp", "csrc/attention_step.cu", "csrc/quad_iou.cu",
            "configs/quality_reference.json", "configs/synthetic_glyphs.npz"} <= matched
