"""The port's host layer: numpy resizes against cv2 (byte-equal), the
msgpack reader against flax, the dataclass DTOs, charset, reading order and
crops against the JAX package, and the import boundary (no JAX, flax, cv2,
PIL, pydantic, msgpack or manuscript_tpu in the port or chip_smoke.py)."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import flax.serialization

from manuscript_tpu import types as jtypes
from manuscript_tpu.ops import image as jimage
from manuscript_tpu.ops.boxes import quad_bbox_int as j_bbox
from manuscript_tpu.ops.reading_order import reading_order_permutation as j_order
from manuscript_tpu.recognizers import charset as jcharset
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu_torch import types
from manuscript_tpu_torch.ops import image
from manuscript_tpu_torch.ops.boxes import quad_bbox_int
from manuscript_tpu_torch.ops.reading_order import reading_order_permutation
from manuscript_tpu_torch.recognizers import charset
from manuscript_tpu_torch.utils.weights import msgpack_restore

ROOT = Path(__file__).resolve().parent.parent


def _sizes(i):
    rng = np.random.default_rng(1000 + i)
    src = tuple(int(v) for v in rng.integers(1, 420, 2))
    dst = tuple(int(v) for v in rng.integers(1, 420, 2))
    return rng, src, dst


@pytest.mark.parametrize("i", range(50))
def test_resize_is_byte_equal_to_cv2(i):
    """INTER_LINEAR both ways, INTER_AREA shrinks, the recognizer's
    resize-and-pad and the detector's page resize, on random sizes."""
    rng, (h, w), (oh, ow) = _sizes(i)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize_u8(img, oh, ow), cv2.resize(img, (ow, oh)))
    sh, sw = max(1, min(oh, h)), max(1, min(ow, w))
    np.testing.assert_array_equal(
        image.resize_u8(img, sh, sw, area=True),
        cv2.resize(img, (sw, sh), interpolation=cv2.INTER_AREA),
    )
    np.testing.assert_array_equal(image.resize_and_pad(img, 64, 256), jimage.resize_and_pad(img, 64, 256))
    np.testing.assert_array_equal(
        image.detector_preprocess_host(img, 96 + 8 * i), jimage.detector_preprocess_host(img, 96 + 8 * i)
    )


@pytest.mark.parametrize("src,dst", [((1024, 768), (512, 512)), ((128, 300), (64, 150)),
                                     ((90, 270), (30, 90)), ((2, 200), (1, 100))])
def test_resize_integer_shrinks_are_byte_equal_to_cv2(src, dst):
    img = np.random.default_rng(0).integers(0, 256, (*src, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize_u8(img, *dst), cv2.resize(img, dst[::-1]))
    np.testing.assert_array_equal(
        image.resize_u8(img, *dst, area=True),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA),
    )


@pytest.mark.parametrize("name", ["east_micro", "trba_micro"])
def test_msgpack_reader_matches_flax(name):
    data = (QUALITY_DIR / f"{name}.msgpack").read_bytes()
    ref, got = flax.serialization.msgpack_restore(data), msgpack_restore(data)

    def same(a, b):
        if isinstance(a, dict):
            assert isinstance(b, dict) and set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b

    same(ref, got)


def test_msgpack_reader_scalars_and_containers():
    import msgpack

    obj = {"a": [1, -3, 2**40, -(2**33), 1.5, None, True, "ü" * 40, b"\x00" * 300],
           "nested": {"x": list(range(20))}}
    assert msgpack_restore(msgpack.packb(obj, use_bin_type=True)) == obj


def test_dataclasses_mirror_the_pydantic_models():
    for name in ("Word", "Block", "Page"):
        fields = {f.name for f in dataclasses.fields(getattr(types, name))}
        assert fields == set(getattr(jtypes, name).model_fields)
    w = types.Word(polygon=[(0, 0), (1, 0), (1, 1), (0, 1)], detection_confidence=0.5)
    assert w.text is None and w.recognition_confidence is None
    with pytest.raises(ValueError):
        types.Word(polygon=[], detection_confidence=1.5)


def test_charset_and_token_decode_match_jax():
    assert charset.default_charset() == jcharset.default_charset()
    itos = charset.default_charset()
    ids = [5, 0, 6, 3, 2, 7]
    assert charset.decode_tokens(ids, itos, 0, 2, 3) == jcharset.decode_tokens(ids, itos, 0, 2, 3)


def test_reading_order_bbox_and_crop_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        polys = rng.uniform(0, 500, (30, 4, 2))
        boxes = [quad_bbox_int(p) for p in polys]
        assert boxes == [j_bbox(p) for p in polys]
        assert reading_order_permutation(boxes) == j_order(boxes)
    img = rng.integers(0, 256, (50, 80, 3), dtype=np.uint8)
    poly = np.array([[-5, 10], [30, 10], [30, 60], [-5, 60]])
    np.testing.assert_array_equal(image.crop_axis_aligned(img, poly), jimage.crop_axis_aligned(img, poly))
    assert image.crop_axis_aligned(img, np.zeros((4, 2))) is None


def test_import_leaves_jax_and_image_libraries_out():
    code = (
        "import sys, manuscript_tpu_torch, manuscript_tpu_torch.fused, manuscript_tpu_torch.bench,"
        "manuscript_tpu_torch.serve_bench, manuscript_tpu_torch.utils.profiling,"
        "manuscript_tpu_torch.utils.compile_cache, manuscript_tpu_torch.utils.sweep,"
        "manuscript_tpu_torch.parallel;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'cv2', 'PIL', 'pydantic', 'msgpack', 'manuscript_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "manuscript_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "manuscript_tpu"), (path, mod)
