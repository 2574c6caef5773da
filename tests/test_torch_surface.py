"""The public surface of the port against the JAX package's.

* Every name in the ``__all__`` of ``manuscript_tpu``,
  ``manuscript_tpu.detectors`` and ``manuscript_tpu.recognizers``, and every
  name that ``manuscript_tpu/ops/__init__.py`` imports, exists in the
  matching package of the port, under the port's name where ``RENAMED``
  gives one (one case per name).
* Every public name that ``manuscript_tpu/utils/quality.py`` defines
  (functions, classes, constants) exists in the port's ``utils.quality``.
* ``quad_to_rbox`` gives cv2's ``minAreaRect`` (the JAX package's function)
  on random quads, cv2 5's angle convention included: centre, sides and
  angle within 2e-3 (float32 steps of the calipers); ``batch_resize_and_pad``
  is byte-equal; ``compact_decoded``, ``normalize_u8``, ``resize_bilinear``
  (within 1e-5), ``save_charset``/``charset_maps``/``pack_targets`` and
  ``__version__`` agree with the JAX package.
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manuscript_tpu
import manuscript_tpu.detectors
import manuscript_tpu.recognizers
from manuscript_tpu.ops import boxes as JB
from manuscript_tpu.ops import decode as JD
from manuscript_tpu.ops import image as JI
from manuscript_tpu.recognizers import charset as JC

# the JAX package's name → the port's, where they differ
RENAMED = {"decode_cells_jax": "decode_cells"}

JAX_OPS_INIT = Path(manuscript_tpu.__file__).parent / "ops" / "__init__.py"


def _ops_imports():
    tree = ast.parse(JAX_OPS_INIT.read_text())
    return sorted(a.asname or a.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) for a in node.names)


SURFACE = (
    [("", name) for name in manuscript_tpu.__all__]
    + [("detectors", name) for name in manuscript_tpu.detectors.__all__]
    + [("recognizers", name) for name in manuscript_tpu.recognizers.__all__]
    + [("ops", name) for name in _ops_imports()]
)


JAX_QUALITY = Path(manuscript_tpu.__file__).parent / "utils" / "quality.py"


def _defined_names(path):
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("name", _defined_names(JAX_QUALITY))
def test_every_public_name_of_the_quality_module_exists_in_the_port(name):
    from manuscript_tpu.utils import quality as jax_quality
    from manuscript_tpu_torch.utils import quality

    assert hasattr(quality, name), f"manuscript_tpu_torch.utils.quality: {name}"
    assert callable(getattr(quality, name)) == callable(getattr(jax_quality, name))


@pytest.mark.parametrize("package,name", SURFACE, ids=[f"{p or 'root'}.{n}" for p, n in SURFACE])
def test_every_jax_export_exists_in_the_port(package, name):
    port = importlib.import_module("manuscript_tpu_torch" + (f".{package}" if package else ""))
    jax_pkg = importlib.import_module("manuscript_tpu" + (f".{package}" if package else ""))
    got = getattr(port, RENAMED.get(name, name), None)
    assert got is not None, f"manuscript_tpu_torch.{package}: {name}"
    ref = getattr(jax_pkg, name)
    assert callable(got) == callable(ref)
    if package != "ops" and hasattr(jax_pkg, "__all__"):
        assert RENAMED.get(name, name) in port.__all__


def _random_quads(rng, n):
    out = []
    for t in range(n):
        if t % 3 == 0:
            out.append(rng.uniform(0, 500, 8))
        elif t % 3 == 1:
            x, y, w, h = *rng.uniform(0, 400, 2), *rng.uniform(1, 80, 2)
            a = np.radians(rng.uniform(-90, 90))
            rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
            out.append((np.array([[0, 0], [w, 0], [w, h], [0, h]]) @ rot + (x, y)).ravel())
        else:
            x, y, w, h = *rng.integers(0, 400, 2), *rng.integers(1, 80, 2)
            out.append([x, y, x + w, y, x + w, y + h, x, y + h])
    return np.asarray(out, np.float32)


def test_quad_to_rbox_is_cv2s_min_area_rect():
    from manuscript_tpu_torch.ops import quad_to_rbox

    quads = _random_quads(np.random.default_rng(0), 600)
    degenerate = np.array([[0] * 8, [1, 1, 5, 5, 5, 5, 1, 1], [0, 0, 10, 0, 10, 0, 0, 0]], np.float32)
    for q in np.concatenate([quads, degenerate]):
        want = JB.quad_to_rbox(q)
        got = quad_to_rbox(np.append(q, 0.9))  # a score column is ignored
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=str(q.tolist()))
        assert -90.0 <= got[4] < 0.0


def test_batch_resize_and_pad_is_byte_equal():
    from manuscript_tpu_torch.ops import batch_resize_and_pad

    rng = np.random.default_rng(1)
    crops = [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
             for h, w in rng.integers(5, 120, (8, 2))]
    got, ref = batch_resize_and_pad(crops, 32, 128), JI.batch_resize_and_pad(crops, 32, 128)
    assert got.shape == (8, 32, 128, 3)
    np.testing.assert_array_equal(got, ref)


def test_tensor_image_ops_and_compact_decoded_match_jax():
    from manuscript_tpu_torch import ops

    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
    np.testing.assert_allclose(ops.normalize_u8(torch.from_numpy(u8)).numpy(),
                               np.asarray(JI.normalize_u8(jnp.asarray(u8))), atol=1e-6, rtol=0)
    x = rng.normal(size=(2, 16, 20, 3)).astype(np.float32)
    for size in ((8, 10), (32, 40), (12, 7)):
        got = ops.resize_bilinear(torch.from_numpy(x), *size).numpy()
        np.testing.assert_allclose(got, np.asarray(JI.resize_bilinear(jnp.asarray(x), *size)),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(ops.resize_bilinear(torch.from_numpy(x[0]), 8, 10).numpy(),
                               np.asarray(JI.resize_bilinear(jnp.asarray(x[0]), 8, 10)), atol=1e-5)
    quads = rng.normal(size=(4, 5, 8)).astype(np.float32)
    scores = rng.random((4, 5)).astype(np.float32)
    valid = scores > 0.5
    np.testing.assert_array_equal(ops.compact_decoded(quads, scores, valid),
                                  JD.compact_decoded(quads, scores, valid))
    assert ops.compact_decoded(quads, scores, valid & False).shape == (0, 9)
    assert ops.native_available()


def test_charset_helpers_match_jax(tmp_path):
    from manuscript_tpu_torch import __version__
    from manuscript_tpu_torch.recognizers import (charset_maps, default_charset, load_charset,
                                                  pack_targets, save_charset)

    assert __version__ == manuscript_tpu.__version__
    itos = default_charset()
    save_charset(itos, tmp_path / "port.txt")
    JC.save_charset(itos, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert load_charset(tmp_path / "port.txt")[0] == itos
    stoi = charset_maps(itos)
    assert stoi == JC.charset_maps(itos)
    texts = ["абв", "hello", "", "ѣ xyz№"]
    for got, ref in zip(pack_targets(texts, stoi, 5), JC.pack_targets(texts, stoi, 5)):
        np.testing.assert_array_equal(got, ref)
