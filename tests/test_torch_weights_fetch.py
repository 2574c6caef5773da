"""The first-use fetch of the reference's released weights in the port
(``manuscript_tpu_torch/utils/weights.py``): the cases of
``tests/test_weights_bootstrap.py`` over ``file://`` URLs only (nothing here
touches a network), and the port's resolution order, explicit path → cache
(``.msgpack``, then ``.pth``) → fetch, with the fetched ``.pth`` converted:

* ``download_file``: fetch, sha256 mismatch (no file and no ``.part`` left),
  a missing source (no partial file);
* ``fetch_artifact``: cache hit without a fetch, ``MANUSCRIPT_TPU_NO_DOWNLOAD``,
  the ``MANUSCRIPT_TPU_<NAME>_URL`` override (and a cache hit after the
  source is gone), a failed download (a warning and None), a pinned sha256
  that the cached copy fails;
* ``EAST()``/``TRBA()`` without weights raise (the JAX package's
  RuntimeError, which is also the port's ValueError) unless random weights
  are asked for; with the release URLs pointed at ``file://`` copies of
  reference-layout ``.pth`` files they fetch, convert and load them (equal
  to an explicit-path load), fetch TRBA's config with its weights, and a
  second construction reads the cache; a pinned wrong digest leaves no file;
* a ``.pth`` in the cache is found (and a ``.msgpack`` preferred to it);
* the TRBA trainer's ``pretrained_path`` reads a reference ``.pth``.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from manuscript_tpu.utils import weights as JW
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu_torch.detectors import east as east_mod
from manuscript_tpu_torch.models.trba import TRBAModel
from manuscript_tpu_torch.recognizers import TRBA
from manuscript_tpu_torch.train import trba_train as PT
from manuscript_tpu_torch.utils import convert as PC
from manuscript_tpu_torch.utils import weights as W
from manuscript_tpu_torch.utils.synthetic import build_word_dataset
from test_torch_convert import east_state, save_pth, trba_state

EAST = east_mod.EAST
TINY_EAST = dict(backbone="resnet50-tiny", target_size=64, max_candidates=64, max_boxes=16,
                 dtype=torch.float32)
TINY_TRBA_CONFIG = {"max_len": 6, "hidden_size": 32, "img_h": 32, "img_w": 64,
                    "cnn_stage_plan": "tiny"}


@pytest.fixture
def artifact(tmp_path):
    src = tmp_path / "src" / "blob.bin"
    src.parent.mkdir()
    src.write_bytes(b"released-checkpoint-bytes")
    return src, hashlib.sha256(src.read_bytes()).hexdigest()


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """An empty HOME and cache, fetching allowed, random weights not."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("MANUSCRIPT_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("MANUSCRIPT_TPU_NO_DOWNLOAD", raising=False)
    monkeypatch.delenv("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", raising=False)
    for name in ("EAST", "TRBA", "TRBA_CONFIG"):
        monkeypatch.setenv(f"MANUSCRIPT_TPU_{name}_URL", (tmp_path / "nowhere" / name).as_uri())
    monkeypatch.setattr(W, "PINNED_HASHES_FILE", tmp_path / "release_hashes.json")
    return tmp_path / "cache"


@pytest.fixture(scope="module")
def releases(tmp_path_factory):
    """file:// stand-ins of the three release files (reference layout)."""
    d = tmp_path_factory.mktemp("release")
    east = save_pth(d / "east_quad_23_05.pth", east_state("resnet50-tiny", seed=11), "model_state")
    trba = save_pth(d / "trba_exp_1_64.pth", trba_state(194, 32, seed=12), "state_dict", "module.")
    config = d / "trba_exp_1_64.json"
    config.write_text(json.dumps(TINY_TRBA_CONFIG))
    return {"EAST": east, "TRBA": trba, "TRBA_CONFIG": config}


def _point_at(monkeypatch, releases):
    for name, path in releases.items():
        monkeypatch.setenv(f"MANUSCRIPT_TPU_{name}_URL", path.as_uri())


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---- the cases of tests/test_weights_bootstrap.py -------------------------------


def test_release_table_is_the_jax_packages():
    assert W.RELEASES.keys() == JW.RELEASES.keys()
    for name, art in W.RELEASES.items():
        ref = JW.RELEASES[name]
        assert (art.name, art.url, art.subdir, art.filename, art.sha256) == (
            ref.name, ref.url, ref.subdir, ref.filename, ref.sha256)


def test_file_url_fetch(tmp_path, artifact):
    src, digest = artifact
    dest = tmp_path / "cache" / "blob.bin"
    assert W.download_file(src.as_uri(), dest, sha256=digest) == dest
    assert dest.read_bytes() == src.read_bytes()


def test_sha256_mismatch_leaves_no_file(tmp_path, artifact):
    src, _ = artifact
    dest = tmp_path / "cache" / "blob.bin"
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        W.download_file(src.as_uri(), dest, sha256="0" * 64)
    assert not dest.exists() and not list(dest.parent.glob("*.part"))


def test_missing_source_leaves_no_partial(tmp_path):
    dest = tmp_path / "cache" / "blob.bin"
    with pytest.raises(Exception):
        W.download_file((tmp_path / "nope.bin").as_uri(), dest)
    assert not dest.exists() and not list(dest.parent.glob("*.part"))


def test_cache_hit_skips_the_fetch(tmp_path, monkeypatch):
    monkeypatch.setenv("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
    art = W.RELEASES["east"]
    cached = tmp_path / art.subdir / art.filename
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"x")
    assert W.fetch_artifact("east", cache_dir=tmp_path) == cached


def test_no_download_env_returns_none(tmp_path, monkeypatch):
    monkeypatch.setenv("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
    assert W.fetch_artifact("east", cache_dir=tmp_path) is None


def test_url_override_downloads_then_hits_the_cache(tmp_path, artifact, monkeypatch):
    src, _ = artifact
    monkeypatch.delenv("MANUSCRIPT_TPU_NO_DOWNLOAD", raising=False)
    monkeypatch.setenv("MANUSCRIPT_TPU_EAST_URL", src.as_uri())
    out = W.fetch_artifact("east", cache_dir=tmp_path, quiet=True)
    art = W.RELEASES["east"]
    assert out == tmp_path / art.subdir / art.filename and out.read_bytes() == src.read_bytes()
    src.unlink()
    assert W.fetch_artifact("east", cache_dir=tmp_path, quiet=True) == out


def test_failed_download_warns_and_returns_none(tmp_path, monkeypatch):
    monkeypatch.delenv("MANUSCRIPT_TPU_NO_DOWNLOAD", raising=False)
    monkeypatch.setenv("MANUSCRIPT_TPU_EAST_URL", (tmp_path / "gone.pth").as_uri())
    with pytest.warns(UserWarning, match="Could not fetch"):
        assert W.fetch_artifact("east", cache_dir=tmp_path, quiet=True) is None


def test_a_cached_file_must_match_its_pinned_digest(tmp_path, monkeypatch):
    monkeypatch.setattr(W, "PINNED_HASHES_FILE", tmp_path / "release_hashes.json")
    art = W.RELEASES["east"]
    cached = tmp_path / art.subdir / art.filename
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"x")
    W.pin_sha256("east", hashlib.sha256(b"x").hexdigest())
    assert W.pinned_sha256("east") == hashlib.sha256(b"x").hexdigest()
    assert W.fetch_artifact("east", cache_dir=tmp_path) == cached
    W.pin_sha256("east", "0" * 64)
    with pytest.raises(RuntimeError, match="pinned sha256"):
        W.fetch_artifact("east", cache_dir=tmp_path)


@pytest.mark.parametrize("make", ["east", "trba"])
def test_wrappers_raise_without_weights(isolated, make):
    with pytest.warns(UserWarning, match="Could not fetch"), \
            pytest.raises(RuntimeError, match="allow_random_init") as err:
        EAST(device="cpu", **TINY_EAST) if make == "east" else TRBA(device="cpu")
    assert isinstance(err.value, ValueError)  # the port's earlier error type too
    assert not any(p.is_file() for p in isolated.rglob("*"))  # a failed fetch leaves no file


def test_explicit_opt_in_allows_random(isolated, monkeypatch):
    monkeypatch.setenv("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
    det = EAST(device="cpu", allow_random_init=True, **TINY_EAST)
    assert det.weights_path is None


# ---- resolution order and the fetched reference weights ----------------------------


def test_east_fetches_converts_and_then_reads_the_cache(isolated, releases, monkeypatch, capsys):
    _point_at(monkeypatch, releases)
    det = EAST(device="cpu", **TINY_EAST)
    art = W.RELEASES["east"]
    assert Path(det.weights_path) == isolated / art.subdir / art.filename
    out = capsys.readouterr().out
    assert "Downloading east" in out and "loaded" in out and "skipped" not in out
    _same_weights(det.model, EAST(releases["EAST"], device="cpu", **TINY_EAST).model)
    monkeypatch.setenv("MANUSCRIPT_TPU_EAST_URL", (isolated / "gone.pth").as_uri())
    again = EAST(device="cpu", **TINY_EAST)  # the cache scan finds the .pth
    assert "Downloading" not in capsys.readouterr().out
    _same_weights(det.model, again.model)


def test_trba_fetches_weights_and_config(isolated, releases, monkeypatch, capsys):
    _point_at(monkeypatch, releases)
    rec = TRBA(device="cpu")
    art, cfg = W.RELEASES["trba"], W.RELEASES["trba_config"]
    assert Path(rec.model_path) == isolated / art.subdir / art.filename
    assert Path(rec.config_path) == isolated / cfg.subdir / cfg.filename
    assert (rec.max_length, rec.hidden_size, rec.cnn_stage_plan) == (6, 32, "tiny")
    assert "skipped" not in capsys.readouterr().out
    ref = TRBA(releases["TRBA"], config_path=releases["TRBA_CONFIG"], device="cpu")
    _same_weights(rec.model, ref.model)
    for name in releases:
        monkeypatch.setenv(f"MANUSCRIPT_TPU_{name}_URL", (isolated / "gone").as_uri())
    again = TRBA(device="cpu")  # weights from the cache, config.json beside them
    assert "Downloading" not in capsys.readouterr().out and again.hidden_size == 32
    _same_weights(rec.model, again.model)


def test_a_pinned_wrong_digest_is_refused_and_leaves_no_file(isolated, releases, monkeypatch):
    _point_at(monkeypatch, releases)
    W.pin_sha256("east", "0" * 64)
    with pytest.warns(UserWarning, match="sha256 mismatch"), pytest.raises(RuntimeError):
        EAST(device="cpu", **TINY_EAST)
    assert not any(p.is_file() for p in isolated.rglob("*"))
    W.pin_sha256("east", hashlib.sha256(releases["EAST"].read_bytes()).hexdigest())
    assert EAST(device="cpu", **TINY_EAST).weights_path is not None


def test_the_cache_finds_a_pth_and_prefers_a_msgpack(isolated, releases, monkeypatch):
    monkeypatch.setenv("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
    east_dir, trba_dir = isolated / "east" / "v0", isolated / "trba" / "v0"
    east_dir.mkdir(parents=True)
    trba_dir.mkdir(parents=True)
    (east_dir / "a.pth").write_bytes(releases["EAST"].read_bytes())
    (trba_dir / "weights.pth").write_bytes(releases["TRBA"].read_bytes())
    (trba_dir / "config.json").write_text(releases["TRBA_CONFIG"].read_text())
    assert W.cached_checkpoint("east") == east_dir / "a.pth"
    assert Path(EAST(device="cpu", **TINY_EAST).weights_path) == east_dir / "a.pth"
    rec = TRBA(device="cpu")
    assert Path(rec.model_path) == trba_dir / "weights.pth" and rec.cnn_stage_plan == "tiny"
    (trba_dir / "z.msgpack").write_bytes((QUALITY_DIR / "trba_micro.msgpack").read_bytes())
    assert W.cached_checkpoint("trba") == trba_dir / "z.msgpack"


def test_trba_trainer_reads_a_reference_pth(tmp_path, releases):
    (tsv, imgs) = build_word_dataset(tmp_path / "crops", 8, seed=0)
    cfg = dict(TINY_TRBA_CONFIG, max_len=12, batch_size=4, epochs=1, eval_beam=False, seed=0,
               exp_root=str(tmp_path / "exp"), freeze_cnn="full",
               pretrained_path=str(releases["TRBA"]))
    model = PT.train(tsv, imgs, tsv, imgs, config=cfg, device="cpu")["model"]
    log = (tmp_path / "exp" / "exp1" / "train.log").read_text()
    assert "loaded pretrained weights" in log and "pretrained load failed" not in log
    fresh = TRBAModel(194, 32, cnn_stage_plan="tiny")
    want = PC.merge_converted(fresh.state_dict(), PC.convert_trba(
        PC.load_torch_state_dict(str(releases["TRBA"]))))
    for k, v in model.state_dict().items():  # the frozen CNN kept the converted weights
        if k.startswith("cnn.") and "running" not in k:
            np.testing.assert_array_equal(v.cpu().numpy(), want[k].numpy(), err_msg=k)
