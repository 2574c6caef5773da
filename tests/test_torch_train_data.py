"""The port's training data against the JAX package's (cv2 and PIL there,
numpy here), on inputs from a seed:

* EAST labels: ``fill_poly`` sets cv2.fillPoly's pixels; the score maps are
  equal and the geometry within 1e-4; ``min_area_quad`` within 1e-3 of cv2's
  minAreaRect + boxPoints; the dataset's items equal the JAX dataset's;
* the photometric augmentations: RGB → HSV equal to cv2; HSV → RGB, the
  jitter and the warp at most 1 grey level apart on under 0.1 % of the
  values (measured against cv2 5.0: 0.004 %, 0.035 % and 0.006 %);
  ``augment_word_image`` equal on these crops;
* the TRBA data: the label reader, the file index, ``OCRDataset`` (its skip
  report and items), ``proportional_batches``, ``pack_targets`` and
  ``collate_attention`` equal;
* the PNG decoder byte-equal to PIL over the five row filters and four
  colour types; the msgpack writer read back by ``flax.serialization``.
"""

import json
import struct
import sys
import zlib

import cv2
import flax.serialization
import numpy as np
import pytest
import torch
from PIL import Image

from manuscript_tpu.recognizers.charset import default_charset, pack_targets as j_pack
from manuscript_tpu.train import east_dataset as JE
from manuscript_tpu.train import trba_dataset as JT
from manuscript_tpu_torch.ops.image import decode_png, encode_png, read_image
from manuscript_tpu_torch.recognizers.charset import pack_targets
from manuscript_tpu_torch.train import east_dataset as PE
from manuscript_tpu_torch.train import trba_dataset as PT
from manuscript_tpu_torch.utils.synthetic import build_page_dataset, build_word_dataset
from manuscript_tpu_torch.utils.weights import msgpack_restore, msgpack_serialize, params_from_jax, params_to_jax

ITOS = default_charset()
STOI = {s: i for i, s in enumerate(ITOS)}


def _polygons(rng, n, size):
    for _ in range(n):
        c = rng.uniform(0, size, 2)
        pts = c + rng.normal(0, rng.uniform(1, size / 4), (int(rng.integers(3, 7)), 2))
        yield np.clip(np.round(pts), 0, size - 1).astype(np.int32)


def test_fill_poly_sets_the_pixels_of_cv2():
    rng = np.random.default_rng(0)
    for pts in _polygons(rng, 300, 48):
        want = np.zeros((48, 48), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = PE.fill_poly(np.zeros((48, 48), np.uint8), pts)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def _word_quads(rng, n, size):
    quads = []
    for _ in range(n):
        x, y = rng.uniform(0, size * 0.7, 2)
        w, h, a = rng.uniform(20, size * 0.3), rng.uniform(8, 30), np.radians(rng.uniform(-20, 20))
        corners = np.array([[0, 0], [w, 0], [w, h], [0, h]]) @ np.array(
            [[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        quads.append((corners + (x, y) + rng.normal(0, 1.5, (4, 2))).astype(np.float32))
    return quads


@pytest.mark.parametrize("seed", range(4))
def test_label_maps_match_jax(seed):
    rng = np.random.default_rng(seed)
    quads = _word_quads(rng, 8, 256)
    js, jg = JE.rasterize_quad_maps(quads, 256, 0.25)
    ps, pg = PE.rasterize_quad_maps(quads, 256, 0.25)
    assert js.sum() > 0
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(pg, jg, rtol=0, atol=1e-4)


def test_min_area_quad_order_and_shrink_match_cv2():
    rng = np.random.default_rng(1)
    for quad in _word_quads(rng, 100, 400):
        extra = quad[:2] + rng.uniform(0.2, 0.8) * (quad[2:] - quad[:2])  # points inside
        pts = np.concatenate([quad, extra])[rng.permutation(6)]
        np.testing.assert_allclose(PE.min_area_quad(pts), JE.min_area_quad(pts), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(PE.order_vertices_clockwise(pts[:4]),
                                      JE.order_vertices_clockwise(pts[:4]))
        np.testing.assert_allclose(PE.shrink_quad(quad), JE.shrink_quad(quad), rtol=0, atol=1e-5)


def test_hsv_round_trip_against_cv2():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (64, 100, 3), dtype=np.uint8)
    np.testing.assert_array_equal(PE.rgb_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    hsv = np.stack([rng.integers(0, 180, (64, 100)), rng.integers(0, 256, (64, 100)),
                    rng.integers(0, 256, (64, 100))], -1).astype(np.uint8)
    d = np.abs(PE.hsv_to_rgb_u8(hsv).astype(int) - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_matches_jax(seed):
    img = np.random.default_rng(seed).integers(0, 256, (48, 96, 3), dtype=np.uint8)
    want = JE.color_jitter(img, np.random.default_rng(seed))
    d = np.abs(PE.color_jitter(img, np.random.default_rng(seed)).astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_warp_and_word_augmentation_match_cv2():
    rng = np.random.default_rng(3)
    diffs = []
    for _ in range(10):
        img = cv2.GaussianBlur(rng.integers(0, 256, (32, 96, 3), dtype=np.uint8), (5, 5), 2)
        m = PT.rotation_matrix((48.0, 16.0), rng.uniform(-3, 3), 1 + rng.uniform(-0.08, 0.08))
        np.testing.assert_array_equal(m, cv2.getRotationMatrix2D((48.0, 16.0), 0, 1) * 0 + m)
        m[:, 2] += (rng.uniform(-3, 3), rng.uniform(-1, 1))
        want = cv2.warpAffine(img, m, (96, 32), borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(255, 255, 255))
        diffs.append(np.abs(PT.warp_affine(img, m, 255).astype(int) - want))
    d = np.stack(diffs)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    for angle, scale in ((2.5, 1.04), (-1.0, 0.95)):
        np.testing.assert_allclose(PT.rotation_matrix((47.5, 18.0), angle, scale),
                                   cv2.getRotationMatrix2D((47.5, 18.0), angle, scale), rtol=0, atol=1e-12)
    kw = dict(p_shift_scale_rotate=1.0, p_brightness_contrast=1.0, invert_p=0.5, p_downscale=1.0)
    for seed in range(8):
        img = cv2.GaussianBlur(rng.integers(0, 256, (36, 120, 3), dtype=np.uint8), (5, 5), 2)
        want = JT.augment_word_image(img, np.random.default_rng(seed), JT.AugmentParams(**kw))
        got = PT.augment_word_image(img, np.random.default_rng(seed), PT.AugmentParams(**kw))
        assert np.abs(got.astype(int) - want).max() <= 1


def _png(img: np.ndarray, filters, color: int) -> bytes:
    """A PNG of ``img`` with the given row filter per row (a test encoder)."""
    h, w = img.shape[:2]
    bpp = img.reshape(h, w, -1).shape[-1]
    rows = img.reshape(h, -1).astype(np.int32)
    out = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        cur, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[0])
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - up
        elif kind == 3:
            f = cur - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()

    def chunk(k, body):
        return struct.pack(">I", len(body)) + k + body + struct.pack(">I", zlib.crc32(k + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_decoder_is_byte_equal_to_pil(color, channels, tmp_path):
    rng = np.random.default_rng(color)
    img = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    data = _png(img, [0, 1, 2, 3, 4], color)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    with Image.open(path) as im:
        np.testing.assert_array_equal(decode_png(data), np.array(im))
    if channels in (1, 3):
        with Image.open(__import__("io").BytesIO(encode_png(img))) as im:
            np.testing.assert_array_equal(np.array(im), img)


def test_read_image_reads_png_without_cv2_or_pil(tmp_path, monkeypatch):
    img = np.random.default_rng(0).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    (tmp_path / "a.png").write_bytes(_png(img, [4, 1], 2))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.png")), img)
    (tmp_path / "b.png").write_bytes(b"not a png")
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "b.png"))


def test_pack_targets_and_collate_match_jax():
    texts = ["manuscript", "", "ink", "an overlong line of text", "abЖc"]
    for got, want in zip(pack_targets(texts, STOI, 12), j_pack(texts, STOI, 12)):
        np.testing.assert_array_equal(got, want)
    items = [(np.full((4, 8, 3), i, np.uint8), t) for i, t in enumerate(texts)]
    got, want = PT.collate_attention(items, STOI, 12), JT.collate_attention(items, STOI, 12)
    assert got.keys() == want.keys() and got["texts"] == want["texts"]
    for k in ("image", "text_in", "target_y", "lengths"):
        np.testing.assert_array_equal(got[k], want[k])


def test_proportional_batches_match_jax():
    sizes = [list(range(13)), list(range(5)), list(range(8))]
    for props, bs, seed in (([0.5, 0.2, 0.3], 6, 0), ([1.0], 4, 3), ([1, 1, 2], 7, 11)):
        sets = sizes[: len(props)]
        assert list(PT.proportional_batches(sets, props, bs, seed)) == list(
            JT.proportional_batches(sets, props, bs, seed))


@pytest.fixture(scope="module")
def word_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("words")
    tsv, img_dir = build_word_dataset(root, 10, seed=0)
    rows = open(tsv, encoding="utf-8").read().splitlines()
    rows[1] = "nested/missing.png\tink"  # missing file
    rows[2] = rows[2].split("\t")[0] + "\t" + "x" * 30  # too long
    rows[3] = rows[3].split("\t")[0] + "\tab☺"  # outside the charset
    (root / "sub").mkdir()
    (root / "images" / "w00004.png").rename(root / "sub" / "w00004.png")  # found by basename
    (root / "images" / "w00005.png").write_bytes(b"broken")  # unreadable: lazily replaced
    labels = root / "labels.csv"
    labels.write_text("filename,text\n" + "\n".join(r.replace("\t", ",") for r in rows), encoding="utf-8")
    return str(labels), [str(root / "images"), str(root / "sub")]


def test_ocr_dataset_matches_jax(word_data):
    labels, roots = word_data
    assert PT.read_label_file(labels) == JT.read_label_file(labels)
    assert dict(PT.build_file_index(roots)) == dict(JT.build_file_index(roots))
    kw = dict(max_len=12, img_h=32, img_w=96, augment=False)
    ds, ref = PT.OCRDataset(labels, roots, STOI, **kw), JT.OCRDataset(labels, roots, STOI, **kw)
    assert ds.samples == ref.samples and len(ds) == 7
    assert ds.skip_report == ref.skip_report == {"missing_file": 1, "too_long": 1, "charset": 1}
    assert ds.missing_chars_top == ref.missing_chars_top
    for i in range(len(ds)):
        got, want = ds[i], ref[i]
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    broken = next(i for i, (p, _) in enumerate(ds.samples) if p.endswith("w00005.png"))
    img, text = ds[broken]  # replaced by another sample, not raised
    assert img.shape == (32, 96, 3) and text in {t for _, t in ds.samples}


@pytest.fixture(scope="module")
def page_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pages")
    coco, img_dir, _ = build_page_dataset(root, 3, seed=0, page_h=256, page_w=192, n_rows=3, n_cols=1)
    data = json.loads(open(coco).read())
    data["images"].append({"id": 99, "file_name": "p0000.png", "height": 256, "width": 192})
    data["annotations"].append({"id": 999, "image_id": 99, "segmentation": [[1, 2, 3, 4]]})
    (root / "coco_bad.json").write_text(json.dumps(data))
    return img_dir, str(root / "coco_bad.json")


def test_east_dataset_items_match_jax(page_data):
    img_dir, coco = page_data
    with pytest.warns(UserWarning, match="dropped 1"):
        ds = PE.EASTDataset(img_dir, coco, target_size=128, augment=False)
    with pytest.warns(UserWarning):
        ref = JE.EASTDataset(img_dir, coco, target_size=128, augment=False)
    assert len(ds) == len(ref) == 3
    for i in range(len(ds)):
        (im, sc, geo, quads), (jim, jsc, jgeo, jquads) = ds[i], ref[i]
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(sc, jsc)
        np.testing.assert_allclose(geo, jgeo, rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.stack(quads), np.stack(jquads), rtol=0, atol=1e-3)
    both = PE.ConcatDataset([ds, ds])
    assert len(both) == 6 and np.array_equal(both[4][0], ds[1][0])
    got = [b["image"] for b in PE.batch_iterator(ds, 2, shuffle=True, seed=4, drop_last=False)]
    want = [b["image"] for b in JE.batch_iterator(ref, 2, shuffle=True, seed=4, drop_last=False)]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_msgpack_writer_is_read_back_by_flax():
    rng = np.random.default_rng(0)
    tree = {
        "params": {"a": {"kernel": rng.normal(0, 1, (3, 3, 2, 4)).astype(np.float32),
                         "bias": np.zeros(4, np.float32)}},
        "opt_state": {"0": {"count": 7, "mu": {"x.y": torch.arange(5, dtype=torch.float32)}},
                      "1": {}},
        "itos": ["<PAD>", "a", "Ж"],
        "config": {"lr": 1e-3, "name": "exp1", "flag": True, "none": None, "big": 2**40, "neg": -300},
        "scalar": np.float32(2.5),
        "ints": np.arange(4, dtype=np.int32),
    }
    back = flax.serialization.msgpack_restore(msgpack_serialize(tree))
    ours = msgpack_restore(msgpack_serialize(tree))
    for restored in (back, ours):
        np.testing.assert_array_equal(restored["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
        np.testing.assert_array_equal(restored["opt_state"]["0"]["mu"]["x.y"], np.arange(5, dtype=np.float32))
        assert restored["opt_state"]["0"]["count"] == 7 and restored["opt_state"]["1"] == {}
        assert restored["itos"] == {"0": "<PAD>", "1": "a", "2": "Ж"}
        assert restored["config"] == tree["config"]
        assert restored["scalar"] == np.float32(2.5) and restored["ints"].dtype == np.int32


def test_params_to_jax_inverts_params_from_jax():
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.utils.weights import init_random_

    model = init_random_(TRBAModel(194, 32, cnn_stage_plan="micro"), 0)
    state = model.state_dict()
    back = params_from_jax(params_to_jax(state))
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k
