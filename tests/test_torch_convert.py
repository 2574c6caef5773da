"""The port's converter of the reference's torch checkpoints
(``manuscript_tpu_torch/utils/convert.py``) against the JAX package's.

* Synthetic reference-layout state dicts (the reference's key names and
  shapes, seeded numpy values, as ``tests/models/test_convert_coverage.py``
  builds them) for EAST resnet50, EAST resnet101 and TRBA: the port's merged
  state dict equals ``params_from_jax`` of the JAX converter's merged tree
  leaf for leaf, exactly, and every leaf of the model is loaded.
* One ``.pth`` file read by both packages' wrappers: EAST resnet50-tiny at
  64² (score and geometry maps within 1e-4, the same boxes within 1e-2 px)
  and TRBA with the tiny plan (teacher-forced logits within 1e-4, greedy
  texts equal, confidences within 1e-4). Float32 on the CPU, TF32 off: the
  two differ only in the order of their sums.
* The shape-mismatch report (the same printout), the ``.pth`` round trip
  through ``torch.save``/``load_torch_state_dict`` with ``model_state``/
  ``state_dict``/``model`` wrappers and ``module.``/``model.`` prefixes, and
  the ``MANUSCRIPT_TPU_UNSAFE_LOAD`` refusal of a pickled non-tensor.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.detectors import EAST as JaxEAST
from manuscript_tpu.models.east import EASTModel as JaxEASTModel
from manuscript_tpu.models.resnet import STAGE_BLOCKS
from manuscript_tpu.models.trba import TRBAModel as JaxTRBAModel
from manuscript_tpu.recognizers.trba import TRBA as JaxTRBA
from manuscript_tpu.utils import convert as JC
from manuscript_tpu_torch.detectors import EAST
from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.models.trba import TRBAModel
from manuscript_tpu_torch.recognizers import TRBA
from manuscript_tpu_torch.utils import convert as PC
from manuscript_tpu_torch.utils.weights import params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

TINY_TRBA = dict(num_classes=194, hidden=32)


class _Builder:
    """A reference-layout state dict filled from a seeded generator."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.s = {}

    def arr(self, *shape, scale=1.0):
        return (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def bn(self, key, c):
        self.s[f"{key}.weight"] = self.rng.uniform(0.5, 1.0, c).astype(np.float32)
        self.s[f"{key}.bias"] = self.arr(c, scale=0.1)
        self.s[f"{key}.running_mean"] = self.arr(c, scale=0.1)
        self.s[f"{key}.running_var"] = self.rng.uniform(0.5, 1.5, c).astype(np.float32)
        self.s[f"{key}.num_batches_tracked"] = np.array(7)

    def conv(self, key, o, i, k, bias=False):
        self.s[f"{key}.weight"] = self.arr(o, i, k, k, scale=(i * k * k) ** -0.5)
        if bias:
            self.s[f"{key}.bias"] = self.arr(o, scale=0.1)

    def linear(self, key, o, i, bias=True):
        self.s[f"{key}.weight"] = self.arr(o, i, scale=i ** -0.5)
        if bias:
            self.s[f"{key}.bias"] = self.arr(o, scale=0.1)

    def lstm(self, key, i, h, suffix=""):
        self.s[f"{key}.weight_ih_l0{suffix}"] = self.arr(4 * h, i, scale=i ** -0.5)
        self.s[f"{key}.weight_hh_l0{suffix}"] = self.arr(4 * h, h, scale=h ** -0.5)
        self.s[f"{key}.bias_ih_l0{suffix}"] = self.arr(4 * h, scale=0.1)
        self.s[f"{key}.bias_hh_l0{suffix}"] = self.arr(4 * h, scale=0.1)


def east_state(backbone, seed=0):
    b = _Builder(seed)
    bb = "backbone.extractor"
    b.conv(f"{bb}.conv1", 64, 3, 7)
    b.bn(f"{bb}.bn1", 64)
    planes, in_ch = 64, 64
    for stage, blocks in enumerate(STAGE_BLOCKS[backbone], start=1):
        for i in range(blocks):
            base = f"{bb}.layer{stage}.{i}"
            b.conv(f"{base}.conv1", planes, in_ch if i == 0 else planes * 4, 1)
            b.bn(f"{base}.bn1", planes)
            b.conv(f"{base}.conv2", planes, planes, 3)
            b.bn(f"{base}.bn2", planes)
            b.conv(f"{base}.conv3", planes * 4, planes, 1)
            b.bn(f"{base}.bn3", planes * 4)
            if i == 0:
                b.conv(f"{base}.downsample.0", planes * 4, in_ch, 1)
                b.bn(f"{base}.downsample.1", planes * 4)
        in_ch, planes = planes * 4, planes * 2
    for n, (cin, mid, cout) in enumerate(
        [(2048, 512, 512), (1536, 256, 256), (768, 128, 128), (384, 64, 32)], start=1
    ):
        b.conv(f"decoder.block{n}.conv1x1.0", mid, cin, 1, bias=True)
        b.bn(f"decoder.block{n}.conv1x1.1", mid)
        b.conv(f"decoder.block{n}.conv3x3.0", cout, mid, 3, bias=True)
        b.bn(f"decoder.block{n}.conv3x3.1", cout)
    b.conv("output_head.score_map", 1, 32, 1, bias=True)
    b.conv("output_head.geo_map", 8, 32, 1, bias=True)
    return b.s


def trba_state(num_classes=194, hidden=256, seed=1):
    b = _Builder(seed)
    b.conv("cnn.conv0.0", 64, 3, 3)
    b.bn("cnn.conv0.1", 64)
    b.conv("cnn.conv0.3", 128, 64, 3)
    b.bn("cnn.conv0.4", 128)
    in_planes = 128
    for stage, (planes, blocks, stride) in enumerate(JC.SERESNET_PLAN, start=1):
        for i in range(blocks):
            base = f"cnn.layer{stage}.{i}"
            b.conv(f"{base}.conv1", planes, in_planes if i == 0 else planes, 3)
            b.bn(f"{base}.bn1", planes)
            b.conv(f"{base}.conv2", planes, planes, 3)
            b.bn(f"{base}.bn2", planes)
            b.linear(f"{base}.se.fc.0", planes // 16, planes, bias=False)
            b.linear(f"{base}.se.fc.2", planes, planes // 16, bias=False)
            if i == 0 and (stride != 1 or in_planes != planes):
                b.conv(f"{base}.downsample.0", planes, in_planes, 1)
                b.bn(f"{base}.downsample.1", planes)
        in_planes = planes
    for n in (0, 3):
        b.conv(f"cnn.conv_out.{n}", 512, 512, 2)
        b.bn(f"cnn.conv_out.{n + 1}", 512)
    for i, cin in ((0, 512), (1, hidden)):
        b.lstm(f"enc_rnn.{i}.rnn", cin, hidden)
        b.lstm(f"enc_rnn.{i}.rnn", cin, hidden, "_reverse")
        b.linear(f"enc_rnn.{i}.linear", hidden, 2 * hidden)
    cell = "attn.attention_cell"
    b.linear(f"{cell}.i2h", hidden, hidden, bias=False)
    b.linear(f"{cell}.h2h", hidden, hidden)
    b.linear(f"{cell}.score", 1, hidden, bias=False)
    b.s[f"{cell}.rnn.weight_ih"] = b.arr(4 * hidden, hidden + num_classes, scale=0.1)
    b.s[f"{cell}.rnn.weight_hh"] = b.arr(4 * hidden, hidden, scale=hidden ** -0.5)
    b.s[f"{cell}.rnn.bias_ih"] = b.arr(4 * hidden, scale=0.1)
    b.s[f"{cell}.rnn.bias_hh"] = b.arr(4 * hidden, scale=0.1)
    b.linear("attn.generator", num_classes, hidden)
    return b.s


def save_pth(path, state, wrap=None, prefix=""):
    tensors = {prefix + k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    torch.save(tensors if wrap is None else {wrap: tensors, "epoch": 3}, path)
    return path


def jax_zero_variables(model, *args):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


CASES = {
    "east-resnet50": lambda: (east_state("resnet50"), JC.convert_east, PC.convert_east,
                              JaxEASTModel(backbone="resnet50"), EASTModel("resnet50"),
                              (jnp.zeros((1, 32, 32, 3)),), "resnet50"),
    "east-resnet101": lambda: (east_state("resnet101"), JC.convert_east, PC.convert_east,
                               JaxEASTModel(backbone="resnet101"), EASTModel("resnet101"),
                               (jnp.zeros((1, 32, 32, 3)),), "resnet101"),
    "trba": lambda: (trba_state(), JC.convert_trba, PC.convert_trba,
                     JaxTRBAModel(num_classes=194, hidden_size=256), TRBAModel(194, 256),
                     (jnp.zeros((1, 32, 64, 3)), jnp.zeros((1, 5), jnp.int32)), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converted_leaves_equal_the_jax_converters(case, capsys):
    state, jconv, pconv, jmodel, pmodel, args, backbone = CASES[case]()
    extra = (backbone,) if backbone else ()
    ref_tree = JC.merge_converted(jax_zero_variables(jmodel, *args), jconv(dict(state), *extra),
                                  verbose=False)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree))
    got = PC.merge_converted(pmodel.state_dict(), pconv(dict(state), *extra))
    assert f"[convert] loaded {len(pmodel.state_dict())} tensors" in capsys.readouterr().out
    assert sorted(got) == sorted(ref) == sorted(pmodel.state_dict())
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    pmodel.load_state_dict(got)  # strict: every key, every shape


def test_shape_mismatch_is_skipped_and_reported_as_in_jax(capsys):
    state = trba_state(**TINY_TRBA)
    state["attn.generator.weight"] = np.zeros((7, 7), np.float32)
    state["cnn.conv0.0.weight"] = np.zeros((64, 3, 5, 5), np.float32)
    jmodel = JaxTRBAModel(num_classes=194, hidden_size=32, cnn_stage_plan="tiny")
    init = jax_zero_variables(jmodel, jnp.zeros((1, 32, 64, 3)), jnp.zeros((1, 5), jnp.int32))
    JC.merge_converted(init, JC.convert_trba(dict(state)))
    ref_out = capsys.readouterr().out
    model = TRBAModel(194, 32, cnn_stage_plan="tiny")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = PC.merge_converted(model.state_dict(), PC.convert_trba(dict(state)))
    assert capsys.readouterr().out == ref_out
    assert "skipped 2 shape-mismatched tensors" in ref_out
    for k in ("decoder.gen_kernel", "cnn.stem_conv1.weight"):  # kept the model's values
        np.testing.assert_array_equal(got[k].numpy(), before[k].numpy())


@pytest.mark.parametrize("wrap,prefix", [(None, ""), ("model_state", "module."),
                                         ("state_dict", "model."), ("model", "")])
def test_pth_round_trip_as_the_jax_loader_reads_it(tmp_path, wrap, prefix):
    state = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3), "a.bias": np.ones(2, np.float32),
             "bn.num_batches_tracked": np.array(3)}
    path = save_pth(tmp_path / "w.pth", state, wrap, prefix)
    got, ref = PC.load_torch_state_dict(str(path)), JC.load_torch_state_dict(str(path))
    assert sorted(got) == sorted(ref) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
        np.testing.assert_array_equal(got[k], ref[k])


def test_unsafe_load_is_an_explicit_opt_in(tmp_path, monkeypatch):
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {"w": torch.ones(2)}, "args": argparse.Namespace(lr=0.1)}, path)
    monkeypatch.delenv("MANUSCRIPT_TPU_UNSAFE_LOAD", raising=False)
    with pytest.raises(RuntimeError, match="MANUSCRIPT_TPU_UNSAFE_LOAD=1") as got:
        PC.load_torch_state_dict(str(path))
    with pytest.raises(RuntimeError) as ref:
        JC.load_torch_state_dict(str(path))
    assert str(got.value) == str(ref.value)
    monkeypatch.setenv("MANUSCRIPT_TPU_UNSAFE_LOAD", "1")
    with pytest.warns(UserWarning, match="weights_only=False"):
        assert PC.load_torch_state_dict(str(path))["w"].tolist() == [1.0, 1.0]


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    d = tmp_path_factory.mktemp("pth")
    east = save_pth(d / "east.pth", east_state("resnet50-tiny", seed=3), "model_state", "module.")
    trba = save_pth(d / "trba.pth", trba_state(**TINY_TRBA, seed=4), "state_dict")
    config = d / "trba.json"  # the sidecar the reference's release has
    config.write_text(json.dumps({"max_len": 6, "hidden_size": 32, "img_h": 32, "img_w": 64,
                                  "cnn_stage_plan": "tiny"}))
    return east, trba, config


def test_east_from_the_same_pth_matches_jax(pths):
    east_pth = str(pths[0])
    settings = dict(backbone="resnet50-tiny", target_size=64, score_thresh=0.3, max_candidates=256,
                    max_boxes=64, quantization=1)
    jdet = JaxEAST(weights_path=east_pth, dtype=jnp.float32, **settings)
    det = EAST(east_pth, device="cpu", dtype=torch.float32, **settings)
    page = np.random.default_rng(0).integers(0, 256, (96, 80, 3), dtype=np.uint8)
    ref, got = jdet.predict(page, return_maps=True), det.predict(page, return_maps=True)
    for key in ("score_map", "geo_map"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], atol=1e-4, rtol=1e-4)
    gw = [w for b in got["page"].blocks for w in b.words]
    rw = [w for b in ref["page"].blocks for w in b.words]
    assert len(gw) == len(rw)
    for a, b in zip(gw, rw):
        np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)


def test_trba_from_the_same_pth_matches_jax(pths):
    _, trba_pth, config = pths
    jrec = JaxTRBA(model_path=str(trba_pth), config_path=str(config))
    rec = TRBA(trba_pth, config_path=config, device="cpu")
    assert (rec.max_length, rec.hidden_size, rec.cnn_stage_plan) == (6, 32, "tiny")
    rng = np.random.default_rng(5)
    crops = [rng.integers(0, 256, (int(rng.integers(10, 40)), int(rng.integers(20, 90)), 3),
                          dtype=np.uint8) for _ in range(4)]
    x = rng.uniform(-1, 1, (3, 32, 64, 3)).astype(np.float32)
    text_in = rng.integers(0, 194, (3, 7)).astype(np.int32)
    ref = jrec.model.apply(jrec.variables, jnp.asarray(x), jnp.asarray(text_in))
    with torch.no_grad():
        got = rec.model(torch.from_numpy(x), torch.from_numpy(text_in).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    gr, rr = rec.predict(crops, mode="greedy"), jrec.predict(crops, mode="greedy")
    assert [r["text"] for r in gr] == [r["text"] for r in rr]
    np.testing.assert_allclose([r["confidence"] for r in gr], [r["confidence"] for r in rr],
                               atol=1e-4, rtol=0)
