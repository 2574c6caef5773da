"""``manuscript_tpu_torch.train.east_train`` against the JAX trainer, on the
CPU, from the committed ``east_micro.msgpack`` read into both packages.

One step of the JAX trainer's jitted ``make_train_step``, in float32 and in
float64 (``jax.enable_x64``), and of the port's ``train_step`` on two
synthetic pages at 64² (16² label maps):

* ASAM + SGD with OHEM, focal geometry and ``freeze_first``;
* RAdam + Lookahead at a multiscale side of 96² (the predicted 24² maps are
  resized to the 16² labels inside the gradient, antialiased).

Both at a learning rate of S = 1e6 with the clip out of the way, so the
first update is −S·g, and the float64 JAX step's is −S times the exact
gradient. The loss (at the perturbed point under SAM) within 1e-5 relative
and the running statistics (moved once, by the unperturbed pass) within
1e-4 of both JAX steps'; each trainable leaf of the port's float32 update
within 1e-4 of the leaf's largest entry of the exact one (plus 1e-6 of the
largest entry of all, for the conv biases before a BatchNorm, whose exact
gradient is 0). The JAX float32 step is the farther one from the exact step
(its BatchNorm variance, E[x²] − E[x]², cancels in float32: on the ASAM step
some leaves are several % of their largest entry off; ``-s`` prints both).
The bound fails a wrong step: the plain gradient where ASAM's is due, and
maps resized without antialiasing. Frozen leaves stay put in the
port; the JAX stack adds their raw gradient, which optax's ``masked`` passes
through (pinned here as the JAX package's behaviour). Then the resize, the
GPU-resident dataset's gather, the freeze mask, and end-to-end runs: 2 epochs
and a resume on four 64² pages, with the device-resident and the streamed
data, and ``best.msgpack`` read by both packages' ``EAST``.
"""

from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manuscript_tpu.models.east import EASTModel as JaxEASTModel
from manuscript_tpu.train import east_train as JT
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu_torch.detectors import EAST
from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.ops.image import resize_u8
from manuscript_tpu_torch.train import east_train as PT
from manuscript_tpu_torch.train import optim as P
from manuscript_tpu_torch.train.east_dataset import EASTDataset, rasterize_quad_maps
from manuscript_tpu_torch.utils.synthetic import build_page_dataset, render_page
from manuscript_tpu_torch.utils.weights import params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CKPT = QUALITY_DIR / "east_micro.msgpack"
SCALE = 1e6
LOSS_KW = dict(use_ohem=True, ohem_ratio=0.5, use_focal_geo=True, focal_gamma=2.0)


@pytest.fixture(scope="module")
def data():
    raw = flax.serialization.msgpack_restore(CKPT.read_bytes())
    variables = {"params": raw["params"], "batch_stats": raw["batch_stats"]}
    rng = np.random.default_rng(0)
    pages, scores, geos = [], [], []
    for _ in range(2):
        page, words = render_page(rng, page_h=256, page_w=192, n_rows=3, n_cols=1)
        pages.append(resize_u8(page, 64, 64))
        quads = [w["quad"] * np.array([64 / 192, 64 / 256], np.float32) for w in words]
        s, g = rasterize_quad_maps(quads, 64)
        scores.append(s)
        geos.append(g)
    return variables, np.stack(pages), np.stack(scores), np.stack(geos)


def _jax_steps(variables, image, score, geo, tx_fn, use_sam, freeze_first):
    """The JAX trainer's jitted step from ``variables``, in float32 and in
    float64: {"float32": outputs, "float64": outputs}. The float64 step's
    update is −S times the exact gradient (its heads' maps and the loss stay
    float32, as the JAX model casts them)."""
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            model = JaxEASTModel(backbone="resnet50-micro", dtype=dtype)
            params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables[k])
                             for k in ("params", "batch_stats"))
            tx = tx_fn()
            if freeze_first:
                tx = optax.masked(tx, JT._freeze_mask(params, True))
            step = JT.make_train_step(model, tx, use_sam, True, **LOSS_KW)
            opt_state = tx.init(jax.tree_util.tree_map(jnp.copy, params))  # no buffer donated twice
            res = step(params, stats, opt_state, params, image, score, geo)
            out[np.dtype(dtype).name] = jax.tree_util.tree_map(np.asarray, res)
    return out


@pytest.fixture(scope="module")
def jax_sam(data):
    variables, image, score, geo = data
    return _jax_steps(variables, image, score, geo, lambda: optax.sgd(SCALE, momentum=0.9), True, True)


@pytest.fixture(scope="module")
def big_image(data):
    return np.stack([resize_u8(im, 96, 96) for im in data[1]])


def _jax_radam_lookahead():
    return JT.build_east_optimizer(SCALE, 4, use_sam=False, use_lookahead=True, grad_clip=1e12)[0]


@pytest.fixture(scope="module")
def jax_radam(data, big_image):
    variables, _, score, geo = data
    return _jax_steps(variables, big_image, score, geo, _jax_radam_lookahead, False, False)


def _port(variables):
    model = EASTModel("resnet50-micro")
    model.load_state_dict(params_from_jax(variables))
    return model


def _port_step(variables, image, score, geo, tx, use_sam, freeze_first):
    """The port's step → (loss, mask, parameters before, state after)."""
    model = _port(variables)
    mask = PT.freeze_mask(model, freeze_first)
    named = dict(model.named_parameters())
    trainable = {k: p for k, p in named.items() if mask[k]}
    before = {k: p.detach().clone() for k, p in named.items()}
    state = PT.EASTTrainState(model, tx.init(trainable), None)
    loss = PT.train_step(state, tx, trainable, *(torch.from_numpy(a) for a in (image, score, geo)),
                         use_sam=use_sam, sam_adaptive=True, **LOSS_KW)
    return loss.item(), mask, before, model.state_dict()


def _check_step(variables, image, score, geo, jax_out, tx, use_sam, freeze_first):
    """The port's step against the JAX trainer's: the loss within 1e-5
    relative of both JAX steps', the running statistics within 1e-4, and
    each trainable leaf's update within 1e-4 of the leaf's largest entry of
    the exact one (plus 1e-6 of the largest entry of all, for the conv
    biases before a BatchNorm, whose exact gradient is 0)."""
    loss, mask, before, state = _port_step(variables, image, score, geo, tx, use_sam, freeze_first)
    (j_params, j_stats, _, _, j_loss), (x_params, x_stats, _, _, x_loss) = (
        jax_out[dt] for dt in ("float32", "float64"))
    assert x_params["backbone"]["conv1"]["kernel"].dtype == np.float64
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(loss, float(x_loss), rtol=1e-5)
    want = params_from_jax({"params": j_params, "batch_stats": j_stats})
    exact = params_from_jax({"params": x_params, "batch_stats": x_stats})
    for name in want:
        if "running" in name:
            torch.testing.assert_close(state[name], want[name], rtol=1e-4, atol=1e-4, msg=name)
            torch.testing.assert_close(state[name], exact[name], rtol=1e-4, atol=1e-4, msg=name)
    grads = {k: (p0.double() - exact[k].double()) / SCALE for k, p0 in before.items() if mask[k]}
    floor = 1e-6 * max(g.abs().max().item() for g in grads.values())
    port_err = jax_err = 0.0
    for name, p0 in before.items():
        if not mask[name]:
            assert torch.equal(state[name], p0), name
            # the JAX stack adds the raw gradient to the frozen leaf, which
            # optax's masked passes through (the JAX package's behaviour)
            raw = (exact[name] - p0).double()
            assert raw.abs().max() > 0, name
            torch.testing.assert_close((want[name] - p0).double(), raw, rtol=0,
                                       atol=5e-2 * raw.abs().max().item(), msg=name)
            continue
        g = grads[name]
        bound = 1e-4 * g.abs().max().item() + floor
        err = ((p0 - state[name]).double() / SCALE - g).abs().max().item()
        assert err <= bound, (name, err / bound)
        port_err = max(port_err, err / bound)
        jax_err = max(jax_err, ((p0 - want[name]).double() / SCALE - g).abs().max().item() / bound)
    # the JAX float32 step, whose BatchNorm variance is E[x²] − E[x]², is the farther one
    print(f"largest leaf error over the bound: port {port_err:.4g}, JAX float32 {jax_err:.4g}")
    assert port_err < jax_err
    return mask, grads, floor


def test_asam_sgd_step_with_frozen_layers_matches_jax(data, jax_sam):
    variables, image, score, geo = data
    mask, grads, floor = _check_step(variables, image, score, geo, jax_sam, P.sgd(SCALE, 0.9), True, True)
    assert 0 < sum(not m for m in mask.values()) < len(mask)
    # the bound sees a wrong step: the plain gradient, SAM's perturbation left out
    _, _, before, plain = _port_step(variables, image, score, geo, P.sgd(SCALE, 0.9), False, True)
    for k, g in grads.items():
        if g.abs().max() > 1e3 * floor:  # all but the biases before a BatchNorm
            err = ((before[k] - plain[k]).double() / SCALE - g).abs().max().item()
            assert err > 1e-4 * g.abs().max().item() + floor, k


def test_radam_lookahead_multiscale_step_matches_jax(data, big_image, jax_radam, monkeypatch):
    variables, _, score, geo = data
    build = lambda: P.build_east_optimizer(SCALE, 4, use_sam=False, use_lookahead=True, grad_clip=1e12)[0]
    _, grads, floor = _check_step(variables, big_image, score, geo, jax_radam, build(), False, False)
    # the bound sees a wrong step: the predicted maps resized without antialiasing
    monkeypatch.setattr(PT, "resize_bilinear", lambda x, h, w: torch.nn.functional.interpolate(
        x, size=(h, w), mode="bilinear", align_corners=False))
    _, _, before, wrong = _port_step(variables, big_image, score, geo, build(), False, False)
    over = [((before[k] - wrong[k]).double() / SCALE - g).abs().max().item()
            > 1e-4 * g.abs().max().item() + floor for k, g in grads.items()]
    assert sum(over) > 0.5 * len(over)


@pytest.mark.parametrize("src,dst", [(24, 16), (16, 24), (30, 17)])
def test_map_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(src).normal(0, 1, (2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(x, (2, dst, dst, 3), "bilinear")
    got = PT.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst, dst).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_freeze_mask_matches_jax():
    shapes = jax.eval_shape(JaxEASTModel(backbone="resnet50-micro").init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    jmask = JT._freeze_mask(shapes["params"], True)
    want = {".".join(str(getattr(k, "key", k)) for k in path).replace(".kernel", ".weight")
            .replace(".scale", ".weight"): v
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    got = PT.freeze_mask(EASTModel("resnet50-micro"), True)
    assert got == want and not all(got.values())
    assert all(PT.freeze_mask(EASTModel("resnet50-micro"), False).values())


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    root = tmp_path_factory.mktemp("pages")
    coco, img_dir, _ = build_page_dataset(root, 4, seed=0, page_h=256, page_w=192, n_rows=3, n_cols=1)
    return img_dir, coco, root


def test_device_dataset_gathers_resizes_and_jitters(pages):
    img_dir, coco, _ = pages
    ds = EASTDataset(img_dir, coco, target_size=64, augment=True)
    dev = PT.DeviceDataset(ds, torch.device("cpu"), augment=False)
    assert ds.augment and len(dev) == 4  # the host augmentation is switched back on
    im, sc, geo = dev.batch(np.array([2, 0]))
    ds.augment = False
    for row, i in enumerate((2, 0)):
        np.testing.assert_array_equal(im[row].numpy(), ds[i][0])
        np.testing.assert_array_equal(sc[row].numpy(), ds[i][1])
    big, _, _ = dev.batch(np.array([2, 0]), side=96)
    want = PT.resize_bilinear(torch.from_numpy(np.stack([ds[2][0], ds[0][0]])).float().permute(0, 3, 1, 2),
                              96, 96).permute(0, 2, 3, 1).clamp(0, 255).to(torch.uint8)
    assert big.shape == (2, 96, 96, 3) and torch.equal(big, want)
    jit = PT.DeviceDataset(ds, torch.device("cpu"), augment=True, seed=1)
    a, b = jit.batch(np.array([1, 1]), step=3)[0], jit.batch(np.array([1, 1]), step=3)[0]
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])  # per-sample factors, seeded by step


def test_more_than_one_device_raises(pages, monkeypatch):
    """More cards than there are: the mesh raises (it never falls back to
    the CPU) before anything is written. The data-parallel trainer itself
    runs in tests/test_torch_mesh_train.py."""
    img_dir, coco, root = pages
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for kw in (dict(n_devices=2), dict(n_devices=3, device="cuda")):
        with pytest.raises(ValueError, match=f"requested {kw['n_devices']} devices but only 1"):
            EAST.train(img_dir, coco, img_dir, coco, experiment_root=str(root / "no"), **kw)
    assert not (root / "no").exists()


SMALL = dict(backbone="resnet50-micro", target_size=64, batch_size=2, lr=1e-3, log_tensorboard=False)


def test_two_epochs_resume_and_a_checkpoint_both_packages_read(pages, tmp_path):
    img_dir, coco, _ = pages
    out = EAST.train(img_dir, coco, img_dir, coco, experiment_root=str(tmp_path), epochs=2,
                     cache_device=True, use_ema=True, device="cpu", **SMALL)
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and 0 <= h["val_dice"] <= 1 for h in out["history"])
    ck = Path(out["exp_dir"]) / "checkpoints"
    assert {p.name for p in ck.iterdir()} == {"best.msgpack", "last.msgpack", "last_state.msgpack"}
    again = EAST.train(img_dir, coco, img_dir, coco, experiment_root=str(tmp_path), epochs=3,
                       resume_from=out["exp_dir"], use_sam=False, use_multiscale=False,
                       device="cpu", **SMALL)
    assert [h["epoch"] for h in again["history"]] == [2]
    state = flax.serialization.msgpack_restore((ck / "last_state.msgpack").read_bytes())
    assert state["meta"]["epoch"] == 3 and state["meta"]["global_step"] == 6

    port = EAST(ck / "best.msgpack", backbone="resnet50-micro", target_size=64, device="cpu",
                dtype=torch.float32)
    # the JAX package reads the file as its EAST wrapper does (flax from_bytes
    # into the model's variables); its forward is jitted here for time
    jm = JaxEASTModel(backbone="resnet50-micro")
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), dict(template))
    variables = flax.serialization.from_bytes(template, (ck / "best.msgpack").read_bytes())
    x = np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(variables, x)
    with torch.no_grad():
        got = port.model(torch.from_numpy(x))
    for key in ("score", "geometry"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-4)
    port.save(tmp_path / "saved.msgpack")  # EAST.save: the same variables back
    saved = flax.serialization.from_bytes(template, (tmp_path / "saved.msgpack").read_bytes())
    for a, b in zip(jax.tree_util.tree_leaves(saved), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_a_jax_layout_state_file_resumes_weights_and_counters(pages, tmp_path):
    img_dir, coco, _ = pages
    out = PT.train(img_dir, coco, img_dir, coco, experiment_root=str(tmp_path), epochs=1,
                   device="cpu", use_multiscale=False, **SMALL)
    path = Path(out["exp_dir"]) / "checkpoints" / "last_state.msgpack"
    state = flax.serialization.msgpack_restore(path.read_bytes())
    state["opt_state"] = [{"count": np.int32(4)}, {"trace": {}}]  # another layout
    path.write_bytes(flax.serialization.msgpack_serialize(state))
    model = EASTModel("resnet50-micro")
    tx, _ = P.build_east_optimizer(1e-3, 2)
    st = PT.EASTTrainState(model, tx.init(dict(model.named_parameters())), None).load(path)
    assert st.epoch == 1 and st.global_step == 2
    assert st.opt_state["1"]["0"]["trace"]["decoder.block1.bn1.weight"].abs().sum() == 0  # fresh
    torch.testing.assert_close(model.state_dict()["backbone.conv1.weight"],
                               out["model"].state_dict()["backbone.conv1.weight"])
    with pytest.raises(RuntimeError):
        PT.EASTTrainState(model, {}, None).load(b"\x80")  # no weights: not a state file
