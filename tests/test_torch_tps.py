"""The port's TPS rectification (``manuscript_tpu_torch/models/tps.py``) and
``TRBAModel(use_tps=True)`` against the JAX package on the CPU:

* the cases of ``tests/models/test_tps.py`` (identity grid, half-pixel
  shift, border clamp, the identity mapping, the fiducial layout, identity at
  init), held to the JAX functions: the numpy constants equal exactly;
* ``grid_sample_bilinear``: values within 1e-5 and gradients with respect to
  the image and the grid within 1e-4 on random grids that reach beyond the
  image (points within 1e-3 px of a clamp edge or of a pixel centre, where
  the gradient jumps, are moved off it; exactly on the clamp edge the JAX
  clip gives half the gradient, ``F.grid_sample`` all of it);
* ``TPSTransformer`` on smooth images, identity-initialised (output within
  1e-4 of JAX's) and with warping weights in eval and in train mode: output
  within 1e-4, parameter gradients within 5e-3 of each leaf's largest entry
  (the JAX grid carries float32 noise of ≈3e-5 of the half-width, where the
  port forms it from float64 products, and the gradients through the
  sampler carry the difference; train-mode BatchNorm takes
  its variance in two passes here, as E[x²] − E[x]² in flax), updated
  running statistics within 1e-5;
* a micro ``TRBAModel(use_tps=True)`` with a warping TPS: teacher-forced
  logits within 1e-4, greedy and beam tokens equal;
* an identity-initialised TPS in front of the micro quality checkpoint
  leaves its greedy and beam tokens unchanged, in both packages;
* the TPS leaves under flax's automatic names load from a JAX
  ``use_tps=True`` tree and save back to one of the same structure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.models import tps as JT
from manuscript_tpu.models.trba import TRBAModel as JaxTRBAModel
from manuscript_tpu.recognizers.trba import TRBA as JaxTRBA
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu.utils.synthetic import VOCAB, render_word
from manuscript_tpu_torch.models import tps as PT
from manuscript_tpu_torch.models.trba import TRBAModel
from manuscript_tpu_torch.ops.image import resize_and_pad
from manuscript_tpu_torch.utils.weights import params_from_jax, params_to_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _identity_grid(h, w):
    ys = (np.arange(h) + 0.5) / h * 2 - 1
    xs = (np.arange(w) + 0.5) / w * 2 - 1
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)[None].astype(np.float32)


def _sample(img, grid):
    return PT.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid)).numpy()


# ---- the cases of tests/models/test_tps.py ------------------------------------------


def test_constants_equal_the_jax_ones():
    for k in (4, 10, 20):
        c = PT.canonical_fiducials(k)
        np.testing.assert_array_equal(c, JT.canonical_fiducials(k))
        np.testing.assert_array_equal(PT.tps_system_inverse(c), JT.tps_system_inverse(c))
        np.testing.assert_array_equal(PT.build_grid_basis(c, 8, 16), JT.build_grid_basis(c, 8, 16))
    c = PT.canonical_fiducials(20)
    assert c.shape == (20, 2) and np.all(c[:10, 1] == -1) and np.all(c[10:, 1] == 1)


def test_identity_mapping():
    c = PT.canonical_fiducials(20)
    theta = PT.tps_system_inverse(c) @ np.concatenate([c, np.zeros((3, 2), np.float32)])
    grid = PT.build_grid_basis(c, 8, 16) @ theta
    np.testing.assert_allclose(grid, _identity_grid(8, 16)[0], atol=1e-4)


def test_identity_grid_half_pixel_shift_and_border_clamp(rng):
    img = rng.normal(size=(1, 8, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(_sample(img, _identity_grid(8, 12)).reshape(img.shape), img,
                               rtol=1e-5, atol=1e-5)
    ramp = np.arange(4, dtype=np.float32).reshape(1, 1, 4, 1)
    x = ((1.5 + 0.5) / 4) * 2 - 1  # halfway between pixels 1 and 2
    assert _sample(ramp, np.array([[[x, 0.0]]], np.float32))[0, 0, 0] == pytest.approx(1.5, abs=1e-5)
    sevens = np.full((1, 4, 4, 1), 7.0, np.float32)
    np.testing.assert_allclose(_sample(sevens, np.array([[[-5.0, -5.0], [5.0, 5.0]]], np.float32))[..., 0], 7.0)


def test_identity_at_init_matches_jax(rng):
    x = _smooth_images(rng, 2, 16, 32)
    jm = JT.TPSTransformer(num_fiducials=20)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = PT.TPSTransformer(20).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x, atol=5e-3)  # the identity warp, up to the f32 solve
    np.testing.assert_allclose(got, ref, atol=1e-4)


# ---- grid_sample_bilinear: value and gradient ---------------------------------------


def _off_kinks(grid, h, w):
    """Move points within 1e-3 px of a pixel centre or of the clamp edges."""
    out = grid.copy()
    for axis, size in ((0, w), (1, h)):
        px = (out[..., axis] + 1.0) * (size / 2.0) - 0.5
        near = np.abs(px - np.round(px)) < 1e-3
        px = np.where(near, px + 0.01, px)
        out[..., axis] = (px + 0.5) / (size / 2.0) - 1.0
    return out


@pytest.mark.parametrize("spread", [0.8, 1.6])
def test_grid_sample_value_and_gradients_match_jax(spread):
    rng = np.random.default_rng(int(spread * 10))
    img = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    grid = _off_kinks(rng.uniform(-spread, spread, (2, 50, 2)).astype(np.float32), 7, 9)
    wts = rng.normal(size=(2, 50, 3)).astype(np.float32)

    def jloss(i, g):
        return jnp.sum(JT.grid_sample_bilinear(i, g) * wts)

    ref = np.asarray(JT.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid)))
    gi_ref, gg_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    out = PT.grid_sample_bilinear(ti, tg)
    (out * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(gg_ref), atol=1e-4, rtol=0)
    outside = (np.abs(grid) > 1.0).any(-1)
    if spread > 1:  # clamped points: no gradient along the clamped axis
        assert outside.any()
        clamped_x = (grid[..., 0] < -1 + 1 / 9) | (grid[..., 0] > 1 - 1 / 9)
        assert np.all(tg.grad.numpy()[..., 0][clamped_x] == 0)


# ---- TPSTransformer with warping weights ---------------------------------------------


def _fill(shapes, rng, warp=0.05):
    """Seeded values for a flax tree; the last localization layer warps."""
    def leaf(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.0, s.shape).astype(np.float32)
        if names[-1] in ("mean", "bias") or names[-1].endswith("_bias"):
            v = (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            if "Dense_1" in names and names[-1] == "bias":
                k = s.shape[0] // 2
                v = JT.canonical_fiducials(k).ravel() + warp * v
            return v
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else s.shape[0]
        scale = warp if "Dense_1" in names else 1.0
        return (scale * rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _smooth_images(rng, b, h, w):
    """Low-frequency images: the float32 noise of the JAX package's TPS grid
    (≈3e-5 of the half-width; the port's grid comes from float64 products)
    then moves a sample by under 1e-4."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    out = np.empty((b, h, w, 3), np.float32)
    for i in range(b):
        for ch in range(3):
            fx, fy, ph = rng.uniform(0.5, 1.5), rng.uniform(0.5, 1.5), rng.uniform(0, np.pi)
            out[i, :, :, ch] = np.sin(fx * xx + fy * yy + ph)
    return out


def _port_grads(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("train", [False, True])
def test_tps_transformer_forward_and_gradients_match_jax(train):
    rng = np.random.default_rng(7)
    x = _smooth_images(rng, 3, 32, 64)
    wts = rng.normal(size=x.shape).astype(np.float32)
    jm = JT.TPSTransformer(num_fiducials=20)
    variables = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)

    def jloss(params):
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
        out, upd = out if train else (out, None)
        return jnp.sum(out * wts), (out, upd)

    (_, (ref, upd)), gref = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    model = PT.TPSTransformer(20)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    model.train(train)
    out = model(torch.from_numpy(x))
    (out * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, gref)})
    got = _port_grads(model)
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        scale = max(float(np.abs(g.numpy()).max()), 1e-12)
        assert np.abs(got[k] - g.numpy()).max() <= 5e-3 * scale, k
    assert np.abs(want["localization.Dense_1.weight"].numpy()).max() > 0
    if train:
        stats = params_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])})
        state = model.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


# ---- TRBAModel(use_tps=True) ---------------------------------------------------------


@pytest.fixture(scope="module")
def micro_tps():
    rng = np.random.default_rng(3)
    jm = JaxTRBAModel(num_classes=40, hidden_size=16, cnn_stage_plan="micro", use_tps=True)
    x = rng.uniform(-1, 1, (3, 32, 64, 3)).astype(np.float32)
    text_in = rng.integers(0, 40, (3, 6)).astype(np.int32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(text_in))
    variables = _fill(shapes, rng, warp=0.2)
    model = TRBAModel(40, 16, cnn_stage_plan="micro", use_tps=True).eval()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    return jm, variables, model, x, text_in


def test_micro_trba_with_tps_matches_jax(micro_tps):
    jm, variables, model, x, text_in = micro_tps
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(text_in))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(text_in).long())
        tps_out = model.tps(torch.from_numpy(x))
    assert np.abs(tps_out.numpy() - x).max() > 0.05  # the TPS warps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_micro_trba_with_tps_tokens_equal_jax(micro_tps, mode):
    jm, variables, model, x, _ = micro_tps
    with torch.no_grad():
        if mode == "greedy":
            _, preds = model.greedy(torch.from_numpy(x), max_len=5)
            _, ref = jm.apply(variables, jnp.asarray(x), max_len=5, method="greedy")
        else:
            _, preds = model.beam(torch.from_numpy(x), max_len=5, beam_size=3)
            _, ref = jm.apply(variables, jnp.asarray(x), max_len=5, beam_size=3, method="beam")
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref))


def test_tps_leaves_round_trip_through_flax_names(micro_tps):
    _, variables, model, _, _ = micro_tps
    names = sorted(k for k in model.state_dict() if k.startswith("tps."))
    assert "tps.localization.Conv_3.weight" in names and "tps.localization.Dense_1.bias" in names
    back = params_to_jax(model.state_dict())
    flat = lambda t: {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    ref = flat({"params": variables["params"], "batch_stats": variables["batch_stats"]})
    got = flat(back)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_cast_moves_the_tps_with_the_encoder(micro_tps):
    model = TRBAModel(40, 16, cnn_stage_plan="micro", use_tps=True).eval().cast(torch.bfloat16)
    assert model.tps.localization.Conv_0.weight.dtype == torch.bfloat16
    assert model.decoder.gen_kernel.dtype == torch.float32
    with torch.no_grad():
        out = model.tps(torch.from_numpy(micro_tps[3]).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


# ---- an identity TPS in front of the micro quality checkpoint ------------------------


@pytest.fixture(scope="module")
def quality_crops():
    jrec = JaxTRBA(model_path=str(QUALITY_DIR / "trba_micro.msgpack"))
    rng = np.random.default_rng(0)
    words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=5)]
    batch = np.stack([resize_and_pad(render_word(w, rng, height=32), jrec.img_h, jrec.img_w)
                      for w in words])
    return jrec, (batch.astype(np.float32) / 255.0 - 0.5) / 0.5


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_identity_tps_keeps_the_quality_checkpoints_tokens(quality_crops, mode):
    jrec, x = quality_crops
    kw = dict(num_classes=len(jrec.itos), hidden_size=jrec.hidden_size,
              sos_id=jrec.sos_id, eos_id=jrec.eos_id, blank_id=jrec.blank_id,
              cnn_stage_plan=jrec.cnn_stage_plan)
    jm = JaxTRBAModel(use_tps=True, **kw)
    tps_vars = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), jnp.zeros((1, 4), jnp.int32))
    both = {col: dict(jrec.variables[col], tps=tps_vars[col]["tps"]) for col in ("params", "batch_stats")}
    args = dict(max_len=jrec.max_length) if mode == "greedy" else dict(max_len=jrec.max_length, beam_size=4)
    _, ref = jrec.model.apply(jrec.variables, jnp.asarray(x), method=mode, **args)
    _, ref_tps = jm.apply(both, jnp.asarray(x), method=mode, **args)
    np.testing.assert_array_equal(np.asarray(ref_tps), np.asarray(ref))

    plain = TRBAModel(kw["num_classes"], kw["hidden_size"], kw["sos_id"], kw["eos_id"],
                      kw["blank_id"], kw["cnn_stage_plan"]).eval()
    plain.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jrec.variables)))
    tps = TRBAModel(kw["num_classes"], kw["hidden_size"], kw["sos_id"], kw["eos_id"],
                    kw["blank_id"], kw["cnn_stage_plan"], use_tps=True).eval()
    tps.load_state_dict(plain.state_dict(), strict=False)  # the TPS keeps its identity init
    fn = "greedy" if mode == "greedy" else "beam"
    with torch.no_grad():
        _, got = getattr(plain, fn)(torch.from_numpy(x), **args)
        _, got_tps = getattr(tps, fn)(torch.from_numpy(x), **args)
    np.testing.assert_array_equal(got_tps.numpy(), got.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
