"""The port's EAST network against the JAX package's ``EASTModel`` on the CPU:
score and geometry maps of ``resnet50-micro`` and ``resnet50-tiny`` at 64²
from the same numpy weights (handed to the port through
``params_from_jax``), rtol/atol 1e-4; and the 2× bilinear upsample against
``jax.image.resize``, edge rows included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from manuscript_tpu.models.east import EASTModel as JaxEAST
from manuscript_tpu_torch.models.east import EASTModel, upsample2x
from manuscript_tpu_torch.utils.weights import params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def numpy_variables(shapes, rng):
    """Fill a flax variable tree's shapes with seeded numpy values; BatchNorm
    statistics and scales are non-trivial so the conversion is exercised."""
    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.0, shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("backbone", ["resnet50-micro", "resnet50-tiny"])
def test_east_maps_match_jax(backbone):
    rng = np.random.default_rng(0)
    jmodel = JaxEAST(backbone=backbone)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = numpy_variables(jax.tree_util.tree_map(lambda s: s, shapes), rng)
    ref = jmodel.apply(variables, jnp.asarray(x))

    model = EASTModel(backbone).eval()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("score", "geometry"):
        assert got[key].dtype == torch.float32
        assert tuple(got[key].shape) == ref[key].shape  # NHWC at 1/4 resolution
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)


def test_upsample2x_matches_jax_image_resize_at_the_edges():
    x = np.random.default_rng(1).standard_normal((1, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 14, 3), method="bilinear"))
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:, :, [0, -1]], ref[:, :, [0, -1]], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_stem_and_maxpool_match_flax_layers():
    """7×7/2 pad-3 stem conv on an odd size (the JAX stem's direct form) and
    the −inf-padded 3×3/2 max pool."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 9, 11, 3)).astype(np.float32)
    k = (rng.standard_normal((7, 7, 3, 4)) / 12).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), stride=2, padding=3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)
    import flax.linen as nn

    pooled = nn.max_pool(
        jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf),
        (3, 3), strides=(2, 2), padding="VALID",
    )
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(pooled))
